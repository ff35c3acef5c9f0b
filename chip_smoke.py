#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA card and check them.

    python3 chip_smoke.py

Phases, each printing its seconds:

  1. build every CUDA kernel of the port from ``src/`` (one ``nvcc`` per
     source, all at once) and print the card's name and power limit;
  2. hold each kernel against its plain PyTorch version on the card,
     bit for bit: K1's four forms, packed pairs and packed groups on seeded
     operands and both verdicts on seeded indexed segments (ties exactly at
     each eps edge and one ulp either side; an empty segment, more segments
     than shared memory keeps, bases 4 bytes off 8, widths read at run
     time), K2 on
     seeded join rows (T = 3, 4,
     5, 4,097 and 524,293; W = 2 to 64; one contiguous table, bases off
     16 bytes, separate tensors, a wider parent table, rows of all
     sentinels), K3-single and K3-batch on seeded dense scans (ties at
     eps, +inf / NaN rows, sentinel and pad ids); ptxas's report of K1, K2
     and K3 (no spill);
  3. the main path at paper scale: ``GnnPeEngine.build`` then
     ``match_many`` on a 50K-vertex NWS graph in 80 partitions with 16
     queries of 8 vertices; every match set must equal VF2's, K1 must
     have run on that path, one launch on the partitions' own tables, and
     its verdict on the real probe's pairs must equal the plain version's;
     K1 is timed there as it ran (indexed), beside the route it replaced
     (gathers, cats, packed K1) and the packed form on the same pairs
     gathered, by CUDA events and by ``torch.profiler``.  Then the device
     join on the same engine (``join_impl="device"``, K2 must run, every
     launch on the contiguous layout; its match sets equal VF2's and the
     host join's, K2's verdict on every real step equals the plain
     version's, and K2 is timed at the median step) and the dense-scan entry
     ``ops.dominance_scan`` (K3) over every partition's real index, which
     must keep exactly the loop probe's rows; K3 is timed over all the
     indexed rows.  Then on the same engine the scalar match
     (``match(q, impl="scalar")``, equal to ``match_many``'s lists) and
     the stacked probe (``probe_impl="stacked"``): its lists equal the loop
     probe's with the host join, K1 must launch, its verdicts equal the
     plain version's and their T the loop probe's; with the device join it
     hands its device-resident candidates to the join (``probe_device``):
     no host expansion, K2 launching on the contiguous layout and equal to
     its plain version, the candidates equal to the loop probe's rows in
     slot order and the lists to the device join over them; warm runs
     interleaved with the loop probe (host join and device join) and one
     profiled warm call of each;
  3q. the same graph and queries with ``quantize_index=True,
     plan_weight="dr"``: partition 0's int8 sidecar and label hashes, made
     on the card, equal the CPU's; the cold batch (every candidate plan
     path probed for the dr weights) and the warm one (plans from the
     cache), both probes with both joins and the scalar match on two
     queries, every list equal to phase 3's match set, K1 launching on
     each and equal to its plain version; leaf pairs before the prefilter
     against K1's T after it;
  3g. the same graph and queries with ``index_kind="grouped",
     group_size=16`` (``benchmarks/bench_grouped.py --full``): K1 at the
     group level (its groups verdict) and the member level, one launch
     each, both equal to their plain versions on the real operands, the
     groups verdict timed there, indexed and packed, beside the route it
     replaced; group and leaf pairs against phase 3's; both probes with both
     joins, every list equal to phase 3's set; warm runs interleaved with
     the path kind; one profiled warm call of each probe; an auto-size
     engine (sizes equal to the CPU's
     ``choose_group_size``) and the grouped dr cost model, cold and warm;
  4. the GAT encoder, trained on the card, on a 2,000-vertex graph;
  5. the join-heavy batch: 8 relabeled-isomorphic 8-vertex queries on a
     12K-vertex, 3-label NWS graph (the configuration of
     ``benchmarks/bench_join.py --full``), device join against the host
     join and VF2; K2's verdicts on the real join steps equal the plain
     version's, every launch took the contiguous layout, and K2 is timed
     at the largest step with L2 flushed by a write, by a read and with
     the operands just rewritten, and under ``torch.profiler``; then the
     stacked probe's hand-off to the device join, whose lists equal VF2's,
     K2 equal to its plain version on its steps, timed beside the loop
     probe's device join;
  6. DCN-v2 serving at the published width (26 tables of 1M x 16, cross
     width 429, MLP 1024-1024-512), params from a seeded CUDA generator,
     through ``repro_torch.configs``: K4 (embedding bag) and K5 (cross
     layer) first on seeded edge shapes against their plain versions,
     then the cells ``serve_p99`` (B = 512), ``serve_bulk`` (B = 262,144)
     and ``retrieval_cand`` (1 query x 1M candidates, top-100), each
     driven once through ``build_step``: K4 must launch once and K5 three
     times per forward, K4 on the forward's real operands must equal its
     plain version bit for bit and each K5 call its plain version within
     rtol = atol = 1e-4 (ptxas's report of K5 first: no spill, no
     serialised wgmma; two controls on serve_bulk's first cross layer:
     W's last 5 rows zeroed must fail the check, one TF32 pass must fail
     it on seeded operands), and the logits (all of ``serve_p99``, the first 4,096 rows of
     ``serve_bulk``) and the top-100 must equal the port's CPU run of the
     same params and batch; warm step ms, rows/s and the step's device
     time split into K4, K5 and the rest per cell; K4 and K5 timed at
     ``serve_bulk`` beside their plain versions, library calls and bounds
     (K5's prep kernel also alone);
  7. gemma3-1b serving at the published width (26 layers, d_model 1152,
     4 query heads and 1 KV head of 256, vocab 262,144; bf16 over seeded
     params), through ``repro_torch.configs``: K6 (flash attention) first:
     ptxas's report of its three instantiations (no spill, no serialised
     wgmma), then seeded edge shapes against its plain version; ``prefill_32k``
     cut to B = 2 (S = 32,768): K6 must launch 26 times per forward and equal
     the plain ``chunked_attention`` on every layer's real q, k, v; warm
     step ms, tokens/s and the device time split into K6 and the rest;
     logits at B = 1, S = 640 equal to the port's CPU run; ``decode_32k``
     cut to B = 64 (warm steps at the cell's cur_len, one check step at
     S − 2 against the CPU on rows 0–1); ``long_500k`` uncut; the
     ``DecodeEngine`` on 12 requests through 8 slots; K6 timed at a global
     and a local layer beside its plain version and SDPA;
  8. live updates: 8a, the 50K cell (phase 3's graph, partitions, encoder
     and queries) with ``cache=True, delta_compact_min=192,
     delta_compact_frac=0.08`` under 8 seeded epochs (6 of
     ``benchmarks/bench_updates.py``'s edge churn, one appending 2 vertices,
     one removing a vertex): after each, both probes x both joins (cache set
     aside; K1 and K2 counted), every list in the JAX package's candidate
     order under pending deltas (host join: per partition its live main
     rows, then its buffer rows; hand-off: the main rows in slot order, then
     the buffer rows), the sets equal to VF2's at the first and last epoch,
     the delta buffers' scan one K1 launch a batch (``ops.LAUNCHES``) equal
     to its plain version on its real operands, its peak memory, the cache's hits, warm
     ``match_many`` beside epoch 0's; then the two most pressured partitions
     compacted through prepare / build / install (``update_slot`` must run,
     re-stacking only their slots) and every list equal to
     ``rebuild_indexes()``'s under ``sort_matches``; 8d (inside 8a, before
     the rebuild), the port's two repairs: queries with no path of l edges
     (single edges on 8a's engine with its deltas and tombstones pending;
     at l = 3 on the 50K graph also a 2-edge path and a star of up to 7
     edges) beside two of the cell's queries, through the scalar match,
     both probes x both joins and ``ClusterEngine``, every set equal to
     VF2's; and a port snapshot of 8a's engine, whose compactions moved its
     sizes off the stacked slots, restored on the card with its donor's
     slots, fingerprint and hand-off lists in order (without the port's
     meta key: stacked afresh, the same sets); 8b,
     ``bench_updates.py --full``'s cell (10K vertices, 40 partitions, grouped
     index): delta (a stacked probe kept) against ``strategy="rebuild"`` over
     6 batches with equal match sets, each strategy's stages timed, at least
     one compaction and one ``update_slot`` from the engine's own trigger,
     and the repeat-heavy stream with the cache off and on; 8c,
     phase 4's GAT engine after one update: its re-embedded rows against
     ``rebuild_indexes()``'s, bit for bit (printed), and its sets against
     VF2's;
  9. the serving tier over phase 3's engine and queries (and phase 3g's
     grouped engine): 9a, one traced warm ``match_many`` on the loop probe,
     the stacked probe, the hand-off to the device join and the grouped
     loop probe, each trace holding ``embed``, ``plan``, ``probe``,
     ``assemble`` and ``join`` once, its leaf and group pairs equal to the
     pair counters' deltas, its candidates and matches equal to the
     engine's counts and phase 3's, its stages summing to 0.5–1.01 of the
     root span; K2 on the hand-off's real steps equal to its plain version;
     the registry's Prometheus text through ``parse_prometheus`` and its
     JSON snapshot (``experiments/phase9_metrics.json``) against
     ``snapshot()``; warm ``match_many`` with obs on and off, interleaved,
     5 each (printed only); 9b, ``MatchServer`` (``max_batch`` 8,
     cost-ranked ticks) on 64 requests (phase 3's 16 queries x 4, shuffled
     by ``default_rng(0)``) in 4 rounds, each after an update tick of 2
     coalesced edge-churn batches: every answer equal to ``match_many`` at
     its epoch, the last epoch's sets equal to VF2's, K1 launching and one
     tick's verdicts equal to the plain version; qps and p50 / p95 per
     request on the host clock; 9c, 4 subscriptions through the server over
     6 epochs (5 of edge churn, the sixth one edge removed where no
     candidate partition of one subscription reaches): after each epoch the
     accumulated sets equal a from-scratch ``match_many``, the fresh-row
     probe's K1 equal to its plain version, and the untouched subscription
     skipped with no K1 launch; 9d, ``MatchService`` over a
     ``FlakyEngine`` (two tenants, 32 requests and a poisoned one, seeded
     transient faults, one hang past the attempt time-out, stacked probe):
     every ok answer byte-identical to the fault-free one, the statuses
     summing to the requests submitted, the poisoned request alone
     quarantined;
  10. the cluster tier (``repro_torch.dist.cluster``) on one card: 10a, the
     50K cell through ``ClusterEngine`` at 1, 2 and 4 local hosts, for
     phase 3's engine (loop probe, host join, phase 9's deltas pending) and
     two new stacked-probe engines (host join, device join): every list
     equal (order included) to the engine's own ``match_many``, the last
     sets to VF2's, K1 launching on every cluster batch (K2 on the device
     join's), a rebalance after a warm batch within its Graham bound with
     every host owning partitions, K1 on each host's subset probe and equal
     to its plain version on one host's real pairs, a host lost mid-gather
     re-probed with equal lists; warm ms single-process and at 1 / 2 / 4
     hosts, 3 each interleaved, and one profiled 4-host call's launches and
     device-to-host copies; 10b, ``benchmarks/bench_cluster.py --full``'s
     cell (10K vertices, 40 partitions, stacked probe, 10 queries): a
     4-host cluster with the sharded cache (capacity 256) through 8
     partition-local deletion epochs of 2 edges, each epoch's sets equal to
     ``match_many``'s, evictions on the owner shards only
     (``remote_evictions == 0 < local_evictions``), the hit rate printed;
     10c, blue-green on that engine: ``rebuild_generation`` through a
     ``CheckpointManager``, ``load_generation``'s indexes equal to the
     installed ones field by field, the buffers drained, the sets
     unchanged and the lists equal to ``match_many``'s, an install after a
     newer epoch refused, a bit-flipped step raising
     ``CorruptCheckpointError``; 10d, ``ClusterRouter`` on 32 requests in 4
     ticks, two after an update, every answer equal to a cache-less
     ``ClusterEngine.match_many`` at its epoch; 10e, a worker process
     (``chip_smoke.py --cluster-worker``) serving host 1 from a replica of
     the 10b cell over ``DirExchange`` and a gloo group of 2
     (``init_distributed``, its mode printed) while this process
     coordinates ``LocalHost(0)``: lists equal to single-process
     ``match_many``, the worker's candidates equal to this process's
     ``probe_candidates`` for the same parts;
  11. durability (``repro_torch.durability``) on the card: 11a, phase 3's
     engine and queries (loop probe, host join, the deltas of phases 9 and
     10 pending) behind a ``MatchServer`` with ``DurabilityConfig(tmp,
     snapshot_every=4)``: the genesis snapshot (bytes and seconds), 10
     epochs of ``bench_updates.py``'s churn (4 + 4 edges) with a crash after
     the 7th epoch's log, ``recover_server`` on the card against a control
     restored from the genesis snapshot and given the same epochs:
     fingerprints and lists (order included) equal at epochs 7 and 10, the
     last epoch's sets equal to VF2's, K1 launching on the recovered batch
     with deltas pending (the probe's verdict and the delta scan's), each
     equal to the plain version; the recovery seconds beside the build's
     plus a replay of the whole stream, the WAL appends' p50 / p95 (fsync)
     and the WAL's share of bare ``apply_updates`` (printed only); 11b,
     ``bench_durability.py --full``'s cell (NWS n = 4,000, seed 11, 4
     partitions): the 5 kill points x {path-loop, grouped-stacked}
     recovered fingerprint- and list-equal to a control, a torn WAL tail and
     a bit-flipped newest snapshot recovered, ``recover_server`` with 2
     subscriptions re-registering each once with the from-scratch set; 11c,
     ``examples/serve_queries_torch.py --wal`` on that cell in two child
     processes, one run through, one SIGKILLed after its 4th epoch, whose
     directory this process recovers on the card and finishes through the
     example's own loop: its final fingerprint and match digest equal the
     uninterrupted run's; 11d, ``scrub(sample=8)`` of 11a's recovered engine
     ok, a narrowed MBR planted on a clone found, and the scrub CLI
     (``python -m repro_torch.durability.scrub``, started after 11a in a
     child process) exiting 0 on 11a's directory;
  12. training on the card: 12a, DCN-v2 ``train_batch`` at the published
     width, B = 65,536, nothing cut (``build_step``'s train step over
     ``RecsysSyntheticData``): K4 must launch once and K5 three times a step
     (counted on the first), the gradients through their ``autograd.Function``s
     equal to autograd through the plain forward on the card (each leaf's
     difference within relative L2 5e-3 and, the tables excepted, each
     element within 1e-3 of the leaf's largest |g|; none missing), a K5
     wrapper with a detached output failing that check, the loss within 1e-4
     and the gradients within the same limits of the port's CPU run of the
     same params and batch, and the card's AdamW on its gradients equal to
     the CPU's (relative L2 1e-6, each element 1e-5); warm step ms,
     rows/s, peak memory, the step split into forward, backward and optimizer
     (K4 and K5 forward, K4's ``index_add_`` and K5's matmul backwards inside
     them) by CUDA events and the top kernels under ``torch.profiler``; 12b,
     gemma3-1b ``train_4k`` at the published width and depth (26 layers,
     float32 master params, remat), the batch cut to 4 sequences of 4,096 in
     ``grad_accum`` 4: K6 must launch 52 times a microbatch (26 forward, 26 in
     remat's recompute), the loss at B = 1, S = 640 within phase 7's tolerance
     of the CPU's, K6's Function gradients of q, k and v on a local and a
     global layer's real operands within relative L2 1e-3 of autograd through
     the plain attention, the loss falling over 4 steps on the fixed batch;
     step ms, tokens/s, peak memory, the step split into K6 forward, attention
     backward, CE forward and the optimizer by CUDA events, the top kernels;
     12c, the ``Trainer`` at the smoke width (bf16): a resume bit-equal to an
     uninterrupted run (deterministic algorithms on), a SIGTERM to a training
     child (``chip_smoke.py --train-worker DIR``) leaving its checkpoint, the
     watchdog on an injected delay, int8 and top-k compression steps, and
     ``python -m repro_torch.launch.train`` (dcn-v2, gemma3-1b and
     deepseek-v2-lite-16b, smoke: its 24-wide q and k padded to 32 by K6's
     wrapper) and
     ``examples/train_lm_torch.py`` run through in child processes.

  13. the rest of the LM family at full width through ``repro_torch.configs``
     (bf16 over seeded params; each tensor cast as drawn): minitron-4b (all 32
     layers), command-r-plus-104b (cut 64 -> 8 layers), deepseek-v2-lite-16b
     (all 27: MLA, one dense layer, 26 MoE) and qwen3-moe-235b-a22b (cut 94 ->
     8), each cut printed with its reason: ``prefill_32k`` at B = 1, K6 once a
     layer (MLA's v padded to 192 by the wrapper), the first and last layers
     (and deepseek's first MoE layer) held against the plain
     ``chunked_attention`` at their first and last 1,024 query rows over
     every key; for the MoE archs every layer's top-k sets against the CPU's
     float32 router on the card's own layer inputs (at most 1 % apart) and
     the capacity's drops; warm ms, tokens/s and the step's split; K6 timed
     on the last layer beside SDPA and its plain version; the logits of the
     first 2 layers on a 64-token prompt against the port's CPU run (for a
     MoE arch also layer by layer on the card's inputs); ``decode_32k``
     (minitron B = 8, the others B = 16) warm at cur_len 5, the profiler's
     kernels, a check step at S − 2 on the first 2 layers against the CPU;
     deepseek's ``long_500k`` (B = 1, 16.3 GB of latent cache), the others'
     skipped with the reference's reason; deepseek's ``DecodeEngine`` over the
     MLA cache (6 requests through 4 slots), and on 2 layers every tick's
     logits against the CPU's ``decode_step`` on the card's own tokens (rows
     whose top-k sets the two sides route apart reported, not held);
     ``python -m repro_torch.launch.serve`` in child processes (``--mode lm``
     over deepseek, ``--mode gnnpe``).  K6's edge checks (phase 7) also cover G = 3, 12, 16 at dh = 128 and dqk
     192 with dv 128, with a planted fault each.

 14. the GNN zoo and GNN-PE's own cells through ``repro_torch.configs`` (no
     kernel lies on this path): 14a gin-tu, graphsage-reddit, schnet and mace
     at their published widths on ``full_graph_sm``, ``molecule`` and
     ``minibatch_lg`` at full size, one ``build_step`` train step each from
     seeded params against the port's CPU run of the same params and batch
     (loss within 1e-4, each gradient leaf within phase 12a's relative L2
     of 5e-3), warm step ms
     and peak memory; 14b ``ogb_products`` at full size (2,449,056 nodes,
     123,718,304 directed edges) for each arch: the first layer against its
     float64 recomputation on the card, ``segment_sum``'s gradient against
     autograd of the plain sum on the first 4 M edges, a train step, its ms
     and peak; 14c the partition-parallel train step in 2 processes sharing
     the card over gloo (a 20,000-vertex ER graph in 2 shards) against the
     dense path; 14d ``gnn-pe-offline`` at m = 64 × 8,192 pairs against the
     CPU, and ``gnn-pe-online`` over 10⁸ paths in its four variants with 3
     rows planted a query (every rise accounted for) and the first 2²⁰ rows'
     counts equal to the CPU's; 14e ``python -m repro_torch.launch.train
     --smoke --steps 20`` for the four archs and gnn-pe-offline side by side.
 15. the meshes: 15a expert parallelism in 4 processes sharing the card over
     gloo as a (data 2 × model 2) mesh, deepseek-v2-lite-16b's first 2 layers
     at the published width (its first MoE layer on 4,096 tokens a data shard,
     ``fsdp`` off and on, against the local ``moe_block``, the kept and
     dropped sets identical; ``lm_forward(mesh=)`` against the local forward,
     K6 on every rank); 15b GPipe in 2 processes, gemma3-1b's 26 layers as 2
     stages over 4 microbatches of 4,096 tokens, bit-equal to the layers in
     sequence, K6 on both ranks (workers ``--mesh-worker moe|pipe RANK PORT
     DIR DEVICE full|smoke``); on phase 3's engine of the 50K cell, handed
     over after phase 3g (before phase 9 updates it), 15c the stacked probe
     over the card listed 2 and 3 times (every card where there are
     several): its lists equal one device's in order, K1 equal to plain, the
     hand-off's sets; 15d the device join over join lists of 2 and 3 on the
     16 queries and 3 isomorphic ones: lists equal one device's, K2 a shard
     a step, each equal to plain.  The mesh times beside their one-device
     counterparts show the split's cost on one card, not a speed-up.

 16. the tools that describe a mesh: 16a the dry-run of gemma3-1b
     ``train_4k`` on the (16, 16) mesh, qwen3-moe-235b-a22b ``train_4k`` on
     the (2, 16, 16) mesh, dcn-v2 ``serve_bulk``, gin-tu ``full_graph_sm``
     and graphsage-reddit ``minibatch_lg`` on the (16, 16) mesh,
     command-r-plus-104b ``train_4k`` on the (2, 16, 16) mesh at 2 of its
     64 layers (``DRYRUN_CUT``, for time; 8 rows a rank, fewer than its 16
     microbatches), and mace ``ogb_products`` on both meshes
     (``repro_torch.launch.dryrun``: one step on DTensors over a fake
     process group, counted per rank), in a CPU-only child started at the
     top of the script on one host thread pinned to one core at a lower
     priority, collected here: each ``ok``, its per-device flops, bytes,
     collective bytes and peak beside 80 GB, a peak within 80 GB wherever
     the JAX package's plan of the cell fits (``REF_MEMORY_GB``) and for
     the cut cell, and mace's collective bytes on (2, 16, 16) within its
     own on (16, 16) × max(1.05, the JAX package's ratio) + 64 MB
     (``DRYRUN_SCALING``: adding a pod adds no traffic to a device); 16b
     gemma3-1b ``prefill_32k`` at B = 2, one warm step on the card counted by
     ``launch/op_cost.py`` (K6 26 times), its flops and bytes equal to the
     child's dry-run of the same cell on a (1, 1) mesh, and an uncounted step
     timed by CUDA events against the roofline of those counts (over 100 %
     fails); 16c ``examples/quickstart_torch.py`` (every query's set VF2's)
     and ``examples/chaos_crash_torch.py --kill-epoch 3`` (the final line
     after the SIGKILL and restart equal to the control's) in children beside
     16b.

``python3 chip_smoke.py --only 12`` (or ``--only 8``, ``--only 13``, ``--only
14``, ``--only 15``, ``--only 16``) builds the kernels and runs phase 12 (or
8a with 8d, K6's edge checks and phase 13, phase 14, phase 15, or phase 16)
alone, printing no result line.  ``python3 chip_smoke.py --host-ab DIR
[ROUNDS]`` reads the serving paths' host time against the port of another
checkout unpacked in ``DIR`` (``host_ab``); it is not part of the full run.

Prints one JSON line of kernel records, the ``nvidia-smi`` name and power
limit line, and last ``{"ok": true, "device": {...}}``.  Exits non-zero
without a card, outside the repository, or if any check fails.
"""
from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
BF16_OPS_PER_S = 989e12  # H100 SXM bf16 tensor cores, dense
TF32_OPS_PER_S = 495e12  # H100 SXM tf32 tensor cores, dense
SRC = "src/repro_torch/kernels"
SPIN_CYCLES = 2_000_000  # about 1 ms of the card's clock
T0 = time.perf_counter()  # the script's start (main sets it again)


def log(msg: str) -> None:
    print(msg, flush=True)


def sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def time_ms(fn, args, reps: int, flush, clean: bool = False, before=None,
            spin: int = SPIN_CYCLES, warmup: int = 3) -> float:
    """Mean device ms of ``fn(*args)``, with L2 flushed before each call
    (the main path gathers fresh operands that mostly miss L2) and the
    card held busy by a spin while the host enqueues the call, so the
    host's launch latency stays out of the events.  The flush writes
    ``flush``, which leaves up to 50 MB of dirty lines in L2 for the call
    to write back as its reads evict them; ``clean`` flushes by reading
    ``flush`` instead, so that L2 holds clean lines.  ``before``, where
    given, runs after the flush (``k2_readings`` rewrites the operands
    there).  ``spin``: the spin's cycles, more than the call's host work
    takes to enqueue; ``warmup`` untimed calls first."""
    import torch

    for _ in range(warmup):
        fn(*args)
    total = 0.0
    for _ in range(reps):
        if clean:
            flush.sum()
        else:
            flush.zero_()
        if before is not None:
            before()
        torch.cuda._sleep(spin)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def bound_ms(n_bytes: float, n_ops: float,
             ops_per_s: float = FP32_OPS_PER_S) -> tuple[float, str]:
    """Least time for the work: bytes over the memory rate vs operations
    over the float32 rate, or ``ops_per_s`` (the larger of the two, and
    which it is)."""
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / ops_per_s * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def k1_bound_ms(T: int, D: int, D0: int) -> tuple[float, str]:
    """T pairs: inputs once, 1-byte output; add+cmp per D, sub+abs+cmp per D0."""
    return bound_ms(T * 4 * (2 * D + 2 * D0) + T, T * (2 * D + 3 * D0))


def verdict_pairs(args) -> int:
    """The pairs of one recorded K1 verdict call, ``(segments, eps)``."""
    return sum(s.rows.numel() for s in args[0])


def k1_indexed_bound_ms(segs, groups: bool = False, eps: float = 1e-6) -> tuple[float, str]:
    """An indexed K1 call: its int64 indices (16 bytes a pair) and a byte a
    pair; each distinct row read once, the labels of every data and query
    row its pairs name and the dominance columns only of the rows whose
    pairs pass the labels (a labels-first kernel needs no others: the bytes
    this run's data needs); against the label compares of every pair and
    the dominance compares of those passing."""
    import torch

    T = sum(s.rows.numel() for s in segs)
    n_bytes, n_ops = 17 * T, 0
    for s in segs:
        if not s.rows.numel():
            continue
        D, D0 = sum(t.shape[1] for t in s.query[:-1]), s.query[-1].shape[1]
        e = torch.tensor(eps, dtype=torch.float32, device=s.rows.device)
        q0, e0 = s.query[-1][s.q_ids], s.data[-1][s.rows]
        if groups:
            ok = ((q0 <= e0[:, :, 1] + e) & (q0 >= e0[:, :, 0] - e)).all(dim=1)
        else:
            ok = ((e0 - q0).abs() <= e).all(dim=1)
        rows, q_ids = torch.unique(s.rows), torch.unique(s.q_ids)
        n_bytes += rows.numel() * 4 * D0 * (2 if groups else 1) + q_ids.numel() * 4 * D0
        n_bytes += (torch.unique(s.rows[ok]).numel() + torch.unique(s.q_ids[ok]).numel()) * 4 * D
        n_ops += s.rows.numel() * (4 if groups else 3) * D0 + int(ok.sum()) * 2 * D
    return bound_ms(n_bytes, n_ops)


def segments_on(segs, dev, floats: int = 0) -> list:
    """``segs`` on ``dev``, each table starting ``floats`` floats into its own
    allocation (0: a plain copy)."""
    import torch

    from repro_torch.kernels.dominance_scan.ref import Segment

    def place(t):
        if not floats:
            return t.to(dev)
        buf = torch.empty(t.numel() + floats, dtype=t.dtype, device=dev)
        buf[floats:] = t.reshape(-1).to(dev)
        return buf[floats:].view(t.shape)

    return [Segment(s.rows.to(dev), s.q_ids.to(dev), tuple(map(place, s.data)),
                    tuple(map(place, s.query))) for s in segs]


def replaced_route(segs, eps: float, groups: bool = False):
    """The route the indexed K1 replaced, on the same segments: each
    segment's table gathers and their concatenation, the segments
    concatenated, then the packed K1 (for the groups verdict PR 20's
    wrapper: (qg, q0g, -q0g) against (hi, hi0, -lo0) with a zero label
    column)."""
    import torch

    from repro_torch.kernels.dominance_scan import ops as ds
    from repro_torch.kernels.dominance_scan.ref import gather_group_operands, gather_pair_operands

    parts = [(gather_group_operands if groups else gather_pair_operands)(s) for s in segs]
    cat = [torch.cat([p[k] for p in parts]) for k in range(len(parts[0]))]
    if not groups:
        return ds.dominance_scan_pairs(*cat, eps)
    qg, q0g, hi, lo0, hi0 = cat
    zeros = qg.new_zeros((qg.shape[0], 1))
    return ds.dominance_scan_pairs(torch.cat([qg, q0g, -q0g], dim=1), zeros,
                                   torch.cat([hi, hi0, -lo0], dim=1), zeros, eps)


def fmt_ms(x: float) -> str:
    return "not measured" if x != x else f"{x:.6f} ms"


LONG_SPIN = 40 * SPIN_CYCLES  # about 40 ms: longer than a K1 route's host enqueue


def host_ms(fn, args, reps: int = 10) -> float:
    """Mean host ms to enqueue ``fn(*args)`` (the host clock around the call,
    the card synchronized between calls): a wrapper's Python and launch
    cost, which the device times leave out."""
    import torch

    total = 0.0
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn(*args)
        total += time.perf_counter() - t
    torch.cuda.synchronize()
    return total / reps * 1e3


def k2_bound_ms(T: int, Co: int, Cn: int) -> tuple[float, str]:
    """T join rows: ids once, 1-byte output; one compare per (new, old) and
    (new, new) pair, counted at the float32 rate (the guide's table has no
    int32 row; the bytes bound is the larger at either rate)."""
    return bound_ms(T * 4 * (Co + Cn) + T, T * (Co * Cn + Cn * (Cn - 1) // 2))


def k3_bound_ms(Q: int, N: int, D: int, D0: int) -> tuple[float, str]:
    """Q query rows × N data rows: every row once, a (Q, N) byte output;
    the e + eps add once per data element (N·D), then a compare per D and
    sub+abs+cmp per D0 for every cell.  ``FP32_OPS_PER_S`` counts an FMA
    as two operations while a compare is one instruction, so where the
    compares bound a call the floor is up to 2x higher than this, which is
    why the kernel decides the labels first."""
    return bound_ms((Q + N) * 4 * (D + D0) + Q * N, N * D + Q * N * (D + 3 * D0))


def k4_bound_ms(N: int, K: int, E: int, n_set: int, n_nonempty: int) -> tuple[float, str]:
    """N bags of K slots: ids and mask bytes once, one E-float table row for
    each set slot (what this run's data reads), the (N, E) output once;
    one add per float past each bag's first set slot."""
    return bound_ms(N * K * 5 + n_set * E * 4 + N * E * 4, (n_set - n_nonempty) * E)


def k5_bound_ms(B: int, D: int) -> tuple[float, str]:
    """x0, x and the output (B, D), w (D, D) and b once, against a multiply-add
    (2 operations) per (row, k, column) at the float32-accurate tensor-core
    rate: K5 takes three tf32 products (3xTF32) for each, so 495 / 3 TFLOP/s
    (the epilogue's 3 operations an output run beside them on the other cores)."""
    return bound_ms(4 * (3 * B * D + D * D + D), 2 * B * D * D, TF32_OPS_PER_S / 3)


def k5_simt_bound_ms(B: int, D: int) -> tuple[float, str]:
    """The same bytes against the GEMM and the epilogue at the float32 rate
    outside the tensor cores: the bound of a SIMT design, as K5 was first built."""
    return bound_ms(4 * (3 * B * D + D * D + D), 2 * B * D * D + 3 * B * D)


def k6_flops(B: int, S: int, Hq: int, dh: int, window, dv: int | None = None) -> int:
    """2·(dh + dv) operations (a multiply-add for each of q·k's dh and p·v's dv
    terms) for each unmasked (query, key) pair of causal attention over B
    sequences and Hq heads; dv = dh unless given (MLA's 128 against 192)."""
    w = S if window is None else min(window, S)
    pairs = w * (w + 1) // 2 + (S - w) * w  # row i keeps min(i + 1, w) keys
    return 2 * (dh + (dh if dv is None else dv)) * pairs * B * Hq


def k6_bound_ms(B: int, S: int, Hq: int, Hkv: int, dh: int, window,
                dv: int | None = None) -> tuple[float, str]:
    """Causal attention of B sequences: q (Hq heads) and k (Hkv heads) dh wide,
    v (Hkv) and the output (Hq) dv wide, each once in bf16, against
    ``k6_flops`` at the bf16 tensor-core rate: the function's own work, not
    the padded product the wrapper hands the kernel."""
    dv = dh if dv is None else dv
    bytes_ms = 2 * B * S * (Hq + Hkv) * (dh + dv) / HBM_BYTES_PER_S * 1e3
    ops_ms = k6_flops(B, S, Hq, dh, window, dv) / BF16_OPS_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def counters():
    """The launch counts of every kernel, by name."""
    from repro_torch.kernels.cross_interact import ops as ci
    from repro_torch.kernels.dominance_scan import ops as ds
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.merge_join import ops as mj
    from repro_torch.kernels.star_agg import ops as sa

    return {
        "K1": ds.LAUNCHES, "K2": mj.LAUNCHES,
        "K3-single": ds.SINGLE_LAUNCHES, "K3-batch": ds.BATCH_LAUNCHES,
        "K4": sa.LAUNCHES, "K5": ci.LAUNCHES, "K6": fa.LAUNCHES,
    }


def pair_counts() -> dict:
    from repro_torch.core import index as index_mod

    return {k: index_mod.PAIR_METRIC.get(kind=k) for k in ("leaf_pairs", "group_pairs")}


def reset_counters() -> None:
    from repro_torch.kernels.cross_interact import ops as ci
    from repro_torch.kernels.dominance_scan import ops as ds
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.merge_join import ops as mj
    from repro_torch.kernels.star_agg import ops as sa

    ds.LAUNCHES = ds.SINGLE_LAUNCHES = ds.BATCH_LAUNCHES = 0
    mj.LAUNCHES = mj.CONTIGUOUS_LAUNCHES = sa.LAUNCHES = ci.LAUNCHES = fa.LAUNCHES = 0


def iso_batch(g, size: int, n: int, seed: int = 0):
    """One random query + (n−1) vertex-relabeled isomorphic copies (as
    ``benchmarks/bench_join.py`` builds its batch)."""
    from repro_torch.graphs import from_edge_list, random_connected_query

    base = random_connected_query(g, size, seed=seed)
    rng = np.random.default_rng(seed + 1)
    out = [base]
    for _ in range(n - 1):
        perm = rng.permutation(base.n_vertices)
        e = base.edge_array()
        labs = np.empty(base.n_vertices, np.int64)
        labs[perm] = base.labels
        out.append(
            from_edge_list(base.n_vertices, np.stack([perm[e[:, 0]], perm[e[:, 1]]], 1), labs)
        )
    return out


def cell_50k_inputs(n: int = 50_000, n_parts: int = 80, n_queries: int = 16):
    """The 50K cell (``benchmarks/bench_online_batch.py --full``) → (graph,
    queries, engine config)."""
    from repro_torch.core import GnnPeConfig, TrainConfig
    from repro_torch.graphs import newman_watts_strogatz, random_connected_query

    g = newman_watts_strogatz(n, k=4, p=0.1, n_labels=100, seed=11)
    queries = [random_connected_query(g, 8, seed=42 + s) for s in range(n_queries)]
    cfg = GnnPeConfig(n_partitions=n_parts, encoder="monotone", train=TrainConfig(max_epochs=150))
    return g, queries, cfg


def join_heavy_inputs(n: int = 12_000, n_parts: int = 12):
    """The join-heavy batch (``benchmarks/bench_join.py --full``) → (graph,
    queries, engine config)."""
    from repro_torch.core import GnnPeConfig
    from repro_torch.graphs import newman_watts_strogatz

    g = newman_watts_strogatz(n, k=6, p=0.1, n_labels=3, seed=7)
    return g, iso_batch(g, 8, 8, seed=0), GnnPeConfig(n_partitions=n_parts, encoder="monotone")


def check_against_vf2(g, queries, got_lists, what: str) -> int:
    from repro_torch.core import vf2_match

    n = 0
    for qi, (q, got) in enumerate(zip(queries, got_lists)):
        want = vf2_match(g, q)
        require(
            set(got) == set(want) and len(got) == len(want),
            f"{what} query {qi}: {len(got)} matches, VF2 finds {len(want)}",
        )
        n += len(got)
    return n


def warm_ms(fn, dev, runs: int = 3) -> list:
    out = []
    for _ in range(runs):
        t = time.perf_counter()
        fn()
        sync(dev)
        out.append((time.perf_counter() - t) * 1e3)
    return out


def fmt(ms: list, digits: int = 3) -> str:
    return ", ".join(f"{m:.{digits}f}" for m in ms)


def device_join_breakdown(eng, queries, dev, what: str, **kw) -> None:
    """Where a warm device-join ``match_many`` spends its time: the join
    steps and the refine on the host clock (both end in a read-back), the
    number of fused join steps, and device-busy time under the profiler."""
    import torch

    from repro_torch.core import matcher as mt

    spent = {"join": 0.0, "refine": 0.0, "steps": 0}
    join_fn, refine_fn, step_fn = (
        mt._join_candidates_device_batch, mt._refine_device_batch, mt._joinstep_body
    )

    def timed(key, fn):
        def run(*a, **k):
            t = time.perf_counter()
            res = fn(*a, **k)
            spent[key] += time.perf_counter() - t
            return res
        return run

    def step(*a, **k):
        spent["steps"] += 1
        return step_fn(*a, **k)

    mt._join_candidates_device_batch = timed("join", join_fn)
    mt._refine_device_batch = timed("refine", refine_fn)
    mt._joinstep_body = step
    try:
        with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        ) as prof:
            t_p = time.perf_counter()
            _, st = eng.match_many(queries, join_impl="device", return_stats=True, **kw)
            sync(dev)
            wall = (time.perf_counter() - t_p) * 1e3
    finally:
        mt._join_candidates_device_batch, mt._refine_device_batch = join_fn, refine_fn
        mt._joinstep_body = step_fn
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    dtoh = sum(e.count for e in kernels if "DtoH" in e.key)
    join_s = sum(s.join_time for s in st)
    log(f"{what}, profiled warm device-join match_many: {wall:.3f} ms wall; filter "
        f"{sum(s.filter_time for s in st) * 1e3:.3f} ms, join + refine {join_s * 1e3:.3f} ms, "
        f"of which join steps {spent['join'] * 1e3:.3f} ms ({spent['steps']} fused steps, one "
        f"read-back each), refine {spent['refine'] * 1e3:.3f} ms and the rest (grouping, "
        f"match tuples on the host) {(join_s - spent['join'] - spent['refine']) * 1e3:.3f} ms; "
        f"device busy {busy:.3f} ms in {sum(e.count for e in kernels)} kernel launches, {dtoh} "
        "device-to-host copies")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]:
        log(f"  device {e.self_device_time_total / 1e3:.3f} ms x{e.count}: {e.key[:90]}")


def k2_steps(eng, queries, **kw) -> list:
    """K2's verdicts in one device-join ``match_many(queries, **kw)``: (old,
    new, result) for every join step, each equal to the plain version's bit
    for bit."""
    import torch

    from repro_torch.kernels.merge_join import ops as mj
    from repro_torch.kernels.merge_join.ref import injectivity_mask_ref

    seen = []
    verdict = mj.injectivity_mask

    def record(old, new):
        res = verdict(old, new)
        seen.append((old, new, res))
        return res

    mj.injectivity_mask = record
    try:
        eng.match_many(queries, join_impl="device", **kw)
    finally:
        mj.injectivity_mask = verdict
    for old, new, res in seen:
        require(torch.equal(res, injectivity_mask_ref(old, new)),
                f"K2 on a real join step (T={old.shape[0]}) differs from the plain version")
    return seen


def k2_table(old, new):
    """A real step's operands as the join hands them in: the column slices
    of one contiguous (T, Co + Cn) table → (table, (old view, new view))."""
    import torch

    table = torch.cat([old, new], dim=1)
    return table, (table[:, :old.shape[1]], table[:, old.shape[1]:])


def k2_readings(fn, table, ops, reps: int, flush) -> dict:
    """K2's three readings on ``ops`` (views of ``table``): L2 flushed by a
    write (dirty lines that the reads write back first), by a read (clean
    lines), and with the table just rewritten after the flush, as the
    join's ``torch.cat`` leaves it (in L2) → ms by reading."""
    src = table.clone()
    return {
        "dirty": time_ms(fn, ops, reps, flush),
        "clean": time_ms(fn, ops, reps, flush, clean=True),
        "rewritten": time_ms(fn, ops, reps, flush, before=lambda: table.copy_(src)),
    }


def profiled_ms(fn, ops, key: str, flush, reps: int = 20) -> tuple[float, int]:
    """The mean duration of the kernels whose name holds ``key`` under
    ``torch.profiler`` (the device's own start and end of each launch,
    without the events' floor), L2 flushed by a read before each call →
    (ms, launches the profiler listed): it may list fewer than ``reps`` (§7
    of PERF.md), and the mean is over those it lists (NaN where none)."""
    import torch

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.sum()
            fn(*ops)
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA and key in e.key]
    listed = sum(e.count for e in evs)
    total = sum(e.self_device_time_total for e in evs) / 1e3
    return (total / listed if listed else float("nan")), listed


def fmt_readings(r: dict, bound: float) -> str:
    return "; ".join(f"{k} {v:.6f} ms ({bound / v * 100:.1f} % of the bound)" for k, v in r.items())


# ---- phase 2 ----------------------------------------------------------------


def k1_ptxas_report() -> None:
    """ptxas's registers, spills and shared memory for every instantiation of
    K1 (from this run's build); fails on a spill."""
    import re

    from repro_torch.kernels import build as kbuild

    text = kbuild.BUILD_LOG.get("dominance_scan")
    require(text is not None, "K1 was not built in this run: no ptxas report")
    rep: dict = {}
    cur = None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"dominance_scan_(packed|indexed)_kernelI((?:L[ib]\d+E)+)E", m.group(1))
            cur = None
            if k:
                cur = f"{k.group(1)} <{', '.join(re.findall(r'L[ib](\d+)E', k.group(2)))}>"
            if cur:
                rep[cur] = {}
        elif cur is not None and "spill stores" in line:
            rep[cur]["stack"], rep[cur]["stores"], rep[cur]["loads"] = map(
                int, re.findall(r"(\d+) bytes", line)[:3])
        elif cur is not None and re.search(r"Used \d+ registers", line):
            rep[cur]["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
            s = re.search(r"(\d+) bytes smem", line)
            rep[cur]["static_smem"] = int(s.group(1)) if s else 0
    require(len(rep) == 10, f"K1 ptxas report names {sorted(rep)}, not 4 packed and 6 indexed")
    for name, r in sorted(rep.items()):
        log(f"K1 ptxas, {name}: {r['registers']} registers a thread, static shared memory "
            f"{r['static_smem']} bytes, spill stores {r['stores']} bytes, spill loads "
            f"{r['loads']} bytes, stack {r['stack']} bytes")
        require(r["stores"] == 0 and r["loads"] == 0,
                f"K1 {name} spills ({r['stores']} / {r['loads']} bytes)")


def k3_ptxas_report() -> None:
    """ptxas's registers, spills and shared memory for the two instantiations of
    K3 (from this run's build) and the dynamic shared memory of the launches the
    main path makes; fails on a spill."""
    import re

    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels.dominance_scan.kernel import scan_smem_bytes

    text = kbuild.BUILD_LOG.get("dominance_scan")
    require(text is not None, "K3 was not built in this run: no ptxas report")
    rep: dict = {}
    cur = None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"dominance_scan_batch_kernelILi(\d+)ELi(\d+)E", m.group(1))
            cur = f"({k.group(1)}, {k.group(2)})" if k else None
            if cur:
                rep[cur] = {}
        elif cur is not None and "spill stores" in line:
            rep[cur]["stack"], rep[cur]["stores"], rep[cur]["loads"] = map(
                int, re.findall(r"(\d+) bytes", line)[:3])
        elif cur is not None and re.search(r"Used \d+ registers", line):
            rep[cur]["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
            s = re.search(r"(\d+) bytes smem", line)
            rep[cur]["static_smem"] = int(s.group(1)) if s else 0
    require(sorted(rep) == ["(16, 8)", "(18, 6)"], f"K3 ptxas report names {sorted(rep)}")
    for name, r in sorted(rep.items()):
        log(f"K3 ptxas, instantiation (CD, CD0) = {name}: {r['registers']} registers a thread "
            f"(384 threads a block), static shared memory {r['static_smem']} bytes, spill stores "
            f"{r['stores']} bytes, spill loads {r['loads']} bytes, stack {r['stack']} bytes")
        require(r["stores"] == 0 and r["loads"] == 0,
                f"K3 {name} spills ({r['stores']} / {r['loads']} bytes)")
    log(f"K3 dynamic shared memory at D = 18, D0 = 6: {scan_smem_bytes(1, 18, 6)} bytes at Q = 1, "
        f"{scan_smem_bytes(70, 18, 6)} at Q = 70, {scan_smem_bytes(3000, 18, 6)} at Q = 3000 "
        f"(query tiles); at D = 300, D0 = 12: {scan_smem_bytes(17, 300, 12)} at Q = 17")


def k2_ptxas_report() -> None:
    """ptxas's registers, spills and shared memory for every instantiation of
    K2 (from this run's build), and the dynamic shared memory of a block's
    full ring at the widths the join uses; fails on a spill."""
    import re

    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels.merge_join.kernel import ring_bytes

    text = kbuild.BUILD_LOG.get("injectivity_mask")
    require(text is not None, "K2 was not built in this run: no ptxas report")
    rep: dict = {}
    cur = None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"injectivity_mask_kernelILi(\d+)ELi(\d+)ELi(\d+)E", m.group(1))
            cur = tuple(map(int, k.groups())) if k else None
            if cur:
                rep[cur] = {}
        elif cur is not None and "spill stores" in line:
            rep[cur]["stores"], rep[cur]["loads"] = map(int, re.findall(r"(\d+) bytes", line)[1:3])
        elif cur is not None and re.search(r"Used \d+ registers", line):
            rep[cur]["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
            s = re.search(r"(\d+) bytes smem", line)
            rep[cur]["static_smem"] = int(s.group(1)) if s else 0
    widths = sorted(w for w, _, _ in rep)
    require(widths == list(range(17)), f"K2 ptxas report names widths {widths}")
    for (w, threads, stages), r in sorted(rep.items()):
        require(r["stores"] == 0 and r["loads"] == 0,
                f"K2 at W = {w or 'runtime'} spills ({r['stores']} / {r['loads']} bytes)")
    log("K2 ptxas, registers a thread by instantiation (W = 0 is the runtime width, 17 to 64): "
        + ", ".join(f"W={w}: {r['registers']} ({threads} threads, {stages} stages)"
                    for (w, threads, stages), r in sorted(rep.items()))
        + "; spill stores and loads 0 bytes in every one, static shared memory "
        + f"{max(r['static_smem'] for r in rep.values())} bytes")
    log("K2 dynamic shared memory of a full ring: " + ", ".join(
        f"W={w}: {ring_bytes(w)} bytes" for w in (2, 4, 7, 8, 16, 17, 64)))


def k2_edge_checks(dev, err) -> float:
    """K2 on the shapes its design makes distinct, in every layout of
    ``ref.join_layouts`` and on rows of all sentinels, bit-equal to the
    plain version, each launch counted on the layout the wrapper gives it
    → max |err|."""
    import torch

    from repro_torch.kernels.merge_join import ops as mj
    from repro_torch.kernels.merge_join.ref import (
        injectivity_mask_ref,
        join_layouts,
        make_join_rows,
    )

    worst = 0.0
    widths = ((1, 1), (6, 1), (5, 2), (7, 1), (0, 8), (8, 8), (15, 1), (9, 8), (56, 8))
    for T in (3, 4, 5, 4097, 524_293):
        for Co, Cn in widths:
            old, new = (torch.from_numpy(a).to(dev) for a in make_join_rows(T, Co, Cn, seed=T + Co))
            want = injectivity_mask_ref(old, new)
            for what, (a, b, layout) in join_layouts(old, new).items():
                before = mj.CONTIGUOUS_LAUNCHES
                got = mj.injectivity_mask(a, b)
                label = f"K2 at T={T}, Co={Co}, Cn={Cn}, {what}"
                worst = max(worst, err(got, want, label))
                require((mj.CONTIGUOUS_LAUNCHES - before == 1) == (layout == "contiguous"),
                        f"{label}: not launched on the {layout} layout")
            s_old, s_new = (torch.from_numpy(a).to(dev)
                            for a in make_join_rows(T, Co, Cn, seed=0, all_sentinels=True))
            _, (a, b) = k2_table(s_old, s_new)
            got = mj.injectivity_mask(a, b)
            worst = max(worst, err(got, injectivity_mask_ref(a, b), f"K2 sentinels at T={T}"))
            require(bool(got.all()), f"K2 dismissed a row of sentinels at T={T}, Co={Co}")
        log(f"K2 T={T}: bit-equal to the plain version at (Co, Cn) in "
            + ", ".join(f"({co}, {cn})" for co, cn in widths)
            + f", in the layouts {', '.join(join_layouts(old, new))} and on rows of all sentinels")
    return worst


def phase2_kernels(dev, big: int = (1 << 20) + 7) -> dict:
    """Each kernel against its plain version, bit for bit → max |err| by kernel."""
    import torch

    from repro_torch.kernels.dominance_scan import ops as ds
    from repro_torch.kernels.dominance_scan.ref import (
        dominance_scan_batch_ref,
        dominance_scan_groups_indexed_ref,
        dominance_scan_groups_ref,
        dominance_scan_pairs_indexed_ref,
        dominance_scan_pairs_ref,
        dominance_scan_ref,
        make_groups,
        make_pairs,
        make_scan,
        make_segments,
    )
    from repro_torch.kernels.merge_join import ops as mj
    from repro_torch.kernels.merge_join.ref import injectivity_mask_ref, make_join_rows

    def err(got, want, what: str) -> float:
        sync(dev)
        require(got.shape == want.shape and torch.equal(got, want),
                f"{what} differs from its plain version")
        return float((got.int() - want.int()).abs().max()) if got.numel() else 0.0

    k1_ptxas_report()
    k3_ptxas_report()
    k2_ptxas_report()
    errs = {"K1": 0.0, "K2": 0.0, "K3-single": 0.0, "K3-batch": 0.0}
    for T in (1, 1000, big):
        args = [torch.from_numpy(a).to(dev) for a in make_pairs(T, seed=T)]
        got = ds.dominance_scan_pairs(*args)
        errs["K1"] = max(errs["K1"], err(got, dominance_scan_pairs_ref(*args), f"K1 at T={T}"))
        log(f"K1 T={T}: bit-equal to the plain version, kept {int(got.sum())}")
    # K1's packed groups form: one launch reading (hi, lo0, hi0) as they are, ties
    # exactly at hi + eps, hi0 + eps and lo0 - eps and one ulp either side of each
    for T in (1, 1000, big):
        args = [torch.from_numpy(a).to(dev) for a in make_groups(T, seed=T)]
        before = ds.LAUNCHES
        got = ds.dominance_scan_groups(*args)
        require(ds.LAUNCHES == before + 1, "K1's groups form did not launch K1 once")
        errs["K1"] = max(errs["K1"], err(got, dominance_scan_groups_ref(*args),
                                         f"K1's groups form at T={T}"))
        log(f"K1 packed groups T={T} (D=18, D0=6, one launch): bit-equal to the direct three "
            f"compares, kept {int(got.sum())}")
    # K1's indexed forms: segments over their own shuffled tables (separate o(p), o'(p)
    # tensors, or column views of one table), an empty segment among them, the ties of
    # make_pairs / make_groups reaching the kernel through the indices; then more
    # segments than a block keeps in shared memory, tables 4 bytes off 8 (4-byte
    # loads), and widths read at run time
    for groups in (False, True):
        form = "groups" if groups else "pairs"
        fn = ds.dominance_scan_groups_indexed if groups else ds.dominance_scan_pairs_indexed
        plain = dominance_scan_groups_indexed_ref if groups else dominance_scan_pairs_indexed_ref
        cases = [(T, dict(n_seg=5, views=v), 0) for T in (1, 1001, big) for v in (False, True)]
        cases += [(200_003, dict(n_seg=300), 0), (100_003, dict(n_seg=5), 1),
                  (40_001, dict(n_seg=4, W=5, N=2, D0=3), 0)]
        for T, kw, floats in cases:
            segs = make_segments(T, seed=T + groups, groups=groups, device=dev, **kw)
            segs = segments_on(segs, dev, floats) if floats else segs
            lay = ds.segment_layout(segs, groups)
            before = ds.LAUNCHES
            got = fn(segs)
            require(ds.LAUNCHES == before + 1, f"K1 indexed {form} did not launch K1 once")
            label = f"K1 indexed {form} at T={T}, {lay.n_seg} segments, {kw}, base +{4 * floats} B"
            errs["K1"] = max(errs["K1"], err(got, plain(segs), label))
            log(f"{label} (widths {lay.width} x {lay.tables}, {lay.labels}; 8-byte loads "
                f"{lay.vec}): bit-equal to the plain version, kept {int(got.sum())}")
    for T in (1, 1000, big):
        for Co, Cn in ((7, 1), (5, 2), (0, 3), (3, 2), (56, 8)):
            old, new = (torch.from_numpy(a).to(dev) for a in make_join_rows(T, Co, Cn, seed=T + Co))
            got = mj.injectivity_mask(old, new)
            want = injectivity_mask_ref(old, new)
            errs["K2"] = max(errs["K2"], err(got, want, f"K2 at T={T}, Co={Co}, Cn={Cn}"))
        log(f"K2 T={T}: bit-equal to the plain version at (Co, Cn) in "
            "(7, 1), (5, 2), (0, 3), (3, 2), (56, 8)")
    errs["K2"] = max(errs["K2"], k2_edge_checks(dev, err))
    for N in (1, 1000, big):
        q, q0, emb, emb0 = (torch.from_numpy(a).to(dev) for a in make_scan(1, N, seed=N))
        got = ds.dominance_scan(q[0], q0[0], emb, emb0)
        want = dominance_scan_ref(q[0], q0[0], emb, emb0)
        errs["K3-single"] = max(errs["K3-single"], err(got, want, f"K3-single at N={N}"))
        log(f"K3-single N={N}: bit-equal to the plain version, kept {int(got.sum())}")
    for Q, N in ((1, 1), (7, 1000), (64, big)):
        q, q0, emb, emb0 = (torch.from_numpy(a).to(dev) for a in make_scan(Q, N, seed=Q + N))
        got = ds.dominance_scan(q, q0, emb, emb0)
        want = dominance_scan_batch_ref(q, q0, emb, emb0)
        errs["K3-batch"] = max(errs["K3-batch"], err(got, want, f"K3-batch at Q={Q}, N={N}"))
        log(f"K3-batch Q={Q} N={N}: bit-equal to the plain version, kept {int(got.sum())}")
    # K3's edges: bases one float past 16 bytes (word copies), output rows that start off
    # a 4-byte word (N % 4 != 0: byte stores), query tiles (more queries than shared
    # memory holds), wide rows (column chunks), and labels that all match (no vote skips)
    for what, Q, N, D, D0, match, off in (
        ("N=1037", 17, 1037, 18, 6, False, False),
        ("N=4099", 17, 4099, 18, 6, False, False),
        ("query tiles", 3000, 4099, 18, 6, False, False),
        ("D=300", 17, 4099, 300, 12, False, False),
        ("D=300", 3, 100_003, 300, 12, False, False),
        ("D=5", 17, 4099, 5, 3, False, False),
        ("all labels matching", 70, big, 18, 6, True, False),
        ("offset base", 17, 4099, 18, 6, False, True),
        ("offset base", 17, big, 18, 6, False, True),
        ("offset base", 17, 4099, 5, 3, False, True),
    ):
        arrs = make_scan(Q, N, seed=Q + N + D, D=D, D0=D0, match_labels=match)
        q, q0, emb, emb0 = (
            off_by_one_float(t) if off else t for t in (torch.from_numpy(a).to(dev) for a in arrs)
        )
        got = ds.dominance_scan(q, q0, emb, emb0)
        want = dominance_scan_batch_ref(q, q0, emb, emb0)
        label = f"{what} (Q={Q}, N={N}, D={D}, D0={D0})"
        errs["K3-batch"] = max(errs["K3-batch"], err(got, want, f"K3-batch at {label}"))
        for k in range(min(Q, 3)):
            qk, q0k = (off_by_one_float(t[k]) if off else t[k].contiguous() for t in (q, q0))
            got1 = ds.dominance_scan(qk, q0k, emb, emb0)
            errs["K3-single"] = max(errs["K3-single"], err(
                got1, dominance_scan_ref(qk, q0k, emb, emb0), f"K3-single at {label}, row {k}"))
        log(f"K3 at {label}: batch and single (rows 0-{min(Q, 3) - 1}) bit-equal to their "
            f"plain versions, kept {int(got.sum())} of {got.numel()}")
    return errs


def off_by_one_float(t):
    """A contiguous copy of ``t`` whose data start one float past an allocation
    (so 4 bytes past a 16-byte boundary)."""
    import torch

    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    buf[1:] = t.reshape(-1)
    out = buf[1:].view(t.shape)
    require(out.is_contiguous() and out.data_ptr() % 16 == 4, "offset copy is not 4 bytes off")
    return out


# ---- phase 3 ----------------------------------------------------------------


def dense_scan_check(eng, queries, dev):
    """For every partition and plan path, K3 over the partition's index
    keeps exactly the loop probe's rows (K3-batch for all paths at once,
    K3-single per path) → (query rows, label rows) of partition 0, the
    concatenated index (emb ⊕ emb_multi, emb0) and the count of checks."""
    import torch

    from repro_torch.kernels.dominance_scan import ops as ds

    q_embs = eng._query_node_embeddings_many(queries)
    cat, spans, _ = q_embs
    plans = [eng._deg_plan_cached(q) for q in queries]
    requests = list(dict.fromkeys((qi, p) for qi, pl in enumerate(plans) for p in pl.paths))
    memo: dict = {}
    eng._probe_batch(requests, q_embs, memo)
    n_multi = eng.cfg.n_multi
    all_e, all_e0, q0_rows = [], [], None
    reset_counters()
    for mi, model in enumerate(eng.models):
        idx = model.index
        o, o0, om = cat[mi]
        gidx = torch.as_tensor(
            np.asarray([spans[qi] + np.asarray(p) for qi, p in requests]), device=dev
        )
        R = len(requests)
        qm = torch.cat(
            [o[gidx].reshape(R, -1)] + [om[i][gidx].reshape(R, -1) for i in range(n_multi)],
            dim=1,
        ).contiguous()
        q0m = o0[gidx].reshape(R, -1).contiguous()
        e_cat = torch.cat([idx.emb] + [idx.emb_multi[i] for i in range(n_multi)], dim=1)
        want = torch.zeros((R, idx.n_paths), dtype=torch.bool, device=dev)
        for k, (qi, p) in enumerate(requests):
            rows = memo.get((mi, qi, p))
            if rows is not None:
                want[k, rows] = True
        batch = ds.dominance_scan(qm, q0m, e_cat, idx.emb0)
        single = torch.stack(
            [ds.dominance_scan(qm[k], q0m[k], e_cat, idx.emb0) for k in range(R)]
        )
        require(torch.equal(batch, want), f"K3-batch differs from the loop probe, partition {mi}")
        require(torch.equal(single, want), f"K3-single differs from the loop probe, partition {mi}")
        all_e.append(e_cat)
        all_e0.append(idx.emb0)
        if q0_rows is None:
            q_rows, q0_rows = qm, q0m
    launches = counters()
    return q_rows, q0_rows, torch.cat(all_e), torch.cat(all_e0), launches, len(requests)


def phase3_main_path(dev, flush, n: int = 50_000, n_parts: int = 80, n_queries: int = 16):
    import torch

    from repro_torch.core import GnnPeEngine, sort_matches
    from repro_torch.core import index as index_mod
    from repro_torch.kernels.dominance_scan import ops as ds
    from repro_torch.kernels.dominance_scan.ref import (
        dominance_scan_batch_ref,
        dominance_scan_pairs_indexed_ref,
        dominance_scan_pairs_ref,
        dominance_scan_ref,
        gather_pair_operands,
    )
    from repro_torch.kernels.merge_join import ops as mj

    out: dict = {}
    g, queries, cfg = cell_50k_inputs(n, n_parts, n_queries)
    reset_counters()  # counts from here to the end of the cold match_many
    pairs_before = index_mod.PAIR_METRIC.get(kind="leaf_pairs")
    t_build = time.perf_counter()
    eng = GnnPeEngine(cfg).build(g)
    build_s = time.perf_counter() - t_build
    t_cold = time.perf_counter()
    matches = eng.match_many(queries)
    sync(dev)
    cold_s = time.perf_counter() - t_cold
    out["K1"] = counters()["K1"]
    leaf_pairs = int(index_mod.PAIR_METRIC.get(kind="leaf_pairs") - pairs_before)
    require(out["K1"] > 0, "match_many never launched the K1 kernel")
    warm = []
    for _ in range(3):
        t_w = time.perf_counter()
        again = eng.match_many(queries)
        sync(dev)
        warm.append((time.perf_counter() - t_w) * 1e3)
        require(again == matches, "warm match_many differs from the cold run")
    # the real probe's verdict: one K1 launch on the partitions' own tables, recorded
    # and re-run through the plain version; timed as it runs (indexed), beside the
    # route it replaced and the packed form on the same pairs gathered
    seen = recorded_verdicts(lambda: eng.match_many(queries))
    require(len(seen) == 1, f"expected one fused verdict per match_many, saw {len(seen)}")
    (segs, eps), keep = seen[0]
    tables_in_place(segs, [m.index for m in eng.models], "phase 3 loop probe")
    out["K1_T"] = T = verdict_pairs(seen[0][0])
    require(torch.equal(keep, dominance_scan_pairs_indexed_ref(segs, eps)),
            "K1 on the real probe's pairs differs from the plain version")
    lay = ds.segment_layout(segs)
    D, D0 = lay.width * lay.tables, lay.labels
    out["K1_ms"] = time_ms(ds.dominance_scan_pairs_indexed, (segs, eps), 20, flush,
                           spin=LONG_SPIN)
    out["K1_plain_ms"] = time_ms(dominance_scan_pairs_indexed_ref, (segs, eps), 10, flush,
                                 spin=LONG_SPIN)
    k1_host = host_ms(ds.dominance_scan_pairs_indexed, (segs, eps))
    out["K1_bound"] = k1_indexed_bound_ms(segs)
    k1_prof = profiled_ms(ds.dominance_scan_pairs_indexed, (segs, eps),
                          "dominance_scan_indexed_kernel", flush)[0]
    require(torch.equal(replaced_route(segs, eps), keep),
            "the replaced route (gathers, cats, packed K1) differs from the indexed K1")
    route_ms = time_ms(replaced_route, (segs, eps), 10, flush, spin=LONG_SPIN)
    route_host = host_ms(replaced_route, (segs, eps))
    parts = [gather_pair_operands(s_) for s_ in segs]
    packed = tuple(torch.cat([p_[k] for p_ in parts]) for k in range(4)) + (eps,)
    require(torch.equal(ds.dominance_scan_pairs(*packed), keep),
            "the packed K1 on the gathered pairs differs from the indexed K1")
    pk_ms = time_ms(ds.dominance_scan_pairs, packed, 50, flush)
    pk_prof = profiled_ms(ds.dominance_scan_pairs, packed, "dominance_scan_packed_kernel",
                          flush)[0]
    pk_plain = time_ms(dominance_scan_pairs_ref, packed, 20, flush)
    pk_bound = k1_bound_ms(T, D, D0)
    out["K1_forms"] = {"indexed_pairs": (out["K1_ms"], k1_prof, out["K1_bound"][0], route_ms,
                                         k1_host, route_host),
                       "packed_pairs": (pk_ms, pk_prof, pk_bound[0], pk_plain, None, None)}
    del parts, packed
    t_vf2 = time.perf_counter()
    n_matches = check_against_vf2(g, queries, matches, "host join")
    log(f"VF2 check of {n_queries} queries: {time.perf_counter() - t_vf2:.3f} s, "
        f"{n_matches} matches")
    log(f"paths indexed: {eng.offline_stats['n_paths']}")
    log(f"leaf pairs (cold match_many): {leaf_pairs}; fused verdict T = {T}, D = {D}, D0 = {D0}")
    log(f"build: {build_s:.3f} s (train {eng.offline_stats['train_time']:.3f}, "
        f"embed {eng.offline_stats['embed_time']:.3f}, index {eng.offline_stats['index_time']:.3f})")
    log(f"match_many cold: {cold_s * 1e3:.3f} ms; warm: {fmt(warm)} ms")
    log(f"K1 launches on the main path (build + cold match_many): {out['K1']}")
    log(f"K1 indexed pairs on the loop probe's real call, T={T} in {lay.n_seg} segments "
        f"(widths {lay.width} x {lay.tables}, {D0}; 8-byte loads {lay.vec}): "
        f"{out['K1_ms']:.6f} ms (events: the descriptor's copy and the kernel), "
        f"{fmt_ms(k1_prof)} (profiler, kernel alone); bound {out['K1_bound'][0]:.6f} ms "
        f"({out['K1_bound'][1]}: indices, distinct rows, verdicts); plain version "
        f"{out['K1_plain_ms']:.6f} ms; the route it replaced (gathers, cats, packed K1) "
        f"{route_ms:.6f} ms; host enqueue {k1_host:.6f} ms a call, the route's {route_host:.6f}")
    log(f"K1 packed pairs on the same pairs gathered, T={T} (D={D}, D0={D0}): {pk_ms:.6f} ms "
        f"(events), {fmt_ms(pk_prof)} (profiler); bound {pk_bound[0]:.6f} ms ({pk_bound[1]}; "
        f"{pk_bound[0] / pk_ms:.3f} of it by events); plain version {pk_plain:.6f} ms")

    # ---- the device join on the same engine ------------------------------
    reset_counters()
    t_cold = time.perf_counter()
    dev_matches = eng.match_many(queries, join_impl="device")
    sync(dev)
    cold_dev_s = time.perf_counter() - t_cold
    launched = counters()
    out["K2"] = launched["K2"]
    contiguous = mj.CONTIGUOUS_LAUNCHES
    log(f"K2 LAUNCHES (device join, cold match_many of the 50K cell): {launched['K2']}, "
        f"{contiguous} of them on the contiguous layout; K1 {launched['K1']}")
    require(launched["K2"] > 0, "the device join never launched the K2 kernel")
    require(contiguous == launched["K2"], "a K2 launch of the 50K cell missed the contiguous layout")
    check_against_vf2(g, queries, dev_matches, "device join")
    for qi, (a, b) in enumerate(zip(dev_matches, matches)):
        require(sort_matches(a) == sort_matches(b), f"device and host joins differ, query {qi}")
    dev_warm, host_warm = [], []
    for _ in range(3):
        dev_warm += warm_ms(lambda: eng.match_many(queries, join_impl="device"), dev, 1)
        host_warm += warm_ms(lambda: eng.match_many(queries), dev, 1)
    _, dstats = eng.match_many(queries, join_impl="device", return_stats=True)
    log(f"device join match_many cold: {cold_dev_s * 1e3:.3f} ms; warm: {fmt(dev_warm)} ms "
        f"(join + refine {sum(s.join_time for s in dstats) * 1e3:.3f} ms of the last); "
        f"host join warm, interleaved: {fmt(host_warm)} ms")
    device_join_breakdown(eng, queries, dev, "50K cell")
    seen = sorted(k2_steps(eng, queries), key=lambda st: st[0].shape[0])
    log(f"K2 on {len(seen)} real join steps of the 50K cell: equal to the plain version; steps "
        "(T, Co, Cn) by T: "
        + ", ".join(f"({o.shape[0]}, {o.shape[1]}, {w.shape[1]})" for o, w, _ in seen))
    old, new, _ = seen[len(seen) // 2]
    T, Co, Cn = old.shape[0], old.shape[1], new.shape[1]
    table, ops = k2_table(old, new)
    bound = k2_bound_ms(T, Co, Cn)
    out["K2_median"] = k2_readings(mj.injectivity_mask, table, ops, 50, flush)
    log(f"K2 at the 50K cell's median step T={T}, Co={Co}, Cn={Cn} (bound {bound[0]:.3g} ms, "
        f"{bound[1]}): {fmt_readings(out['K2_median'], bound[0])}")

    # ---- K3: the dense scan over the real index ---------------------------
    qm, q0m, e_all, e0_all, k3_launches, n_req = dense_scan_check(eng, queries, dev)
    out["K3-single"] = k3_launches["K3-single"]
    out["K3-batch"] = k3_launches["K3-batch"]
    require(out["K3-single"] > 0 and out["K3-batch"] > 0, "the dense scan never launched K3")
    log(f"K3 over {len(eng.models)} partitions x {n_req} plan paths: batch and single scans "
        f"keep exactly the loop probe's rows; launches K3-single {out['K3-single']}, "
        f"K3-batch {out['K3-batch']}")
    N, D = e_all.shape
    D0 = e0_all.shape[1]
    q1, q01 = qm[0].contiguous(), q0m[0].contiguous()
    # the same shapes with every label equal: no cell is dismissed by its labels, so
    # no vote skips a query and every cell pays its dominance compares
    qz, ez = torch.zeros_like(q0m), torch.zeros_like(e0_all)
    runs = {
        "K3s": (ds.dominance_scan, dominance_scan_ref, (q1, q01, e_all, e0_all), 50, 50),
        "K3b": (ds.dominance_scan, dominance_scan_batch_ref, (qm, q0m, e_all, e0_all), 20, 5),
        "K3b_match": (ds.dominance_scan, dominance_scan_batch_ref, (qm, qz, e_all, ez), 20, 5),
    }
    require(torch.equal(ds.dominance_scan(qm, qz, e_all, ez),
                        dominance_scan_batch_ref(qm, qz, e_all, ez)),
            "K3-batch with all labels matching differs from the plain version")
    for key, (fn, plain, args, reps, plain_reps) in runs.items():
        # in turns: plain, kernel, kernel, plain
        p1 = time_ms(plain, args, plain_reps, flush)
        k1 = time_ms(fn, args, reps, flush)
        k2 = time_ms(fn, args, reps, flush)
        p2 = time_ms(plain, args, plain_reps, flush)
        out[f"{key}_runs"], out[f"{key}_plain_runs"] = [k1, k2], [p1, p2]
        out[f"{key}_ms"], out[f"{key}_plain_ms"] = (k1 + k2) / 2, (p1 + p2) / 2
        out[f"{key}_clean_ms"] = time_ms(fn, args, reps, flush, clean=True)
    out["K3s_bound"] = k3_bound_ms(1, N, D, D0)
    out["K3b_bound"] = k3_bound_ms(n_req, N, D, D0)
    for key, what in (("K3s", f"K3-single at N={N}, D={D}, D0={D0}"),
                      ("K3b", f"K3-batch at Q={n_req}, N={N}"),
                      ("K3b_match", f"K3-batch at Q={n_req}, N={N}, all labels matching")):
        bound = out["K3s_bound" if key == "K3s" else "K3b_bound"]
        log(f"{what}: {fmt(out[key + '_runs'], 6)} ms (in turns with the plain version "
            f"{fmt(out[key + '_plain_runs'], 6)} ms: plain, kernel, kernel, plain), bound "
            f"{bound[0]:.6f} ms ({bound[1]}), {bound[0] / out[key + '_ms'] * 100:.1f} % of it; "
            f"with L2 flushed by a read (clean lines, nothing to write back) "
            f"{out[key + '_clean_ms']:.6f} ms, {bound[0] / out[key + '_clean_ms'] * 100:.1f} %")

    # ---- the scalar match on the same engine ------------------------------
    t_s = time.perf_counter()
    scalar = [eng.match(q, impl="scalar") for q in queries]
    sync(dev)
    scalar_cold = (time.perf_counter() - t_s) * 1e3
    for qi, (a, b) in enumerate(zip(scalar, matches)):
        require(a == b, f"the scalar match differs from match_many, query {qi}")
    # cold only (its warm rerun, 9.5 s of a plain cross-check path, cut for phase 15's time)
    log(f"scalar match (match(q, impl='scalar'), plain tensor code) of {n_queries} queries: "
        f"lists equal match_many's; cold {scalar_cold:.3f} ms, against match_many warm "
        f"{fmt(warm)} ms")

    # ---- the stacked probe on the same engine ----------------------------
    t_st = time.perf_counter()
    eng.stacked_probe()
    sync(dev)
    stack_s = time.perf_counter() - t_st
    os_ = eng.offline_stats
    log(f"stacking {len(eng.models)} partitions: {stack_s:.3f} s; stacked_bytes "
        f"{os_['stacked_bytes']}, real {os_['stacked_real_bytes']}, padding "
        f"{os_['stacked_padding_frac']:.4f} of it; index bytes (loop) {os_['index_bytes']}")
    reset_counters()
    t_c = time.perf_counter()
    st_matches = eng.match_many(queries, probe_impl="stacked")
    sync(dev)
    st_cold = (time.perf_counter() - t_c) * 1e3
    out["K1_stacked"] = counters()["K1"]
    require(out["K1_stacked"] > 0, "the stacked probe never launched the K1 kernel")
    require(st_matches == matches, "the stacked probe's lists differ from the loop probe's")
    # the stacked probe with the device join: the hand-off (probe_device)
    probe = eng.stacked_probe()
    expansions = probe.host_expansions
    reset_counters()
    st_dev = eng.match_many(queries, probe_impl="stacked", join_impl="device")
    out["K2_stacked"], out["K1_handoff"] = counters()["K2"], counters()["K1"]
    require(out["K2_stacked"] > 0, "stacked probe + device join never launched the K2 kernel")
    require(out["K1_handoff"] > 0, "the hand-off never launched the K1 kernel")
    require(mj.CONTIGUOUS_LAUNCHES == out["K2_stacked"],
            "a K2 launch of the stacked probe's device join missed the contiguous layout")
    require(probe.host_expansions == expansions,
            "the stacked probe's device join split rows on the host instead of the hand-off")
    for qi, (a, b) in enumerate(zip(st_dev, dev_matches)):
        require(sort_matches(a) == sort_matches(b),
                f"stacked probe + device join differs from the device join's set, query {qi}")
    n_handoff = handoff_check(eng, queries, st_dev)
    st_steps = k2_steps(eng, queries, probe_impl="stacked")
    require(probe.host_expansions == expansions, "a hand-off split rows on the host")
    log(f"stacked probe + device join (the hand-off): K1 launches {out['K1_handoff']}, K2 "
        f"launches {out['K2_stacked']}, all on the contiguous layout; K2 on its {len(st_steps)} "
        f"real join steps equal to the plain version; host expansions unchanged "
        f"({probe.host_expansions}); the device candidates of {n_handoff} probes equal the loop "
        "probe's rows in slot order, and the lists equal the device join over those")
    seen = recorded_verdicts(lambda: eng.match_many(queries, probe_impl="stacked"))
    T_st = sum(verdict_pairs(a) for a, _ in seen)
    emb_cat = eng.stacked_probe().stacked.emb_cat
    for args, keep_ in seen:
        require(torch.equal(keep_, dominance_scan_pairs_indexed_ref(*args)),
                "K1 on the stacked probe's pairs differs from the plain version")
        require(all(s_.data[0].data_ptr() == emb_cat.data_ptr() for s_ in args[0]),
                "the stacked probe's K1 read a copy, not the stacked tables")
    require(T_st == out["K1_T"],
            f"the stacked probe's verdict T {T_st} != the loop probe's {out['K1_T']}")
    st_args = max((a for a, _ in seen), key=verdict_pairs)
    st_ms = time_ms(ds.dominance_scan_pairs_indexed, st_args, 20, flush, spin=LONG_SPIN)
    st_host = host_ms(ds.dominance_scan_pairs_indexed, st_args)
    st_bound = k1_indexed_bound_ms(st_args[0])
    st_prof = profiled_ms(ds.dominance_scan_pairs_indexed, st_args,
                          "dominance_scan_indexed_kernel", flush)[0]
    st_route = time_ms(replaced_route, st_args, 10, flush, spin=LONG_SPIN)
    st_route_host = host_ms(replaced_route, st_args)
    out["K1_forms"]["indexed_pairs_stacked"] = (st_ms, st_prof, st_bound[0], st_route, st_host,
                                                st_route_host)
    log(f"K1 indexed pairs on the stacked probe's largest call (T={verdict_pairs(st_args)}, one "
        f"segment, flat rows into the stacked tables): {st_ms:.6f} ms (events), "
        f"{fmt_ms(st_prof)} (profiler); bound {st_bound[0]:.6f} ms ({st_bound[1]}); the route "
        f"it replaced {st_route:.6f} ms; host enqueue {st_host:.6f} ms, the route's "
        f"{st_route_host:.6f}")
    st_warm, loop_warm = [], []
    for _ in range(3):
        st_warm += warm_ms(lambda: eng.match_many(queries, probe_impl="stacked"), dev, 1)
        loop_warm += warm_ms(lambda: eng.match_many(queries), dev, 1)
    log(f"stacked probe: lists equal the loop probe's (host join) and the device join's; K1 "
        f"launches {out['K1_stacked']} (cold match_many), {len(seen)} verdicts of T = {T_st} "
        f"in all, equal to the plain version; cold {st_cold:.3f} ms; warm, interleaved: stacked "
        f"{fmt(st_warm)} ms, loop {fmt(loop_warm)} ms")
    ho_warm, loop_dev_warm = [], []
    expansions = probe.host_expansions
    for _ in range(3):
        ho_warm += warm_ms(
            lambda: eng.match_many(queries, probe_impl="stacked", join_impl="device"), dev, 1)
        loop_dev_warm += warm_ms(lambda: eng.match_many(queries, join_impl="device"), dev, 1)
    require(probe.host_expansions == expansions, "a warm hand-off split rows on the host")
    log(f"device join, warm, interleaved: stacked probe's hand-off {fmt(ho_warm)} ms, loop "
        f"probe {fmt(loop_dev_warm)} ms")
    # where a warm batch's time goes, for each probe: host-clock stages and device-busy time
    for impl in ("loop", "stacked"):
        profiled_match(lambda: eng.match_many(queries, return_stats=True, probe_impl=impl), dev,
                       f"50K cell, host join, {impl} probe")
    device_join_breakdown(eng, queries, dev, "50K cell, stacked probe's hand-off",
                          probe_impl="stacked")
    out["ctx"] = {"g": g, "queries": queries, "cfg": cfg, "matches": matches,
                  "index_bytes": os_["index_bytes"], "leaf_pairs": leaf_pairs, "eng": eng}
    return out


def handoff_check(eng, queries, lists) -> int:
    """The hand-off's candidates are the loop probe's rows, partition by
    partition in slot order, and ``lists`` (the hand-off's device-join
    lists) equal the device join over those candidates → probes checked."""
    import torch

    from repro_torch.core.matcher import match_from_candidates_many

    q_embs = eng._query_node_embeddings_many(queries)
    plans = [eng._deg_plan_cached(q) for q in queries]
    reqs = list(dict.fromkeys((qi, p) for qi, pl in enumerate(plans) for p in pl.paths))
    loop, memo, dev_memo, dev_counts = {}, {}, {}, {}
    eng._probe_batch(reqs, q_embs, loop, queries, "loop")
    eng._probe_batch(reqs, q_embs, memo, queries, "stacked", dev_memo=dev_memo,
                     dev_counts=dev_counts)
    require(not memo and set(dev_memo) == set(reqs), "the hand-off filled the host memo")
    slots = np.argsort(eng.stacked_probe().stacked.slot_of)
    want = {}
    for qi, p in reqs:
        parts = [eng.models[mi].index.paths[loop[(mi, qi, p)]] for mi in slots
                 if (mi, qi, p) in loop]
        want[(qi, p)] = torch.cat(parts).to(torch.int32)
        require(torch.equal(dev_memo[(qi, p)], want[(qi, p)]),
                f"the hand-off's candidates of probe {(qi, p)} differ from the loop probe's rows")
        for mi in range(len(eng.models)):
            n = loop[(mi, qi, p)].numel() if (mi, qi, p) in loop else 0
            require(dev_counts[(mi, qi, p)] == n, "the hand-off's partition counts differ")
    again = match_from_candidates_many(
        eng.graph, eng.dgraph, queries, [pl.paths for pl in plans],
        [[want[(qi, p)] for p in pl.paths] for qi, pl in enumerate(plans)],
        join_impl="device", assume_unique=True,
    )
    require(again == lists, "the hand-off's lists differ from the device join over its candidates")
    return len(reqs)


def tables_in_place(segs, indexes, what: str) -> None:
    """Every data table of ``segs`` is one of ``indexes``' own tensors: K1
    read the index where it lives, not a gathered copy."""
    own = {t.data_ptr() for ix in indexes for t in (ix.emb, ix.emb0, *ix.emb_multi)}
    require(all(t.data_ptr() in own for s in segs for t in s.data),
            f"{what}: K1 read a gathered copy, not the index's tables")


def recorded_verdicts(fn) -> list:
    """Every fused verdict of one ``fn()`` call: ((segments, eps), keep), each
    checked to be one K1 launch (none where it has no pairs)."""
    from repro_torch.core import index as index_mod
    from repro_torch.kernels.dominance_scan import ops as ds

    seen = []
    keep_mask = index_mod._pairs_keep_mask

    def record(*a):
        before = ds.LAUNCHES
        res = keep_mask(*a)
        require(ds.LAUNCHES - before == int(verdict_pairs(a) > 0),
                f"a fused verdict made {ds.LAUNCHES - before} K1 launches")
        seen.append((a, res))
        return res

    index_mod._pairs_keep_mask = record
    try:
        fn()
    finally:
        index_mod._pairs_keep_mask = keep_mask
    return seen


def profile_counts(fn, dev) -> dict:
    """One ``fn()`` under ``torch.profiler``: its result, wall ms (host
    clock), device-busy ms, kernel launches, device-to-host copies and the
    device events."""
    import torch

    with torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    ) as prof:
        t = time.perf_counter()
        res = fn()
        sync(dev)
        wall = (time.perf_counter() - t) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    return {
        "result": res,
        "kernels": kernels,
        "wall": wall,
        "busy": sum(e.self_device_time_total for e in kernels) / 1e3,
        "launches": sum(e.count for e in kernels),
        "dtoh": sum(e.count for e in kernels if "DtoH" in e.key),
    }


def profiled_match(fn, dev, what: str) -> None:
    """One warm ``match_many(..., return_stats=True)`` under ``torch.profiler``:
    wall, filter and join on the host clock, device-busy time, kernel launches
    and device-to-host copies."""
    prof = profile_counts(fn, dev)
    st = prof["result"][1]
    log(f"{what}, profiled warm match_many: {prof['wall']:.3f} ms wall; filter (embed + plan + "
        f"probe) {sum(s.filter_time for s in st) * 1e3:.3f} ms, join + refine "
        f"{sum(s.join_time for s in st) * 1e3:.3f} ms; device busy {prof['busy']:.3f} ms in "
        f"{prof['launches']} kernel launches, {prof['dtoh']} device-to-host copies")
    for e in sorted(prof["kernels"], key=lambda e: -e.self_device_time_total)[:5]:
        log(f"  device {e.self_device_time_total / 1e3:.3f} ms x{e.count}: {e.key[:90]}")


def phase3q_quantized_dr(dev, ctx: dict) -> dict:
    """The 50K cell's graph and queries under ``quantize_index=True,
    plan_weight="dr"``: both probes and both joins against phase 3's match
    sets, the scalar match, the prefilter's survivors, the dr plan cache."""
    import torch

    from repro_torch.core import GnnPeEngine, sort_matches
    from repro_torch.core import index as index_mod
    from repro_torch.core.index import hash_labels, quantize_data
    from repro_torch.kernels.dominance_scan.ref import dominance_scan_pairs_indexed_ref
    from repro_torch.kernels.merge_join import ops as mj

    out: dict = {"K2": 0}
    g, queries = ctx["g"], ctx["queries"]
    want = [sort_matches(m) for m in ctx["matches"]]
    cfg = dataclasses.replace(ctx["cfg"], quantize_index=True, plan_weight="dr")
    t_b = time.perf_counter()
    eng = GnnPeEngine(cfg).build(g)
    build_s = time.perf_counter() - t_b
    idx = eng.models[0].index
    cat = torch.cat([idx.emb, *idx.emb_multi], 1).cpu()
    require(torch.equal(idx.emb_q.cpu(), quantize_data(cat)),
            "partition 0's emb_q, made on the card, differs from quantize_data of its CPU copy")
    labels = torch.as_tensor(g.labels.astype(np.int64))[idx.paths.cpu()]
    require(torch.equal(idx.label_hash.cpu(), hash_labels(labels)),
            "partition 0's label_hash, made on the card, differs from hash_labels on the CPU")
    log(f"quantized dr engine: build {build_s:.3f} s "
        f"(index {eng.offline_stats['index_time']:.3f}); "
        f"partition 0's emb_q and label_hash ({idx.n_paths} paths) equal the CPU's; index bytes "
        f"{eng.offline_stats['index_bytes']} with the sidecar, {ctx['index_bytes']} without")

    def run(what: str, **kw):
        """One match_many, its K1 launches, pairs before the prefilter and T
        after; under the device join also its K2 launches, which must all
        take the contiguous layout (added to ``out["K2"]``)."""
        reset_counters()
        pairs0 = index_mod.PAIR_METRIC.get(kind="leaf_pairs")
        t = time.perf_counter()
        res = [None]
        seen = recorded_verdicts(lambda: res.__setitem__(0, eng.match_many(queries, **kw)))
        sync(dev)
        ms = (time.perf_counter() - t) * 1e3
        k1, k2 = counters()["K1"], counters()["K2"]
        pairs = int(index_mod.PAIR_METRIC.get(kind="leaf_pairs") - pairs0)
        T = sum(verdict_pairs(a) for a, _ in seen)
        for qi, m in enumerate(res[0]):
            require(sort_matches(m) == want[qi], f"{what}: query {qi} differs from phase 3's set")
        for a, keep in seen:
            require(torch.equal(keep, dominance_scan_pairs_indexed_ref(*a)),
                    f"{what}: K1 differs from the plain version")
        require(k1 > 0, f"{what}: K1 never launched")
        k2_note = ""
        if kw.get("join_impl") == "device":
            require(k2 > 0, f"{what}: K2 never launched")
            require(mj.CONTIGUOUS_LAUNCHES == k2,
                    f"{what}: a K2 launch missed the contiguous layout")
            out["K2"] += k2
            k2_note = f"; K2 launches {k2}, all contiguous"
        log(f"  {what}: {ms:.3f} ms; K1 launches {k1}{k2_note}; leaf pairs {pairs} before the "
            f"prefilter, T = {T} after it ({T / max(pairs, 1) * 100:.2f} % survive)")
        return res[0], k1

    hits = sum(eng._dr_plan_peek(q) is not None for q in queries)
    cold, k1_cold = run(f"cold match_many, loop probe ({hits} dr plans cached: probes every "
                        "candidate plan path)")
    hits = sum(eng._dr_plan_peek(q) is not None for q in queries)
    warm, _ = run(f"warm match_many, loop probe ({hits} dr plans cached: probes the plans' paths)")
    require(hits == len(queries) and warm == cold, "the warm dr batch missed the plan cache")
    out["K1"] = k1_cold
    for probe, join in (("loop", "device"), ("stacked", "numpy"), ("stacked", "device")):
        res, k1 = run(f"{probe} probe, {'host' if join == 'numpy' else 'device'} join",
                      probe_impl=probe, join_impl=join)
        out["K1"] += k1
    for probe in ("loop", "stacked"):
        steps = k2_steps(eng, queries, probe_impl=probe)
        log(f"  K2 on the {len(steps)} real join steps of the {probe} probe's device join: equal "
            "to the plain version; steps (T, Co, Cn): "
            + ", ".join(f"({o.shape[0]}, {o.shape[1]}, {w.shape[1]})" for o, w, _ in steps))
    eng._plan_cache.clear()  # the stacked probe's cold dr batch
    _, k1 = run("cold match_many, stacked probe", probe_impl="stacked")
    out["K1"] += k1
    for impl in ("loop", "stacked"):
        profiled_match(lambda: eng.match_many(queries, return_stats=True, probe_impl=impl), dev,
                       f"quantized dr engine, host join, {impl} probe")
    t_s = time.perf_counter()
    for qi, q in enumerate(queries[:2]):
        require(eng.match(q, impl="scalar") == cold[qi],
                f"quantized dr engine: the scalar match differs from match_many, query {qi}")
    log(f"  scalar match of queries 0-1 (dr weights from its own probes): "
        f"{(time.perf_counter() - t_s) * 1e3:.3f} ms, lists equal match_many's")
    return out


# ---- phase 3g ---------------------------------------------------------------


def recorded_level_verdicts(fn) -> list:
    """Every fused verdict of one ``fn()`` call at both probe levels:
    (level, (segments, eps), keep), level "groups" (K1's groups verdict) or
    "pairs", each checked to be one K1 launch."""
    from repro_torch.core import index as index_mod
    from repro_torch.kernels.dominance_scan import ops as ds

    seen = []
    saved = index_mod._groups_keep_mask, index_mod._pairs_keep_mask

    def recording(level, verdict):
        def run(*a):
            before = ds.LAUNCHES
            res = verdict(*a)
            require(ds.LAUNCHES - before == int(verdict_pairs(a) > 0),
                    f"a fused {level} verdict made {ds.LAUNCHES - before} K1 launches")
            seen.append((level, a, res))
            return res
        return run

    index_mod._groups_keep_mask = recording("groups", saved[0])
    index_mod._pairs_keep_mask = recording("pairs", saved[1])
    try:
        fn()
    finally:
        index_mod._groups_keep_mask, index_mod._pairs_keep_mask = saved
    return seen


def k1_groups_bound_ms(T: int, D: int, D0: int) -> tuple[float, str]:
    """T (query, group) pairs: qg and hi (D), q0g, lo0 and hi0 (D0) read once, a
    1-byte output; an add and a compare per dominance column, two of each per
    label column."""
    return bound_ms(T * 4 * (2 * D + 3 * D0) + T, T * (2 * D + 4 * D0))


def cpu_index(ix):
    """A CPU copy of the fields ``choose_group_size`` reads."""
    from repro_torch.core.index import PackedIndex

    return PackedIndex(ix.paths.cpu(), ix.emb.cpu(), ix.emb0.cpu(), ix.emb_multi.cpu(), [],
                       ix.block_size, ix.fanout)


def phase3g_grouped(dev, flush, ctx: dict) -> dict:
    """The 50K cell with ``index_kind="grouped", group_size=16`` (the
    configuration of ``benchmarks/bench_grouped.py --full``): both probes
    and both joins against phase 3's match sets, K1 at the group and the
    member level, leaf and group pairs, the groups form timed on its real
    operands, an auto-size engine and the grouped dr cost model."""
    from repro_torch.core import GnnPeEngine, sort_matches
    from repro_torch.core.grouping import choose_group_size
    from repro_torch.kernels.dominance_scan import ops as ds
    from repro_torch.kernels.dominance_scan.ref import (
        dominance_scan_groups_indexed_ref,
        dominance_scan_groups_ref,
        dominance_scan_pairs_indexed_ref,
        gather_group_operands,
    )
    from repro_torch.kernels.merge_join import ops as mj

    import torch

    out: dict = {"K1": 0, "K2": 0}
    g, queries = ctx["g"], ctx["queries"]
    want = [sort_matches(m) for m in ctx["matches"]]

    def build(**fields):
        t = time.perf_counter()
        eng = GnnPeEngine(dataclasses.replace(ctx["cfg"], **fields)).build(g)
        sync(dev)
        return eng, time.perf_counter() - t

    def run(eng, what: str, **kw):
        """One match_many: its K1 (and K2) launches and pairs, each counted from 0
        just before it; its lists equal phase 3's sets."""
        reset_counters()
        p0 = pair_counts()
        t = time.perf_counter()
        res = eng.match_many(queries, **kw)
        sync(dev)
        ms = (time.perf_counter() - t) * 1e3
        c, p1 = counters(), pair_counts()
        d = {k: int(p1[k] - p0[k]) for k in p0}
        for qi, m in enumerate(res):
            require(sort_matches(m) == want[qi], f"{what}: query {qi} differs from phase 3's set")
        require(c["K1"] > 0, f"{what}: K1 never launched")
        out["K1"] += c["K1"]
        note = ""
        if kw.get("join_impl") == "device":
            require(c["K2"] > 0 and mj.CONTIGUOUS_LAUNCHES == c["K2"],
                    f"{what}: K2 never launched, or off the contiguous layout")
            out["K2"] += c["K2"]
            note = f"; K2 launches {c['K2']}, all contiguous"
        log(f"  {what}: {ms:.3f} ms; K1 launches {c['K1']}{note}; group pairs "
            f"{d['group_pairs']}, leaf pairs {d['leaf_pairs']}")
        return res, c, d

    eng, build_s = build(index_kind="grouped", group_size=16)
    os_ = eng.offline_stats
    require(os_["n_groups"] > 0 and set(os_["group_sizes"]) == {16},
            "the grouped engine's sidecars are missing or not at size 16")
    log(f"grouped engine (group_size=16): build {build_s:.3f} s (index "
        f"{os_['index_time']:.3f}); {os_['n_groups']} groups over {os_['n_paths']} paths "
        f"({os_['n_paths'] / os_['n_groups']:.2f} a group); group bytes {os_['group_bytes']}; "
        f"index bytes {os_['index_bytes']} with the sidecar, {ctx['index_bytes']} without")
    _, c, grouped = run(eng, "cold match_many, grouped, loop probe, host join")
    require(c["K1"] >= 2, "the grouped loop probe did not launch K1 at both levels")
    _, _, path = run(eng, "path kind on the grouped engine, loop probe, host join",
                     index_kind="path")
    require(grouped["leaf_pairs"] < ctx["leaf_pairs"],
            f"the grouped probe's leaf pairs {grouped['leaf_pairs']} are not fewer than phase "
            f"3's path kind's {ctx['leaf_pairs']}")
    log(f"  leaf pairs: grouped {grouped['leaf_pairs']} (+ {grouped['group_pairs']} group "
        f"pairs) against the path kind's {path['leaf_pairs']} on this engine and "
        f"{ctx['leaf_pairs']} in phase 3 ({ctx['leaf_pairs'] / max(grouped['leaf_pairs'], 1):.1f}x)")
    # the real verdicts of a warm grouped batch, against the plain versions
    seen = recorded_level_verdicts(lambda: eng.match_many(queries))
    require([lv for lv, _, _ in seen] == ["groups", "pairs"],
            f"expected one group and one member verdict, saw {[lv for lv, _, _ in seen]}")
    for level, a, keep in seen:
        plain = (dominance_scan_groups_indexed_ref if level == "groups"
                 else dominance_scan_pairs_indexed_ref)
        require(torch.equal(keep, plain(*a)), f"K1 at the {level} level differs from plain")
    (segs, eps), g_keep = seen[0][1], seen[0][2]
    T, lay = verdict_pairs(seen[0][1]), ds.segment_layout(seen[0][1][0], groups=True)
    D, D0 = lay.width * lay.tables, lay.labels
    require(torch.equal(replaced_route(segs, eps, groups=True), g_keep),
            "the replaced group route (gathers, cats, PR 20's wrapper) differs from K1")
    parts = [gather_group_operands(s_) for s_ in segs]
    packed = tuple(torch.cat([p_[k] for p_ in parts]) for k in range(5)) + (eps,)
    require(torch.equal(ds.dominance_scan_groups(*packed), g_keep),
            "K1's packed groups form on the gathered bounds differs from the indexed form")
    out["K1g"] = k = {
        "T": T, "D": D, "D0": D0, "member_T": verdict_pairs(seen[1][1]),
        "ms": time_ms(ds.dominance_scan_groups_indexed, (segs, eps), 20, flush, spin=LONG_SPIN),
        "host_ms": host_ms(ds.dominance_scan_groups_indexed, (segs, eps)),
        "prof_ms": profiled_ms(ds.dominance_scan_groups_indexed, (segs, eps),
                               "dominance_scan_indexed_kernel", flush)[0],
        "plain_ms": time_ms(dominance_scan_groups_indexed_ref, (segs, eps), 10, flush,
                            spin=LONG_SPIN),
        "route_ms": time_ms(replaced_route, (segs, eps, True), 10, flush, spin=LONG_SPIN),
        "route_host_ms": host_ms(replaced_route, (segs, eps, True)),
        "bound": k1_indexed_bound_ms(segs, groups=True),
        "packed_ms": time_ms(ds.dominance_scan_groups, packed, 50, flush),
        "packed_prof_ms": profiled_ms(ds.dominance_scan_groups, packed,
                                      "dominance_scan_packed_kernel", flush)[0],
        "packed_plain_ms": time_ms(dominance_scan_groups_ref, packed, 20, flush),
        "packed_bound": k1_groups_bound_ms(T, D, D0),
    }
    del parts, packed
    msegs = seen[1][1][0]
    k["member_ms"] = time_ms(ds.dominance_scan_pairs_indexed, seen[1][1], 20, flush,
                             spin=LONG_SPIN)
    k["member_bound"] = k1_indexed_bound_ms(msegs)
    log(f"  K1 at both levels equal to the plain versions, one launch each; indexed groups at "
        f"T={T} ({lay.n_seg} segments, widths {lay.width} x {lay.tables}, {D0}): "
        f"{k['ms']:.6f} ms (events), {fmt_ms(k['prof_ms'])} (profiler); bound "
        f"{k['bound'][0]:.6f} ms ({k['bound'][1]}); plain version {k['plain_ms']:.6f} ms; the "
        f"route it replaced (gathers, cats, PR 20's five-launch groups form) "
        f"{k['route_ms']:.6f} ms; host enqueue {k['host_ms']:.6f} ms a call, the route's "
        f"{k['route_host_ms']:.6f}")
    log(f"  K1 packed groups on the same pairs gathered, T={T} (D={D}, D0={D0}, one launch): "
        f"{k['packed_ms']:.6f} ms (events), {fmt_ms(k['packed_prof_ms'])} (profiler, kernel "
        f"alone); bound {k['packed_bound'][0]:.6f} ms ({k['packed_bound'][1]}); plain version "
        f"{k['packed_plain_ms']:.6f} ms")
    log(f"  K1 indexed pairs at the member level, T = {k['member_T']}: {k['member_ms']:.6f} ms "
        f"(events), bound {k['member_bound'][0]:.6f} ms ({k['member_bound'][1]})")
    probe = eng.stacked_probe()
    for impl, join in (("loop", "device"), ("stacked", "numpy"), ("stacked", "device")):
        expansions = probe.host_expansions
        run(eng, f"grouped, {impl} probe, {'host' if join == 'numpy' else 'device'} join",
            probe_impl=impl, join_impl=join)
        if join == "device" and impl == "stacked":
            require(probe.host_expansions == expansions, "the grouped hand-off split rows")
    for impl in ("loop", "stacked"):
        gw, pw = [], []
        for _ in range(3):
            gw += warm_ms(lambda: eng.match_many(queries, probe_impl=impl), dev, 1)
            pw += warm_ms(lambda: eng.match_many(queries, index_kind="path", probe_impl=impl),
                          dev, 1)
        log(f"  warm match_many, {impl} probe, host join, interleaved: grouped {fmt(gw)} ms, "
            f"path {fmt(pw)} ms")
    for impl in ("loop", "stacked"):
        profiled_match(lambda: eng.match_many(queries, return_stats=True, probe_impl=impl), dev,
                       f"50K cell grouped, host join, {impl} probe")
    # auto sizes: each partition's pick equals the CPU's on the same index
    eng_a, build_s = build(index_kind="grouped", group_size_mode="auto")
    sizes = eng_a.offline_stats["group_sizes"]
    cpu_sizes = [choose_group_size(cpu_index(m.index)) for m in eng_a.models]
    require(sizes == cpu_sizes, "the auto group sizes differ from the CPU's choose_group_size")
    log(f"auto-size engine: build {build_s:.3f} s; sizes 8 / 16 / 32 on "
        f"{sizes.count(8)} / {sizes.count(16)} / {sizes.count(32)} partitions, equal to the "
        f"CPU's choose_group_size; {eng_a.offline_stats['n_groups']} groups")
    run(eng_a, "auto sizes, loop probe, host join")
    run(eng_a, "auto sizes, stacked probe, device join (the hand-off)", probe_impl="stacked",
        join_impl="device")
    # the grouped dr cost model: surviving groups weigh the plan paths
    eng_d, build_s = build(index_kind="grouped", group_size=16, plan_weight="dr")
    log(f"grouped dr engine: build {build_s:.3f} s")
    run(eng_d, "cold dr batch, grouped, loop probe (every candidate plan path probed)")
    hits = sum(eng_d._dr_plan_peek(q, 16) is not None for q in queries)
    require(hits == len(queries), f"the grouped dr plans were not cached ({hits})")
    run(eng_d, f"warm dr batch, grouped, loop probe ({hits} plans from the cache)")
    eng_d._plan_cache.clear()
    run(eng_d, "cold dr batch, grouped, stacked probe, device join (dr weights from the "
        "hand-off's stats)", probe_impl="stacked", join_impl="device")
    out["eng"] = eng  # phase 9 traces it
    return out


# ---- phase 4 ----------------------------------------------------------------


def phase4_gat(dev):
    from repro_torch.core import GnnPeConfig, GnnPeEngine, TrainConfig
    from repro_torch.graphs import newman_watts_strogatz, random_connected_query

    g2 = newman_watts_strogatz(2_000, k=4, p=0.1, n_labels=100, seed=11)
    # 60 epochs (cut from 150 to make room for phase 15: the GAT path's exactness and K1 hold
    # at any depth of training, the fallback vertices cover what it leaves)
    cfg2 = GnnPeConfig(n_partitions=2, encoder="gat", train=TrainConfig(max_epochs=60))
    reset_counters()
    eng2 = GnnPeEngine(cfg2).build(g2)
    queries2 = [random_connected_query(g2, 6, seed=7 + s) for s in range(4)]
    check_against_vf2(g2, queries2, eng2.match_many(queries2), "gat")
    require(counters()["K1"] > 0, "the GAT engine's match_many never launched the K1 kernel")
    log(f"gat: epochs {[m.train_epochs for m in eng2.models]}, "
        f"fallback vertices {[m.n_fallback for m in eng2.models]}, "
        f"train {eng2.offline_stats['train_time']:.3f} s")
    return eng2, queries2


# ---- phase 5 ----------------------------------------------------------------


def phase5_join_heavy(dev, flush, n: int = 12_000, n_parts: int = 12) -> dict:
    from repro_torch.core import GnnPeEngine, sort_matches
    from repro_torch.kernels.merge_join import ops as mj
    from repro_torch.kernels.merge_join.ref import injectivity_mask_ref

    out: dict = {}
    g, queries, cfg = join_heavy_inputs(n, n_parts)
    t_build = time.perf_counter()
    eng = GnnPeEngine(cfg).build(g)
    log(f"join-heavy build: {time.perf_counter() - t_build:.3f} s, "
        f"{eng.offline_stats['n_paths']} paths, {g.n_edges} edges")
    reset_counters()
    t_cold = time.perf_counter()
    dev_matches = eng.match_many(queries, join_impl="device")
    sync(dev)
    cold_s = time.perf_counter() - t_cold
    out["K2"] = counters()["K2"]
    require(out["K2"] > 0, "the join-heavy device join never launched the K2 kernel")
    require(mj.CONTIGUOUS_LAUNCHES == out["K2"],
            f"only {mj.CONTIGUOUS_LAUNCHES} of the join-heavy batch's {out['K2']} K2 launches "
            "took the contiguous layout")
    host_matches = eng.match_many(queries)
    for qi, (a, b) in enumerate(zip(dev_matches, host_matches)):
        require(sort_matches(a) == sort_matches(b), f"join-heavy query {qi}: joins differ")
    t_vf2 = time.perf_counter()
    n_matches = check_against_vf2(g, queries, dev_matches, "join-heavy")
    log(f"join-heavy: {n_matches} matches, device join = host join = VF2 for all "
        f"{len(queries)} queries (VF2 {time.perf_counter() - t_vf2:.3f} s); "
        f"K2 LAUNCHES {out['K2']}, all on the contiguous layout; cold device match_many "
        f"{cold_s * 1e3:.3f} ms")
    seen = k2_steps(eng, queries)
    old, new, _ = max(seen, key=lambda st: st[0].shape[0])
    T, Co, Cn = old.shape[0], old.shape[1], new.shape[1]
    log(f"K2 on {len(seen)} real join steps: equal to the plain version; steps (T, Co, Cn): "
        + ", ".join(f"({o.shape[0]}, {o.shape[1]}, {w.shape[1]})" for o, w, _ in seen))
    table, ops = k2_table(old, new)
    out["K2_bound"] = k2_bound_ms(T, Co, Cn)
    readings = k2_readings(mj.injectivity_mask, table, ops, 50, flush)
    out["K2_ms"] = readings["dirty"]
    out["K2_plain_ms"] = time_ms(injectivity_mask_ref, ops, 20, flush)
    profiled, listed = profiled_ms(mj.injectivity_mask, ops, "injectivity_mask", flush)
    log(f"K2 at the largest step T={T}, Co={Co}, Cn={Cn}, bound {out['K2_bound'][0]:.6f} ms "
        f"({out['K2_bound'][1]}): L2 flushed by a write, by a read, operands just rewritten: "
        f"{fmt_readings(readings, out['K2_bound'][0])}; kernel duration under torch.profiler "
        f"(read flush) {profiled:.6f} ms over the {listed} of 20 launches it listed; plain "
        f"version {out['K2_plain_ms']:.6f} ms")
    dev_warm, host_warm = [], []
    for _ in range(2):
        dev_warm += warm_ms(lambda: eng.match_many(queries, join_impl="device"), dev, 1)
        host_warm += warm_ms(lambda: eng.match_many(queries), dev, 1)
    log(f"join-heavy warm match_many: device join {fmt(dev_warm)} ms; host join "
        f"{fmt(host_warm)} ms (interleaved)")
    device_join_breakdown(eng, queries, dev, "join-heavy")
    # the stacked probe's hand-off to the device join
    probe = eng.stacked_probe()
    expansions = probe.host_expansions
    reset_counters()
    ho = eng.match_many(queries, probe_impl="stacked", join_impl="device")
    out["K2_stacked"] = counters()["K2"]
    require(out["K2_stacked"] > 0 and mj.CONTIGUOUS_LAUNCHES == out["K2_stacked"],
            "the join-heavy hand-off never launched K2, or off the contiguous layout")
    require(probe.host_expansions == expansions, "the join-heavy hand-off split rows on the host")
    for qi, (a, b) in enumerate(zip(ho, dev_matches)):
        require(sort_matches(a) == sort_matches(b), f"join-heavy hand-off query {qi} differs")
    check_against_vf2(g, queries, ho, "join-heavy hand-off")
    steps = k2_steps(eng, queries, probe_impl="stacked")
    ho_warm, dev_warm = [], []
    for _ in range(2):
        ho_warm += warm_ms(
            lambda: eng.match_many(queries, probe_impl="stacked", join_impl="device"), dev, 1)
        dev_warm += warm_ms(lambda: eng.match_many(queries, join_impl="device"), dev, 1)
    log(f"join-heavy, stacked probe's hand-off to the device join: lists = the loop probe's "
        f"sets = VF2's; K2 launches {out['K2_stacked']}, all contiguous, equal to the plain "
        f"version on its {len(steps)} real steps; host expansions unchanged; warm, "
        f"interleaved: hand-off {fmt(ho_warm)} ms, loop probe's device join {fmt(dev_warm)} ms")
    device_join_breakdown(eng, queries, dev, "join-heavy, stacked probe's hand-off",
                          probe_impl="stacked")
    return out


# ---- phase 6 ----------------------------------------------------------------


def step_breakdown(step, args, what: str, wall_ms: float, kernels: list, rest: str,
                   reps: int = 5) -> dict:
    """Device ms of one warm step, split into the kernels' calls and the
    rest by CUDA events around each call of ``kernels`` ((label, module,
    function name) triples), with the card held busy by a long spin while
    the host enqueues the whole step (so the events see device time only,
    as long as the step's launches fit in the launch queue: not so for
    the some 2,000 of an LM decode step, timed by ``top_kernels``);
    the idle share is that device time against the warm wall ms.
    (``torch.profiler`` listed only some of a DCN-v2 step's kernels on the
    card, so events time it.)  → {"step": ms, label: ms, ...}."""
    import torch

    marks: list = []
    originals = [getattr(mod, name) for _, mod, name in kernels]

    def timed(key, fn):
        def run(*a, **kw):
            s_, e_ = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s_.record()
            res = fn(*a, **kw)
            e_.record()
            marks.append((key, s_, e_))
            return res
        return run

    spent = {"step": 0.0, **{label: 0.0 for label, _, _ in kernels}}
    for (label, mod, name), fn in zip(kernels, originals):
        setattr(mod, name, timed(label, fn))
    try:
        for _ in range(reps):
            marks.clear()
            torch.cuda._sleep(SPIN_CYCLES * 20)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            step(*args)
            end.record()
            end.synchronize()
            spent["step"] += start.elapsed_time(end) / reps
            for key, s_, e_ in marks:
                spent[key] += s_.elapsed_time(e_) / reps
    finally:
        for (_, mod, name), fn in zip(kernels, originals):
            setattr(mod, name, fn)
    other = spent["step"] - sum(spent[label] for label, _, _ in kernels)
    parts = " + ".join([f"{label} {spent[label]:.3f}" for label, _, _ in kernels]
                       + [f"{rest} {other:.3f}"])
    log(f"{what}, device time of a warm step (CUDA events, host enqueue hidden): "
        f"{spent['step']:.3f} ms = {parts}; against the "
        f"warm wall median {wall_ms:.3f} ms the card is "
        f"{100 * (1 - spent['step'] / wall_ms):.1f} % idle")
    return spent


def top_kernels(fn, dev, what: str, wall_ms: float, n: int = 8, cpu_ops: bool = True) -> None:
    """The kernels of one call of ``fn`` under ``torch.profiler``, by device
    time: their count and sum against the warm wall ms (the idle share),
    and the ``n`` largest.  ``cpu_ops=False`` records the device alone (a
    call of tens of thousands of launches then costs seconds, not tens)."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CUDA]
    if cpu_ops:
        acts.insert(0, torch.profiler.ProfilerActivity.CPU)
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        sync(dev)
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    log(f"{what} under the profiler: {sum(e.count for e in kernels)} kernel launches, "
        f"{busy:.3f} ms of kernel time; against the warm wall median {wall_ms:.3f} ms the card is "
        f"{100 * (1 - busy / wall_ms):.1f} % idle")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:n]:
        log(f"  device {e.self_device_time_total / 1e3:.3f} ms x{e.count}: {e.key[:90]}")


def dcn_edge_checks(dev) -> tuple[float, float]:
    """K4 and K5 against their plain versions on seeded edge shapes → max |err|."""
    import torch

    from repro_torch.kernels.cross_interact import ops as ci
    from repro_torch.kernels.cross_interact.ref import cross_interact_ref, make_cross
    from repro_torch.kernels.star_agg import ops as sa
    from repro_torch.kernels.star_agg.ref import make_bags, star_agg_ref

    err4 = err5 = 0.0
    for N, K, V, E in ((1, 1, 7, 16), (4099, 1, 1000, 16), (1, 8, 50, 16), (4099, 8, 1000, 16),
                       (777, 3, 50, 6)):
        idx, mask, table = (torch.from_numpy(a).to(dev) for a in make_bags(N, K, V, E, seed=N + K))
        if K == 1:  # single-hot: every slot set, a bit-equal row copy
            mask = torch.ones_like(mask)
            idx = torch.randint(0, V, (N, 1), dtype=torch.int32, device=dev,
                                generator=torch.Generator(device=dev).manual_seed(N))
        got = sa.star_agg(idx, mask, table)
        want = star_agg_ref(idx, mask, table)
        sync(dev)
        if K == 1:
            require(torch.equal(got, want), f"K4 single-hot at N={N} differs from its plain version")
        else:
            require(bool((got[0] == 0).all()), f"K4 all-masked row at N={N}, K={K} is not 0")
            require(torch.allclose(got, want, rtol=1e-5, atol=1e-5),
                    f"K4 at N={N}, K={K}, E={E} differs from its plain version")
        err4 = max(err4, float((got - want).abs().max()))
    log("K4 edge shapes (N, K, V, E) (1, 1, 7, 16), (4099, 1, 1000, 16) bit-equal; (1, 8, 50, 16), "
        "(4099, 8, 1000, 16), (777, 3, 50, 6) with masked -1 / out-of-range ids and an "
        f"all-masked row within 1e-5: max |err| {err4:.3g}")
    worst5 = 0.0
    # B across the 128-row tile, D across the 216-column tile and the 32-wide k slice;
    # then non-negative operands (no output cancels) scaled so that rtol governs, and small:
    # these check the scaling path, not the precision (one tf32 pass would pass them too)
    for B, D, scale in ((1, 429, None), (513, 429, None), (1000, 130, None), (7, 1, None),
                        (63, 429, None), (64, 429, None), (65, 429, None), (129, 429, None),
                        (4099, 429, None), (513, 7, None), (513, 8, None), (513, 432, None),
                        (513, 429, 1e3), (513, 429, 1e-3)):
        arrs = make_cross(B, D, seed=B + D)
        if scale is not None:
            arrs = [np.abs(a) * np.float32(scale) for a in arrs]
        x0, x, w, b = (torch.from_numpy(a).to(dev) for a in arrs)
        got = ci.cross_interact(x0, x, w, b)
        want = cross_interact_ref(x0, x, w, b)
        sync(dev)
        err, worst = k5_close(got, want, f"K5 at B={B}, D={D}, scale {scale}")
        worst5 = max(worst5, worst)
        if scale is None:  # the record's max |err| is at the operands' own scale
            err5 = max(err5, err)
    log("K5 edge shapes (B, D) (1, 429), (513, 429), (1000, 130), (7, 1), B in 63, 64, 65, 129, "
        "4099 at D = 429, D in 7, 8, 432 at B = 513, and |operands| x 1e3 and x 1e-3 at (513, "
        f"429) within rtol = atol = 1e-4: max |err| {err5:.3g} (unscaled), worst |err| / limit "
        f"{worst5:.3g}")
    return err4, err5


def k5_close(got, want, what: str, reject: bool = False) -> tuple[float, float]:
    """K5's check, rtol = atol = 1e-4 against the plain version → (max |err|,
    worst |err| / (1e-4 + 1e-4 |want|)); fails if ``got`` is outside it, or,
    with ``reject``, inside it."""
    import torch

    err = (got - want).abs()
    res = float(err.max()), float((err / (1e-4 + 1e-4 * want.abs())).max())
    inside = bool(torch.allclose(got, want, rtol=1e-4, atol=1e-4))
    if reject:
        require(not inside, f"control {what}: passes the K5 tolerance (max |err| {res[0]:.3g}, "
                f"worst |err| / limit {res[1]:.3g})")
    else:
        require(inside, f"{what} differs from its plain version: max |err| {res[0]:.3g}, "
                f"worst |err| / limit {res[1]:.3g}")
    return res


def k5_controls(dev, x0, x, w, b, got) -> None:
    """What the K5 check tells apart, on the first cross layer of serve_bulk
    (``got`` is K5's result there): W's last 5 rows zeroed must fail it; one
    TF32 pass (cuBLAS with TF32 allowed for that one call) must fail it on
    seeded operands of the same shape, and on the real ones be at least 10x
    further from the plain version than K5 is."""
    import torch

    from repro_torch.kernels.cross_interact import ops as ci
    from repro_torch.kernels.cross_interact.ref import cross_interact_ref, make_cross

    def one_pass(x0, x, w, b):
        before = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            res = x0 * torch.addmm(b, x, w) + x
            sync(dev)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = before
        return res

    def reading(got, want):  # (max |err|, worst |err| / limit), whichever side it falls
        err = (got - want).abs()
        return float(err.max()), float((err / (1e-4 + 1e-4 * want.abs())).max())

    want = cross_interact_ref(x0, x, w, b)
    mine = k5_close(got, want, "K5 on the first cross layer of serve_bulk")
    wz = w.clone()
    wz[-5:] = 0
    zero = k5_close(cross_interact_ref(x0, x, wz, b), want, "W's last 5 rows zeroed", reject=True)
    tf32 = reading(one_pass(x0, x, w, b), want)
    require(tf32[1] >= 10 * mine[1], f"K5 on the real operands (worst |err| / limit "
            f"{mine[1]:.3g}) is not 10x closer than one TF32 pass ({tf32[1]:.3g})")
    B, D = x.shape
    s0, s, sw, sb = (torch.from_numpy(a).to(dev) for a in make_cross(B, D, seed=5))
    s_want = cross_interact_ref(s0, s, sw, sb)
    seeded = k5_close(one_pass(s0, s, sw, sb), s_want, "one TF32 pass on seeded operands",
                      reject=True)
    s_mine = k5_close(ci.cross_interact(s0, s, sw, sb), s_want, "K5 on seeded operands")
    log(f"K5 controls on serve_bulk's first cross layer (B = {B}, D = {D}), max |err| and worst "
        f"|err| / limit: K5 {mine[0]:.3g}, {mine[1]:.3g}; W's last 5 rows zeroed rejected "
        f"({zero[0]:.3g}, {zero[1]:.3g}); one TF32 pass {tf32[0]:.3g}, {tf32[1]:.3g} "
        f"({'rejected' if tf32[1] > 1 else 'inside the tolerance'}; x0 holds embeddings of "
        f"scale 0.02), {tf32[1] / max(mine[1], 1e-30):.1f}x K5's. On seeded operands of the "
        f"same shape: one TF32 pass rejected ({seeded[0]:.3g}, {seeded[1]:.3g}), K5 "
        f"{s_mine[0]:.3g}, {s_mine[1]:.3g}")


def k5_ptxas_report() -> None:
    """ptxas's registers, spills and notes for K5's two kernels (from this run's
    build); fails on a spill or on wgmma instructions that ptxas had to
    serialise (note C7512)."""
    import re

    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels.cross_interact.kernel import smem_bytes

    text = kbuild.BUILD_LOG.get("cross_interact")
    require(text is not None, "K5 was not built in this run: no ptxas report")
    rep: dict = {}
    cur = None
    for line in text.splitlines():
        m = re.search(r"(cross_kernel|prep_kernel)", line)
        if m and "Compiling entry function" in line:
            cur = m.group(1)
            rep.setdefault(cur, {"notes": []})
        elif m and "(C75" in line:
            rep.setdefault(m.group(1), {"notes": []})["notes"].append(
                re.search(r"\((C75\d+)\)", line).group(1))
        elif cur is not None and "spill stores" in line:
            rep[cur]["stack"], rep[cur]["stores"], rep[cur]["loads"] = map(
                int, re.findall(r"(\d+) bytes", line)[:3])
        elif cur is not None and re.search(r"Used \d+ registers", line):
            rep[cur]["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
    require(sorted(rep) == ["cross_kernel", "prep_kernel"], f"K5 ptxas report names {sorted(rep)}")
    for name in sorted(rep):
        r = rep[name]
        extra = (f" (setmaxnreg then gives the producer 24, the consumers 240), dynamic shared "
                 f"memory {smem_bytes()} bytes" if name == "cross_kernel" else "")
        log(f"K5 ptxas, {name}: {r['registers']} registers a thread at launch{extra}, spill "
            f"stores {r['stores']} bytes, spill loads {r['loads']} bytes, stack {r['stack']} "
            f"bytes; notes: {', '.join(sorted(set(r['notes']))) or 'none'}")
        require(r["stores"] == 0 and r["loads"] == 0,
                f"K5 {name} spills ({r['stores']} / {r['loads']} bytes)")
        require("C7512" not in r["notes"], f"K5 {name}: ptxas serialised the wgmma (C7512)")


def phase6_dcn_serving(dev, flush) -> dict:
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import build_step, get_arch, init_params, make_batch, resolve_config
    from repro_torch.kernels.cross_interact import ops as ci
    from repro_torch.kernels.cross_interact.kernel import kpad, launch_prep
    from repro_torch.kernels.cross_interact.ref import cross_interact_ref
    from repro_torch.kernels.star_agg import ops as sa
    from repro_torch.kernels.star_agg.ref import star_agg_ref
    from repro_torch.models import dcn_forward

    k5_ptxas_report()
    out: dict = {"K4": 0, "K5": 0}
    out["K4_err"], out["K5_err"] = dcn_edge_checks(dev)
    arch = get_arch("dcn-v2")
    cfg = resolve_config(arch, arch.cell("serve_p99"), smoke=False)
    torch.cuda.reset_peak_memory_stats(dev)
    t = time.perf_counter()
    params = init_params(arch, cfg, seed=0, device=dev)
    sync(dev)
    leaves = [params["tables"], params["head"], params["retrieval_proj"]] + [
        t_ for layer in params["cross"] + params["mlp"] for t_ in layer.values()
    ]
    log(f"dcn-v2 params: {sum(x.numel() for x in leaves)} floats on the card, "
        f"init {time.perf_counter() - t:.3f} s")
    cpu_params = {
        k: [{n: x.cpu() for n, x in d.items()} for d in v] if isinstance(v, list) else v.cpu()
        for k, v in params.items()
    }
    star_agg, cross = sa.star_agg, ci.cross_interact
    for name, seed in (("serve_p99", 1), ("serve_bulk", 2), ("retrieval_cand", 3)):
        cell = arch.cell(name)
        t = time.perf_counter()
        batch = make_batch(arch, cell, cfg, seed=seed, smoke=False, device=dev)
        step, _ = build_step(arch, cell, cfg)
        log(f"{name}: batch {', '.join(f'{k} {tuple(v.shape)}' for k, v in batch.items())} "
            f"made in {time.perf_counter() - t:.3f} s")
        seen: dict = {"K4": [], "K5": []}

        def rec4(*a):
            res = star_agg(*a)
            seen["K4"].append((a, res))
            return res

        def rec5(*a):
            res = cross(*a)
            seen["K5"].append((a, res))
            return res

        sa.star_agg, ci.cross_interact = rec4, rec5
        reset_counters()  # counts from here to the end of the cell's forward
        try:
            t = time.perf_counter()
            got = step(params, batch)
            sync(dev)
            cold_ms = (time.perf_counter() - t) * 1e3
        finally:
            sa.star_agg, ci.cross_interact = star_agg, cross
        launched = counters()
        require(launched["K4"] == 1 and len(seen["K4"]) == 1,
                f"{name}: K4 launched {launched['K4']} times in one forward, not once")
        require(launched["K5"] == cfg.n_cross_layers == len(seen["K5"]),
                f"{name}: K5 launched {launched['K5']} times in one forward, not "
                f"{cfg.n_cross_layers}")
        out["K4"] += launched["K4"]
        out["K5"] += launched["K5"]
        # the kernels on the forward's real operands against their plain versions
        (idx, mask, table), res4 = seen["K4"][0]
        require(torch.equal(res4, star_agg_ref(idx, mask, table)),
                f"{name}: K4 on the forward's operands differs from its plain version")
        worst5 = 0.0
        for k, (a, res5) in enumerate(seen["K5"]):
            err, worst = k5_close(res5, cross_interact_ref(*a), f"{name}: K5 call {k}")
            out["K5_err"], worst5 = max(out["K5_err"], err), max(worst5, worst)
        # end to end against the port's CPU run of the same params and batch
        rows = 4096 if name == "serve_bulk" else None
        cpu_batch = {k: v.cpu() if k == "cand_emb" else v[:rows].cpu() for k, v in batch.items()}
        want = step(cpu_params, cpu_batch)
        if cell.kind == "serve":
            mine = got[:rows].cpu()
            require(mine.shape == want.shape and bool(torch.isfinite(mine).all()),
                    f"{name}: logits of shape {tuple(mine.shape)} are not finite")
            require(torch.allclose(mine, want, rtol=1e-4, atol=1e-5),
                    f"{name}: the card's logits differ from the CPU's")
            log(f"{name}: K4 x{launched['K4']} (bit-equal to its plain version on the "
                f"forward's {idx.shape[0]} bags), K5 x{launched['K5']} (each within rtol = atol "
                f"= 1e-4 of plain, worst |err| / limit {worst5:.3g}; max |err| so far "
                f"{out['K5_err']:.3g}); logits of {mine.shape[0]} rows equal the CPU's within "
                f"rtol 1e-4 / atol 1e-5, max |diff| {float((mine - want).abs().max()):.3g}")
        else:
            vals, top = (x.cpu() for x in got)
            want_vals, want_top = want
            # every CPU score of the 1M candidates: the card's picks must carry the
            # CPU's top-100 scores rank by rank (ranks may swap only within a tie)
            _, user = dcn_forward(cpu_params, cpu_batch["dense"], cpu_batch["sparse"], cfg,
                                  return_emb=True)
            cpu_scores = (user @ cpu_batch["cand_emb"].T)[0]
            same = int((top[0] == want_top[0]).sum())
            require(torch.allclose(vals, want_vals, rtol=1e-4, atol=1e-5),
                    f"{name}: the card's top-100 scores differ from the CPU's")
            require(torch.allclose(cpu_scores[top[0]], want_vals[0], rtol=1e-4, atol=1e-5),
                    f"{name}: the card's top-100 candidates are not the CPU's")
            # a rank is distinct when the CPU's score there is apart from both
            # neighbours (the 101st included) by more than the tolerance; there
            # the card must pick the CPU's very candidate
            ref = cpu_scores.topk(101).values
            gap = ref[:-1] - ref[1:]
            tied = gap <= 1e-5 + 1e-4 * ref[1:].abs()
            distinct = ~tied
            distinct[1:] &= ~tied[:-1]
            require(torch.equal(top[0][distinct], want_top[0][distinct]),
                    f"{name}: the card's pick differs from the CPU's at a distinct rank")
            log(f"{name}: K4 x{launched['K4']}, K5 x{launched['K5']}; top-100 of "
                f"{batch['cand_emb'].shape[0]} candidates: scores equal the CPU's within rtol "
                f"1e-4 / atol 1e-5 (max |diff| {float((vals - want_vals).abs().max()):.3g}, "
                f"top score {float(want_vals[0, 0]):.6g}, 100th {float(want_vals[0, -1]):.6g}), "
                f"the CPU scores the card's picks as its own top-100, {same} of 100 ranks hold "
                f"the same candidate; {int(tied.sum())} of the 100 gaps below rank 100 are "
                f"within that tolerance (smallest {float(gap.min()):.3g}, median "
                f"{float(gap.median()):.3g}), so {int(distinct.sum())} ranks are distinct, and "
                f"the card picks the CPU's candidate at each of them")
        warm = warm_ms(lambda: step(params, batch), dev, runs=7)
        med = float(np.median(warm))
        B = batch["dense"].shape[0]
        out[f"{name}_ms"] = med
        log(f"{name}: cold step {cold_ms:.3f} ms; warm {fmt(warm)} ms, median {med:.3f} ms, "
            f"{B / med * 1e3:.1f} rows/s")
        step_breakdown(step, (params, batch), name, med,
                       [("K4 embedding bag", sa, "star_agg"),
                        ("K5 cross stack", ci, "cross_interact")],
                       "dense features, MLP, head and the rest")
        if name == "serve_bulk":
            N, K = idx.shape
            E = table.shape[1]
            out["K4_ms"] = time_ms(sa.star_agg, (idx, mask, table), 20, flush)
            out["K4_plain_ms"] = time_ms(star_agg_ref, (idx, mask, table), 10, flush)
            ids64, weights = idx.long(), mask.to(torch.float32)

            def bag(i, t_, w):
                return F.embedding_bag(i, t_, mode="sum", per_sample_weights=w)

            require(torch.allclose(bag(ids64, table, weights), res4),
                    "embedding_bag (the K4 yardstick) computes another function")
            out["K4_library_ms"] = time_ms(bag, (ids64, table, weights), 20, flush)
            out["K4_bound"] = k4_bound_ms(N, K, E, int(mask.sum()), int(mask.any(1).sum()))
            (x0, x, w, b), res5 = seen["K5"][0]
            k5_controls(dev, x0, x, w, b, res5)
            B5, D5 = x.shape
            out["K5_ms"] = time_ms(ci.cross_interact, (x0, x, w, b), 10, flush)
            wt = torch.empty((2, D5, kpad(D5)), dtype=torch.float32, device=dev)
            prep_ms = time_ms(launch_prep, (w, wt), 10, flush)
            out["K5_plain_ms"] = time_ms(cross_interact_ref, (x0, x, w, b), 10, flush)
            out["K5_library_ms"] = time_ms(torch.addmm, (b, x, w), 10, flush)
            out["K5_bound"] = k5_bound_ms(B5, D5)
            simt = k5_simt_bound_ms(B5, D5)
            log(f"K4 at N={N}, K={K}, E={E} (serve_bulk): {out['K4_ms']:.6f} ms, bound "
                f"{out['K4_bound'][0]:.6f} ms ({out['K4_bound'][1]}), plain version "
                f"{out['K4_plain_ms']:.6f} ms, F.embedding_bag {out['K4_library_ms']:.6f} ms")
            log(f"K5 at B={B5}, D={D5} (serve_bulk): {out['K5_ms']:.6f} ms "
                f"({2 * B5 * D5 * D5 / out['K5_ms'] / 1e9:.1f} TFLOP/s of float32-accurate "
                f"work), {out['K5_ms'] / out['K5_bound'][0]:.3f}x its bound "
                f"{out['K5_bound'][0]:.6f} ms ({out['K5_bound'][1]} at 495 / 3 TFLOP/s; a SIMT "
                f"design's bound {simt[0]:.6f} ms, {simt[1]} at 67 TFLOP/s); the prep kernel "
                f"{prep_ms:.6f} ms of it ({100 * prep_ms / out['K5_ms']:.2f} %); plain version "
                f"{out['K5_plain_ms']:.6f} ms, torch.addmm (GEMM and bias only) "
                f"{out['K5_library_ms']:.6f} ms")
        del seen, got, want, batch
    log(f"dcn-v2 peak device memory: {torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB")
    return out


# ---- phase 7 ----------------------------------------------------------------

# the card against the CPU through 26 bf16 layers (elementwise, and the relative L2 norm
# of the difference): every op rounds to bf16, in another order on each side
LM_TOL = dict(rtol=0.05, atol=0.25)
LM_REL_L2 = 0.05


def k6_check(got, q, k, v, causal=True, window=None, chunk=1024, what="K6") -> dict:
    """K6's output against its plain version on the same operands, within
    ``ref.k6_agreement``'s tolerance (per element 2^-7 · (|want| + the
    attention over |v|), relative L2 5e-3) → its readings; fails beyond it."""
    from repro_torch.kernels.flash_attention.ref import (
        attention_scale,
        flash_attention_plain,
        k6_agreement,
    )

    sync(got.device)
    res = k6_agreement(got, flash_attention_plain(q, k, v, causal, window, chunk),
                       attention_scale(q, k, v, causal, window, chunk))
    require(res["ok"], f"{what} differs from its plain version: max |err| "
            f"{res['max_abs_err']:.3g}, worst |err| / limit {res['worst']:.3g}, relative L2 "
            f"{res['rel_l2']:.3g} (limit 5e-3), rms of the plain output {res['rms']:.3g}")
    return res


def k6_control(got, wrong, q, k, v, causal, window, what: str) -> dict:
    """A planted fault: ``wrong`` is the plain version with a fault, which
    must fail the tolerance against K6's ``got`` → the readings."""
    from repro_torch.kernels.flash_attention.ref import (
        attention_scale,
        flash_attention_plain,
        k6_agreement,
    )

    sync(got.device)
    scale = attention_scale(q, k, v, causal, window)
    res = k6_agreement(got, wrong, scale)
    require(not res["ok"], f"control {what}: a faulty plain version passed the K6 tolerance "
            f"(worst {res['worst']:.3g}, relative L2 {res['rel_l2']:.3g})")
    ok = k6_agreement(got, flash_attention_plain(q, k, v, causal, window), scale)
    require(ok["ok"], f"control {what}: K6 fails against the faultless plain version")
    log(f"K6 control, {what}: rejected (worst |err| / limit {res['worst']:.3g}, relative L2 "
        f"{res['rel_l2']:.3g}, max |err| {res['max_abs_err']:.3g}; the faultless plain version "
        f"{ok['worst']:.3g}, {ok['rel_l2']:.3g})")
    return res


def lm_close(got, want, what: str) -> tuple[float, float]:
    """``got`` (the card's) against ``want`` (the CPU's), both on the host →
    (max |diff|, relative L2 of the difference); fails beyond LM_TOL / LM_REL_L2."""
    import torch

    g, w = got.float(), want.float()
    require(g.shape == w.shape and bool(torch.isfinite(g).all()), f"{what}: not finite")
    mx = float((g - w).abs().max())
    rel = float((g - w).norm() / w.norm())
    require(torch.allclose(g, w, **LM_TOL) and rel <= LM_REL_L2,
            f"{what}: the card differs from the CPU, max |diff| {mx:.4g}, relative L2 {rel:.4g}")
    return mx, rel


def k6_ptxas_report() -> None:
    """ptxas's registers, spills and notes for each instantiation of K6 (from
    this run's build), beside its dynamic shared memory; fails on a spill or
    on wgmma instructions that ptxas had to serialise (note C7512)."""
    import re

    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels.flash_attention.kernel import smem_bytes

    text = kbuild.BUILD_LOG.get("flash_attention")
    require(text is not None, "K6 was not built in this run: no ptxas report")
    rep: dict = {}
    cur = None
    for line in text.splitlines():
        m = re.search(r"flash_fwd_kernelILi(\d+)E", line)
        if m and "Compiling entry function" in line:
            cur = int(m.group(1))
            rep.setdefault(cur, {"notes": []})
        elif m and "(C75" in line:
            rep.setdefault(int(m.group(1)), {"notes": []})["notes"].append(
                re.search(r"\((C75\d+)\)", line).group(1))
        elif cur is not None and "spill stores" in line:
            rep[cur]["stack"], rep[cur]["stores"], rep[cur]["loads"] = map(
                int, re.findall(r"(\d+) bytes", line)[:3])
        elif cur is not None and re.search(r"Used \d+ registers", line):
            rep[cur]["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
    require(sorted(rep) == [64, 128, 256], f"K6 ptxas report names instantiations {sorted(rep)}")
    for dhp in sorted(rep):
        r = rep[dhp]
        log(f"K6 ptxas, instantiation for dh <= {dhp}: {r['registers']} registers a thread at "
            f"launch (setmaxnreg then gives the producer 24, the consumers 240), spill stores "
            f"{r['stores']} bytes, spill loads {r['loads']} bytes, stack {r['stack']} bytes, "
            f"dynamic shared memory {smem_bytes(dhp)} bytes; notes: "
            f"{', '.join(sorted(set(r['notes']))) or 'none'}")
        require(r["stores"] == 0 and r["loads"] == 0,
                f"K6 at dh <= {dhp} spills ({r['stores']} / {r['loads']} bytes)")
        require("C7512" not in r["notes"],
                f"K6 at dh <= {dhp}: ptxas serialised the wgmma instructions (C7512)")


def k6_edge_checks(dev) -> float:
    """K6 against its plain version on seeded edge shapes → max |err|; one
    planted fault (the padded keys of the last plain chunk counted as keys)
    must fail the same check."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain, make_attn

    err, worst, rel, n = 0.0, 0.0, 0.0, 0
    # S at the edges of a block's 128 query rows and of the 64- and 128-key tiles
    for S in (1, 63, 64, 65, 127, 128, 129, 1000, 4096):
        for dh in (64, 80, 128, 256):
            for G in (1, 4):
                q, k, v = (torch.from_numpy(a).to(dev, torch.bfloat16)
                           for a in make_attn(2, S, 2 * G, 2, dh, seed=S + dh + G))
                # window 40: shorter than one KV tile
                for causal, window in ((True, None), (True, 512), (True, S + 7), (True, 40),
                                       (False, None), (False, 100)):
                    got = fa.flash_attention(q, k, v, causal=causal, window=window)
                    res = k6_check(got, q, k, v, causal, window, what=f"K6 at S={S}, dh={dh}, "
                                   f"G={G}, causal={causal}, window={window}")
                    err, worst = max(err, res["max_abs_err"]), max(worst, res["worst"])
                    rel, n = max(rel, res["rel_l2"]), n + 1
                    if (S, dh, G, causal, window) == (1000, 256, 4, False, None):
                        pad = [F.pad(t, (0, 0, 0, 0, 0, 24)) for t in (q, k, v)]
                        k6_control(got, flash_attention_plain(*pad, causal=False)[:, :S], q, k, v,
                                   False, None, "the 24 padded keys of the last chunk counted "
                                   "(S = 1000, dh = 256, G = 4, non-causal)")
    # strided operands: q, k and v as head slices of one fused projection
    qkv = torch.randn((2, 777, 8, 128), device=dev,
                      generator=torch.Generator(device=dev).manual_seed(0)).to(torch.bfloat16)
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:]
    res = k6_check(fa.flash_attention(q, k, v, window=300), q, k, v, window=300,
                   what="K6 on strided head slices")
    err, worst, rel = max(err, res["max_abs_err"]), max(worst, res["worst"]), max(rel, res["rel_l2"])
    # the LM family's shapes: G = 3, 12 and 16 at dh = 128 (minitron, command-r, qwen3), and
    # MLA's q and k of 192 with a v of 128, which the wrapper pads to 192 (deepseek)
    m = 0
    for S in (1, 65, 129, 1000, 4096):
        for Hq, Hkv, dh, dv in ((6, 2, 128, 128), (24, 2, 128, 128), (32, 2, 128, 128),
                                (4, 4, 192, 128)):
            g = torch.Generator(device=dev).manual_seed(S + Hq + dh)
            q, k = (torch.randn((2, S, h, dh), generator=g, device=dev).to(torch.bfloat16)
                    for h in (Hq, Hkv))
            v = torch.randn((2, S, Hkv, dv), generator=g, device=dev).to(torch.bfloat16)
            for causal, window in ((True, None), (True, 40), (False, None)):
                got = fa.flash_attention(q, k, v, causal=causal, window=window)
                require(got.shape == (2, S, Hq, dv), f"K6 returned {tuple(got.shape)}")
                res = k6_check(got, q, k, v, causal, window, what=f"K6 at S={S}, Hq={Hq}, "
                               f"Hkv={Hkv}, dqk={dh}, dv={dv}, causal={causal}, window={window}")
                err, worst = max(err, res["max_abs_err"]), max(worst, res["worst"])
                rel, m = max(rel, res["rel_l2"]), m + 1
                if (S, causal, window) != (1000, True, None) or Hq not in (24, 4):
                    continue
                if dv < dh:  # the scores scaled by v's width, 1/sqrt(128), not q's 1/sqrt(192)
                    qs = (q.float() * math.sqrt(dh / dv)).to(torch.bfloat16)
                    k6_control(got, flash_attention_plain(qs, k, v), q, k, v, True, None,
                               "MLA scaled by 1/sqrt(dv) (S = 1000, dqk 192, dv 128)")
                else:  # query head h read KV head h % Hkv, not h // G
                    G = Hq // Hkv
                    qp = q.view(2, S, G, Hkv, dh).transpose(2, 3).reshape(2, S, Hq, dh)
                    wrong = flash_attention_plain(qp, k, v).view(2, S, Hkv, G, dv).transpose(
                        2, 3).reshape(2, S, Hq, dv)
                    k6_control(got, wrong, q, k, v, True, None,
                               "query head h on KV head h % Hkv (S = 1000, G = 12)")
    log(f"K6 at the LM family's shapes: {m} calls (S in 1, 65, 129, 1000, 4096; dh 128 with "
        f"G = 3, 12, 16; dqk 192 with dv 128 through the padding wrapper; causal with no window and "
        f"with window 40, non-causal) within the K6 tolerance")
    log(f"K6 edge shapes: {n + 1 + m} calls (S in 1, 63, 64, 65, 127, 128, 129, 1000, 4096; dh in "
        f"64, 80, 128, 256; G in 1, 4; causal with no window, window 512, window > S and window "
        f"40, non-causal with and without a window; strided head slices; the LM family's shapes) "
        f"within the K6 tolerance: "
        f"max |err| {err:.3g}, worst "
        f"|err| / limit {worst:.3g}, largest relative L2 {rel:.3g}")
    return err


def phase7_lm_serving(dev, flush) -> dict:
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import (
        build_step,
        get_arch,
        init_params,
        input_specs,
        make_batch,
        resolve_config,
    )
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import chunked_attention, flash_attention_plain
    from repro_torch.models import cast_params
    from repro_torch.serve import DecodeEngine, ServeConfig

    k6_ptxas_report()
    out: dict = {"K6_err": k6_edge_checks(dev)}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    arch = get_arch("gemma3-1b")
    cfg = resolve_config(arch, arch.cell("prefill_32k"), smoke=False)
    t = time.perf_counter()
    params = init_params(arch, cfg, seed=0, device=dev)
    sync(dev)
    tensors = [params["embed"], params["final_norm"]] + [
        x for layer in params["layers"] for x in layer.values()]
    log(f"gemma3-1b params: {sum(x.numel() for x in tensors)} (float32 from a seeded CUDA "
        f"generator, cast once to {cfg.dtype}), {time.perf_counter() - t:.3f} s")
    cpu_params = {"embed": params["embed"].cpu(), "final_norm": params["final_norm"].cpu(),
                  "layers": [{n: x.cpu() for n, x in layer.items()} for layer in params["layers"]]}

    # ---- prefill_32k, B cut to 2 --------------------------------------------
    cell = arch.cell("prefill_32k")
    full = make_batch(arch, cell, cfg, seed=1, smoke=False, device=dev)
    batch = {"tokens": full["tokens"][:2]}  # B = 32 would return 550 GB of logits
    B, S = batch["tokens"].shape
    step, _ = build_step(arch, cell, cfg)
    seen: list = []
    flash = fa.flash_attention

    def rec(q, k, v, causal=True, window=None, chunk=1024):
        res = flash(q, k, v, causal=causal, window=window, chunk=chunk)
        seen.append((q, k, v, window, res))
        return res

    fa.flash_attention = rec
    reset_counters()  # counts from here to the end of the forward
    try:
        t = time.perf_counter()
        logits = step(params, batch)
        sync(dev)
        cold_ms = (time.perf_counter() - t) * 1e3
    finally:
        fa.flash_attention = flash
    out["K6"] = counters()["K6"]
    require(out["K6"] == cfg.n_layers == len(seen),
            f"prefill_32k: K6 launched {out['K6']} times in one forward, not {cfg.n_layers}")
    require(logits.shape == (B, S, cfg.vocab) and logits.dtype == cfg.compute_dtype,
            f"prefill_32k: logits of shape {tuple(logits.shape)}, {logits.dtype}")
    require(all(bool(torch.isfinite(logits[b, i:i + 4096]).all())
                for b in range(B) for i in range(0, S, 4096)), "prefill_32k: logits not finite")
    del logits
    layer_res = []
    for li, (q, k, v, window, res) in enumerate(seen):
        kind = "global" if window is None else "local"
        layer_res.append(k6_check(res, q, k, v, window=window, chunk=cfg.kv_chunk,
                                  what=f"prefill_32k layer {li} ({kind})"))
    out["K6_err"] = max(out["K6_err"], *(r["max_abs_err"] for r in layer_res))
    log(f"prefill_32k (B = {B}, S = {S}): K6 x{out['K6']} in one forward, each equal to the plain "
        f"chunked_attention on its layer's real q, k, v within the K6 tolerance; logits finite")
    for key, what in (("max_abs_err", "max |err|"), ("worst", "worst |err| / limit"),
                      ("rel_l2", "relative L2"), ("rms", "rms of the plain output")):
        log(f"  by layer, {what}: {', '.join(f'{r[key]:.3g}' for r in layer_res)}")
    glob = next(i for i in range(cfg.n_layers) if cfg.is_global(i))
    gq, gk, gv, _, gres = seen[glob]
    lq, lk, lv, lw, lres = seen[0]
    seen.clear()
    # planted faults on the real operands, each of which the K6 check must reject
    k6_control(lres, flash_attention_plain(lq, lk, lv, window=lw + 1), lq, lk, lv, True, lw,
               f"window {lw + 1} for {lw} (local layer 0)")
    pos = torch.arange(S, dtype=torch.int32, device=dev)
    kv_pos = torch.where((pos >= 64) & (pos < 128), 2**30, pos)  # keys 64-127 never seen
    k6_control(gres, chunked_attention(
        gq.reshape(B, S, gk.shape[2], -1, gq.shape[3]), gk, gv, pos, kv_pos, None,
        cfg.kv_chunk).reshape(gq.shape), gq, gk, gv, True, None,
        f"one 64-key tile dropped (global layer {glob})")
    del pos, kv_pos
    warm = warm_ms(lambda: step(params, batch), dev, runs=3)
    med = float(np.median(warm))
    log(f"prefill_32k: cold step {cold_ms:.3f} ms; warm {fmt(warm)} ms, median {med:.3f} ms, "
        f"{B * S / med * 1e3:.1f} tokens/s")
    step_breakdown(step, (params, batch), "prefill_32k", med,
                   [("K6 attention", fa, "flash_attention")],
                   "embedding, norms, QKV and RoPE, wo, MLP, head and the rest", reps=2)

    # ---- K6 at the real shapes, beside its plain version and SDPA ------------
    Hq, Hkv, dh = gq.shape[2], gk.shape[2], gq.shape[3]

    def sdpa(q, k, v, mask=None):
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask,
            is_causal=mask is None, enable_gqa=True).transpose(1, 2)

    out["K6_ms"] = time_ms(lambda q, k, v: fa.flash_attention(q, k, v), (gq, gk, gv), 10, flush)
    out["K6_plain_ms"] = time_ms(flash_attention_plain, (gq, gk, gv), 2, flush)
    out["K6_bound"] = k6_bound_ms(B, S, Hq, Hkv, dh, None)
    k6_check(sdpa(gq, gk, gv), gq, gk, gv, what="SDPA (the K6 yardstick), global layer,")
    out["K6_library_ms"] = time_ms(sdpa, (gq, gk, gv), 10, flush)
    local_ms = time_ms(lambda q, k, v: fa.flash_attention(q, k, v, window=lw), (lq, lk, lv), 10,
                       flush)
    local_plain = time_ms(lambda q, k, v: flash_attention_plain(q, k, v, window=lw),
                          (lq, lk, lv), 2, flush)
    local_bound = k6_bound_ms(B, S, Hq, Hkv, dh, lw)
    try:  # the band mask is S x S bytes, and SDPA may widen it
        band = torch.ones((S, S), dtype=torch.bool, device=dev).tril_().triu_(-(lw - 1))
        k6_check(sdpa(lq, lk, lv, band), lq, lk, lv, window=lw,
                 what="SDPA (the K6 yardstick), local layer,")
        local_lib = f"{time_ms(sdpa, (lq, lk, lv, band), 3, flush):.6f} ms"
    except torch.OutOfMemoryError as e:
        local_lib = f"not measured: out of memory ({str(e).splitlines()[0]})"
    band = None
    tflops = k6_flops(B, S, Hq, dh, None) / out["K6_ms"] / 1e9
    log(f"K6 global layer (B={B}, S={S}, Hq={Hq}, Hkv={Hkv}, dh={dh}, causal): "
        f"{out['K6_ms']:.6f} ms, {tflops:.1f} TFLOP/s, {out['K6_ms'] / out['K6_bound'][0]:.3f}x "
        f"its bound {out['K6_bound'][0]:.6f} ms ({out['K6_bound'][1]}); plain version "
        f"{out['K6_plain_ms']:.6f} ms; SDPA (is_causal, enable_gqa) {out['K6_library_ms']:.6f} ms, "
        f"{k6_flops(B, S, Hq, dh, None) / out['K6_library_ms'] / 1e9:.1f} TFLOP/s")
    log(f"K6 local layer (window {lw}): {local_ms:.6f} ms, "
        f"{k6_flops(B, S, Hq, dh, lw) / local_ms / 1e9:.1f} TFLOP/s, "
        f"{local_ms / local_bound[0]:.3f}x its bound {local_bound[0]:.6f} ms ({local_bound[1]}); "
        f"plain version {local_plain:.6f} ms; SDPA with the boolean band mask {local_lib}")
    # the same shape on seeded standard-normal operands: does the time depend on the data?
    g = torch.Generator(device=dev).manual_seed(5)
    nq, nk, nv = (torch.randn(t.shape, generator=g, device=dev).to(torch.bfloat16)
                  for t in (gq, gk, gv))
    normal_ms = time_ms(lambda q, k, v: fa.flash_attention(q, k, v), (nq, nk, nv), 10, flush)
    normal_lib = time_ms(sdpa, (nq, nk, nv), 10, flush)
    log(f"K6 global shape on seeded standard-normal operands: {normal_ms:.6f} ms "
        f"({k6_flops(B, S, Hq, dh, None) / normal_ms / 1e9:.1f} TFLOP/s); SDPA {normal_lib:.6f} ms")
    del gq, gk, gv, gres, lq, lk, lv, lres, nq, nk, nv

    # ---- the card's logits against the CPU's ---------------------------------
    tok = batch["tokens"][:1, :640].contiguous()  # a prompt past the 512-token window
    card = step(params, {"tokens": tok}).cpu()
    t = time.perf_counter()
    want = step(cpu_params, {"tokens": tok.cpu()})
    cpu_s = time.perf_counter() - t
    mx, rel = lm_close(card, want, "prefill logits at B = 1, S = 640")
    log(f"prefill logits at B = 1, S = 640 equal the CPU's (CPU run {cpu_s:.3f} s) within rtol "
        f"{LM_TOL['rtol']} / atol {LM_TOL['atol']} and relative L2 {LM_REL_L2}: max |diff| "
        f"{mx:.4g}, relative L2 {rel:.4g}, largest |logit| {float(want.abs().max()):.4g}")
    del card, want, full, batch

    # ---- decode_32k, B cut to 64 -----------------------------------------------
    def decode_batch(cell, B: int, seed: int):
        """The cell's decode batch at B rows: the cache filled on the card from a
        seeded generator (as make_batch fills it, standard normal), tokens from
        NumPy, cur_len as make_batch sets it."""
        (L, _, S, Hkv, dh), dtype = input_specs(arch, cell, cfg)["cache"]["k"]
        g = torch.Generator(device=dev).manual_seed(seed)
        cache = {n: torch.randn((L, B, S, Hkv, dh), generator=g, device=dev, dtype=dtype)
                 for n in ("k", "v")}
        tokens = np.random.default_rng(seed).integers(0, cfg.vocab, (B,)).astype(np.int32)
        return {"cache": cache, "tokens": torch.from_numpy(tokens).to(dev),
                "cur_len": torch.tensor(min(5, S - 1), dtype=torch.int32)}

    for name, B, seed in (("decode_32k", 64, 2), ("long_500k", 1, 3)):
        cell = arch.cell(name)
        step, _ = build_step(arch, cell, cfg)
        t = time.perf_counter()
        batch = decode_batch(cell, B, seed)
        sync(dev)
        S = batch["cache"]["k"].shape[2]
        log(f"{name}: cache 2 x {tuple(batch['cache']['k'].shape)} bf16 "
            f"({2 * batch['cache']['k'].numel() * 2 / 1e9:.1f} GB) filled in "
            f"{time.perf_counter() - t:.3f} s")
        logits, _ = step(params, batch)
        sync(dev)
        require(logits.shape == (B, cfg.vocab) and bool(torch.isfinite(logits).all()),
                f"{name}: logits of shape {tuple(logits.shape)} are not finite")
        warm = warm_ms(lambda: step(params, batch), dev, runs=5)
        med = float(np.median(warm))
        log(f"{name} (B = {B}, cur_len {int(batch['cur_len'])}): warm {fmt(warm)} ms, median "
            f"{med:.3f} ms, {B / med * 1e3:.1f} tokens/s; logits finite")
        top_kernels(lambda: step(params, batch), dev, f"{name}, one warm step", med)
        if name == "decode_32k":
            cpu_batch = {"cache": {n: c[:, :2].cpu() for n, c in batch["cache"].items()},
                         "tokens": batch["tokens"][:2].cpu(),
                         "cur_len": torch.tensor(S - 2, dtype=torch.int32)}
            batch["cur_len"] = cpu_batch["cur_len"]
            t = time.perf_counter()
            logits, cache = step(params, batch)
            sync(dev)
            chk_ms = (time.perf_counter() - t) * 1e3
            top_kernels(lambda: step(params, batch), dev, "decode_32k check step", chk_ms)
            f32_batch = dict(cpu_batch, cache={n: c.float() for n, c in cpu_batch["cache"].items()})
            want, want_cache = step(cpu_params, cpu_batch)
            mx, rel = lm_close(logits[:2].cpu(), want, "decode_32k check step, logits rows 0-1")
            # bf16's own error: both runs against a float32 run of the same (bf16) weights
            f32 = build_step(arch, cell, dataclasses.replace(cfg, dtype="float32"))[0](
                cast_params(cpu_params, torch.float32), f32_batch)[0]
            noise = [float((x.float() - f32).norm() / f32.norm()) for x in (logits[:2].cpu(), want)]
            del f32_batch
            rows = [lm_close(cache[n][:, :2, S - 2].cpu(), want_cache[n][:, :, S - 2],
                             f"decode_32k check step, cache {n} rows") for n in ("k", "v")]
            log(f"decode_32k check step at cur_len {S - 2} (global layers over {S - 1} rows, local "
                f"over {cfg.window}): {chk_ms:.3f} ms; rows 0-1 equal the CPU's decode_step: "
                f"logits max |diff| {mx:.4g} (relative L2 {rel:.4g}), written k rows "
                f"{rows[0][0]:.4g} ({rows[0][1]:.4g}), v rows {rows[1][0]:.4g} ({rows[1][1]:.4g}); "
                f"relative L2 against a float32 CPU run: card {noise[0]:.4g}, CPU {noise[1]:.4g}")
            del cache, cpu_batch, want_cache
        del batch, logits

    # ---- DecodeEngine: 12 requests through 8 slots --------------------------
    scfg = ServeConfig(max_batch=8, max_len=1024, eos_token=-1)
    eng = DecodeEngine(params, cfg, scfg, device=dev)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab, int(rng.integers(16, 65))).tolist() for _ in range(12)]
    for p in prompts:
        eng.submit(p, max_new=32)
    t = time.perf_counter()
    done = eng.run_until_drained()
    wall = time.perf_counter() - t
    require(sorted(done) == list(range(12)), f"DecodeEngine finished {sorted(done)}, not all 12")
    require(all(len(ts) == 32 and all(0 <= x < cfg.vocab for x in ts) for ts in done.values()),
            "DecodeEngine: a request did not get 32 ids in [0, V)")
    prefill, _ = build_step(arch, arch.cell("prefill_32k"), cfg)
    gaps, same = [], 0
    for i in range(scfg.max_batch):  # the first wave starts at cur_len 0, as a prefill does
        last = prefill(params, {"tokens": torch.tensor([prompts[i]], device=dev)})[0, -1].float()
        top = torch.topk(last, 2).values
        tok = done[i][0]
        gaps.append(float(top[0] - last[tok]))
        require(gaps[-1] <= LM_TOL["atol"], f"DecodeEngine request {i}: its first token's prefill "
                f"logit is {gaps[-1]:.4g} below the prefill's max")
        same += tok == int(last.argmax())
    log(f"DecodeEngine (8 slots, max_len 1024): 12 requests of {min(map(len, prompts))}-"
        f"{max(map(len, prompts))} prompt tokens, 32 new each, 4 of them in reused slots; "
        f"{eng.cur_len} ticks in {wall:.3f} s, {wall / eng.cur_len * 1e3:.3f} ms per tick, "
        f"{12 * 32 / wall:.1f} generated tokens/s; first wave: each first token's prefill logit "
        f"within {LM_TOL['atol']} of the prefill's max (gaps "
        f"{', '.join(f'{g:.3g}' for g in gaps)}), {same} of 8 the prefill's argmax")
    log(f"gemma3-1b peak device memory: {torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB")
    return out


# ---- phase 8 ----------------------------------------------------------------

PATHS4 = (("loop", "numpy"), ("stacked", "numpy"), ("loop", "device"), ("stacked", "device"))


def rand_update(rng, g, n_edges: int = 4):
    """``benchmarks/bench_updates.py``'s edit batch: ``n_edges`` edges removed
    and ``n_edges`` random pairs added."""
    from repro_torch.core import GraphUpdate

    e = g.edge_array()
    remove = e[rng.choice(e.shape[0], size=n_edges, replace=False)]  # drawn first, as bench_updates.py does
    return GraphUpdate(add_edges=rng.integers(0, g.n_vertices, size=(n_edges, 2)),
                       remove_edges=remove)


def delta_order_check(eng, queries, lists: dict) -> int:
    """The four probe × join lists against the candidate orders of the JAX
    package under pending deltas, built here from the loop probe's memos:
    per partition in engine order its live main rows, then its buffer rows
    (host join, both probes); the hand-off's device rows in slot order, then
    the buffer rows in engine order.  No main row a probe returns is
    tombstoned → probes checked."""
    import torch

    from repro_torch.core.matcher import match_from_candidates, match_from_candidates_many

    q_embs = eng._query_node_embeddings_many(queries)
    plans = [eng._deg_plan_cached(q) for q in queries]
    reqs = list(dict.fromkeys((qi, p) for qi, pl in enumerate(plans) for p in pl.paths))
    memo, dm, smemo, sdm, dev_memo, dev_counts, hdm = {}, {}, {}, {}, {}, {}, {}
    eng._probe_batch(reqs, q_embs, memo, queries, "loop", delta_memo=dm)
    eng._probe_batch(reqs, q_embs, smemo, queries, "stacked", delta_memo=sdm)
    eng._probe_batch(reqs, q_embs, {}, queries, "stacked", dev_memo=dev_memo,
                     dev_counts=dev_counts, delta_memo=hdm)
    for a, b, what in ((memo, smemo, "stacked probe's main rows"), (dm, sdm, "stacked buffer rows"),
                       (dm, hdm, "hand-off's buffer rows")):
        require(a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a),
                f"the {what} differ from the loop probe's")
    slots = np.argsort(eng.stacked_probe().stacked.slot_of)
    host, hand = {}, {}
    for qi, p in reqs:
        main, buf = [], []
        for mi, model in enumerate(eng.models):
            dp = eng.delta.parts[mi]
            rows = memo.get((mi, qi, p))
            if rows is not None and rows.numel():
                require(not bool(dp.tombstone[rows].any()), "a probe returned a tombstoned row")
                main.append(model.index.paths[rows])
            drows = dm.get((mi, qi, p))
            if drows is not None and drows.numel():
                main.append(dp.paths[drows])
                buf.append(dp.paths[drows])
        host[(qi, p)] = torch.cat(main) if main else torch.zeros((0, len(p)), dtype=torch.int64,
                                                                 device=eng.device)
        slot_rows = [eng.models[mi].index.paths[memo[(mi, qi, p)]] for mi in slots
                     if (mi, qi, p) in memo]
        hand[(qi, p)] = torch.cat(slot_rows + buf).to(torch.int32)
        got = eng._device_candidates(dev_memo[(qi, p)], buf, len(p))
        require(torch.equal(got, hand[(qi, p)]),
                f"the hand-off's candidates of probe {(qi, p)} are not main (slot order) + buffer")
    paths = [pl.paths for pl in plans]
    want_host = [
        match_from_candidates(eng.graph, eng.dgraph, q, pl.paths, [host[(qi, p)] for p in pl.paths],
                              assume_unique=True)
        for qi, (q, pl) in enumerate(zip(queries, plans))
    ]
    for path in (("loop", "numpy"), ("stacked", "numpy")):
        require(lists[path] == want_host, f"{path}: lists differ from the host-order join")
    for path, cands in ((("loop", "device"), host), (("stacked", "device"), hand)):
        want = match_from_candidates_many(
            eng.graph, eng.dgraph, queries, paths,
            [[cands[(qi, p)] for p in pl.paths] for qi, pl in enumerate(plans)],
            join_impl="device", assume_unique=True,
        )
        require(lists[path] == want, f"{path}: lists differ from the device join in that order")
    return len(reqs)


class DeltaScanProbe:
    """Records the delta buffers' scans while installed: each fused verdict's
    operands and result (``core/delta.py``'s ``_pairs_keep_mask``, K1 on the
    card), the K1 launches ``ops.LAUNCHES`` counts inside those verdicts, and
    each ``probe_delta_multi`` call's peak of device memory above what was
    allocated when it began."""

    def __init__(self):
        from repro_torch.core import delta as delta_mod
        from repro_torch.core import engine as engine_mod
        from repro_torch.kernels.dominance_scan import ops

        self.delta_mod, self.engine_mod, self.ops = delta_mod, engine_mod, ops
        self.verdicts, self.peaks, self.pairs, self.launches = [], [], 0, 0

    def __enter__(self):
        import torch

        keep_mask, scan = self.delta_mod._pairs_keep_mask, self.engine_mod.probe_delta_multi
        self.saved = keep_mask, scan

        def verdict(*a):
            before = self.ops.LAUNCHES
            res = keep_mask(*a)
            self.launches += self.ops.LAUNCHES - before
            self.verdicts.append((a, res))
            self.pairs += verdict_pairs(a)
            return res

        def measured(*a, **k):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            out = scan(*a, **k)
            torch.cuda.synchronize()
            self.peaks.append(torch.cuda.max_memory_allocated() - base)
            return out

        self.delta_mod._pairs_keep_mask, self.engine_mod.probe_delta_multi = verdict, measured
        return self

    def __exit__(self, *exc):
        self.delta_mod._pairs_keep_mask, self.engine_mod.probe_delta_multi = self.saved

    def check(self, what: str) -> None:
        """Every recorded verdict equal to the plain version on its operands."""
        import torch

        from repro_torch.kernels.dominance_scan.ref import dominance_scan_pairs_indexed_ref

        for a, keep in self.verdicts:
            require(torch.equal(keep, dominance_scan_pairs_indexed_ref(*a)),
                    f"{what}: K1 on the delta scan's pairs differs from the plain version")


class SlotUpdates:
    """Counts ``StackedProbe.update_slot`` calls (and refusals) while installed."""

    def __enter__(self):
        from repro_torch.dist.probe import StackedProbe

        self.cls, self.saved = StackedProbe, StackedProbe.update_slot
        self.calls = self.refused = 0

        def counted(probe, part_i, index):
            ok = self.saved(probe, part_i, index)
            self.calls += 1
            self.refused += int(not ok)
            return ok

        StackedProbe.update_slot = counted
        return self

    def __exit__(self, *exc):
        self.cls.update_slot = self.saved


class StageClock:
    """Host ms of the update path's stages while installed: each listed
    function (a module's or a class's attribute) counts its time, to
    ``finish()`` (a synchronize on the card), under its stage, less the
    stages it calls; ``calls`` counts its entries."""

    def __init__(self, stages: list, finish=lambda: None):
        self.stages, self.finish = stages, finish
        self.ms: dict = {}
        self.calls: dict = {}
        self._open: list = []  # [stage, start] of the stages entered, innermost last

    def _add(self, key: str, t0: float, t1: float) -> None:
        self.ms[key] = self.ms.get(key, 0.0) + (t1 - t0) * 1e3

    def _wrap(self, fn, key: str):
        def run(*a, **k):
            self.finish()
            now = time.perf_counter()
            if self._open:  # the caller's stage pauses
                self._add(self._open[-1][0], self._open[-1][1], now)
            self._open.append([key, now])
            try:
                return fn(*a, **k)
            finally:
                self.finish()
                now = time.perf_counter()
                self._add(key, self._open.pop()[1], now)
                self.calls[key] = self.calls.get(key, 0) + 1
                if self._open:
                    self._open[-1][1] = now

        return run

    def __enter__(self):
        self.saved = [(owner, name, vars(owner)[name]) for owner, name, _ in self.stages]
        for (owner, name, key), (_, _, fn) in zip(self.stages, self.saved):
            setattr(owner, name, self._wrap(fn, key))
        return self

    def __exit__(self, *exc):
        for owner, name, fn in self.saved:
            setattr(owner, name, fn)

    def report(self, wall_ms: float) -> str:
        return ", ".join(f"{k} {v:.3f} ms / {self.calls[k]}" for k, v in self.ms.items()) + (
            f", the rest {wall_ms - sum(self.ms.values()):.3f} ms")


def update_stages(engine_mod, delta_mod, probe_mod) -> list:
    """(owner, attribute, stage) of ``apply_updates``' stages under both
    strategies: the names are the same in the port and in the JAX package
    (``tools/update_stages.py`` passes the latter's modules)."""
    eng = engine_mod.GnnPeEngine
    stages = [
        (engine_mod, "apply_graph_update", "graph edit"),
        (engine_mod, "device_graph", "graph upload"),
        (eng, "_assign_new_vertices", "new vertices"),
        (engine_mod, "l_hop_reach", "L-hop reach"),
        (engine_mod, "expanded_partition", "expanded vertex sets (host BFS)"),
        (engine_mod, "build_star_tensors", "star tensors"),
        (eng, "_refresh_node_embeddings", "re-embed"),
        (eng, "_node_embeddings", "embed (rebuild)"),
        (delta_mod.DeltaIndex, "tombstone_touched", "tombstones"),
        (engine_mod, "enumerate_paths", "path enumeration"),
        (engine_mod, "paths_touching", "paths touching"),
        (engine_mod, "concat_path_embeddings", "path embeddings"),
        (engine_mod, "hash_labels", "label hashes"),
        (delta_mod.DeltaIndex, "append", "buffer append"),
        (engine_mod, "build_index", "index pack (rebuild)"),
        (eng, "_attach_partition_groups", "groups (rebuild)"),
        (delta_mod.DeltaIndex, "compact_partition", "compaction"),
        (probe_mod.StackedProbe, "update_slot", "update_slot"),
    ]
    return [st for st in stages if st[1] in vars(st[0])]


def profiled_update(eng, upd, dev) -> tuple[dict, float]:
    """One ``apply_updates`` under ``torch.profiler``, with the host ms of
    its stages (``StageClock``) → (summary, wall ms)."""
    import torch

    from repro_torch.core import delta as delta_mod
    from repro_torch.core import engine as engine_mod
    from repro_torch.dist import probe as probe_mod

    with StageClock(update_stages(engine_mod, delta_mod, probe_mod), lambda: sync(dev)) as clock:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            s = eng.apply_updates(upd)
            sync(dev)
            wall = (time.perf_counter() - t) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    log(f"8a profiled apply_updates: {wall:.3f} ms wall, {len(s['mutated'])} partitions mutated; "
        f"device busy {busy:.3f} ms in {sum(e.count for e in kernels)} kernel launches, "
        f"{sum(e.count for e in kernels if 'DtoH' in e.key)} device-to-host copies; host stages "
        f"(ms / calls) {clock.report(wall)}")
    return s, wall


def phase8a_updates(dev) -> dict:
    """The 50K cell under 8 seeded update epochs, cache on (the module doc's
    phase 8a)."""
    import dataclasses

    import torch

    from repro_torch.core import GnnPeEngine, GraphUpdate, sort_matches

    out = {"K1": 0, "K2": 0, "delta_K1": 0}
    g, queries, cfg = cell_50k_inputs()
    cfg = dataclasses.replace(cfg, cache=True, delta_compact_min=192, delta_compact_frac=0.08)
    t = time.perf_counter()
    eng = GnnPeEngine(cfg).build(g)
    eng.stacked_probe()
    sync(dev)
    log(f"8a build: {time.perf_counter() - t:.3f} s, {eng.offline_stats['n_paths']} paths; "
        f"compaction threshold per partition max(192, 0.08 x paths) = "
        f"{min(max(192, int(0.08 * m.index.n_paths)) for m in eng.models)}.."
        f"{max(max(192, int(0.08 * m.index.n_paths)) for m in eng.models)} rows")
    cache = eng._result_cache

    def run_paths(label: str) -> dict:
        """The four probe × join lists, cache set aside (counted launches)."""
        eng._result_cache = None
        lists = {}
        try:
            for probe, join in PATHS4:
                reset_counters()
                lists[(probe, join)] = eng.match_many(queries, probe_impl=probe, join_impl=join)
                sync(dev)
                c = counters()
                out["K1"] += c["K1"]
                out["K2"] += c["K2"]
                require(c["K1"] > 0, f"{label} {probe}/{join}: K1 never launched")
                if join == "device":
                    require(c["K2"] > 0, f"{label} {probe}/{join}: K2 never launched")
        finally:
            eng._result_cache = cache
        sets = [sort_matches(m) for m in lists[PATHS4[0]]]
        for path, got in lists.items():
            require([sort_matches(m) for m in got] == sets, f"{label} {path}: sets differ")
        return lists

    def warm() -> float:
        eng._result_cache = None
        try:
            return warm_ms(lambda: eng.match_many(queries), dev, 1)[0]
        finally:
            eng._result_cache = cache

    run_paths("epoch 0")
    warm0 = warm()
    rng = np.random.default_rng(0)
    n_inline = 0
    with SlotUpdates() as slots:
        for epoch in range(1, 9):
            if epoch == 7:  # two appended vertices, labels in [0, 100)
                upd = GraphUpdate(add_vertex_labels=rng.integers(0, 100, size=2).astype(np.int32))
            elif epoch == 8:  # one vertex removed
                upd = GraphUpdate(remove_vertices=rng.integers(0, eng.graph.n_vertices, size=1))
            else:
                upd = rand_update(rng, eng.graph)
            calls0 = slots.calls
            if epoch == 6:  # one epoch under the profiler, its stages timed
                s, apply_ms = profiled_update(eng, upd, dev)
            else:
                t = time.perf_counter()
                s = eng.apply_updates(upd)
                sync(dev)
                apply_ms = (time.perf_counter() - t) * 1e3
            n_inline += len(s["compacted"])
            k1_before = out["K1"]
            with DeltaScanProbe() as scan:
                lists = run_paths(f"epoch {epoch}")
            scan.check(f"8a epoch {epoch}")
            out["delta_K1"] += scan.launches
            require(len(scan.verdicts) == (4 if eng.delta.any_rows() else 0),
                    f"epoch {epoch}: {len(scan.verdicts)} delta-scan verdicts for 4 batches")
            require(scan.launches == len(scan.verdicts),
                    f"epoch {epoch}: ops.LAUNCHES rose by {scan.launches} in "
                    f"{len(scan.verdicts)} delta-scan verdicts, not one K1 launch each")
            n_probes = delta_order_check(eng, queries, lists)
            if epoch in (1, 8):
                check_against_vf2(eng.graph, queries, lists[PATHS4[0]], f"8a epoch {epoch}")
            hits0 = cache.stats.hits
            for _ in range(2):
                got = eng.match_many(queries)
                same = [sort_matches(m) for m in got] == [sort_matches(m) for m in lists[PATHS4[0]]]
                require(same, f"epoch {epoch}: a cached answer differs from the pipeline's")
            w = warm()
            st = eng.delta_stats()
            peak = max(scan.peaks, default=0)
            log(f"8a epoch {epoch}: apply_updates {apply_ms:.3f} ms{' (profiled)' * (epoch == 6)}, "
                f"touched {s['touched']}, "
                f"mutated {len(s['mutated'])}, compacted {s['compacted']}; delta rows "
                f"{st['delta_rows']}, tombstones {st['tombstones']}, compactions "
                f"{st['n_compactions']}; update_slot {slots.calls - calls0} (full re-stacks "
                f"{int(eng._stacked_probe is None)}); K1 launches (ops.LAUNCHES) "
                f"{out['K1'] - k1_before}, of them the delta scan's {scan.launches} over "
                f"{scan.pairs} pairs, equal to plain; delta-scan peak "
                f"{peak / 2**20:.3f} MiB; cache hits {cache.stats.hits - hits0} of "
                f"{2 * len(queries)}; warm match_many {w:.3f} ms (epoch 0: {warm0:.3f}); "
                f"{n_probes} probes in the JAX package's candidate order")
            out["peak_mib"] = max(out.get("peak_mib", 0.0), peak / 2**20)
        # the deferred path: the two most pressured partitions compact through
        # prepare → build → install, each re-stacking only its slot
        pressured = sorted(range(len(eng.models)), key=lambda mi: -eng.delta.parts[mi].pressure)[:2]
        calls0 = slots.calls
        for mi in pressured:
            snap = eng.prepare_compaction(mi)
            require(eng.install_compaction(snap, eng.build_compaction(snap)),
                    f"the compaction of partition {mi} was refused")
        require(eng._stacked_probe is not None and slots.calls - calls0 == len(pressured),
                "a compaction re-stacked everything instead of its slot")
    require(n_inline + len(pressured) >= 1 and slots.calls - slots.refused >= 1,
            "no compaction or no update_slot in phase 8a")
    after = run_paths("after the installs")
    delta_order_check(eng, queries, after)
    t = time.perf_counter()
    phase8d_short_paths(dev, eng, queries, g, cfg)
    log(f"phase 8d short-path queries and the restored hand-off order: "
        f"{time.perf_counter() - t:.3f} s")
    log(f"8a: delta-scan K1 launches {out['delta_K1']} over the 8 epochs (ops.LAUNCHES); "
        f"inline compactions {n_inline}, installed {len(pressured)} ({pressured}); "
        f"update_slot {slots.calls} calls, {slots.refused} refused; delta stats "
        f"{eng.delta_stats()}")
    eng.rebuild_indexes()
    rebuilt = run_paths("rebuild_indexes")
    for path in PATHS4:
        require([sort_matches(m) for m in after[path]] == [sort_matches(m) for m in rebuilt[path]],
                f"{path}: the delta engine's lists differ from rebuild_indexes()'s")
    log("8a: after the last epoch every probe x join list equals rebuild_indexes()'s "
        "under sort_matches")
    out.update(warm0=warm0, n_inline=n_inline)
    return out


def short_path_queries(g, length: int, n_edges: int = 4, seed: int = 0) -> list:
    """Queries with no simple path of ``length`` edges, each with a match on
    ``g``: single edges drawn from its live edges, and at l = 3 a 2-edge path
    and a star of up to 7 edges around its highest-degree vertex, labelled
    as the graph is there."""
    from repro_torch.graphs import from_edge_list

    rng = np.random.default_rng(seed)
    e = g.edge_array()
    lab = np.asarray(g.labels)
    qs = [from_edge_list(2, [(0, 1)], lab[e[i]].astype(np.int32))
          for i in rng.choice(e.shape[0], size=n_edges, replace=False)]
    if length >= 3:
        for i in rng.permutation(e.shape[0]):
            u, v = (int(x) for x in e[i])
            w = [int(x) for x in g.neighbors(v) if int(x) != u]
            if w:
                qs.append(from_edge_list(3, [(0, 1), (1, 2)], lab[[u, v, w[0]]].astype(np.int32)))
                break
        c = int(np.argmax(g.degrees))
        nb = [int(x) for x in g.neighbors(c)][:7]
        qs.append(from_edge_list(len(nb) + 1, [(0, i + 1) for i in range(len(nb))],
                                 lab[[c] + nb].astype(np.int32)))
    return qs


def short_path_check(eng, queries: list, n_short: int, dev, what: str) -> str:
    """The repair of short-path queries on the card: ``queries`` (the first
    ``n_short`` of them with no path of l edges) through the scalar match,
    both probes x both joins and ``ClusterEngine`` (its parts-scoped probes),
    the result cache set aside; every set equal to VF2's on the live graph
    → a summary for the log."""
    from repro_torch.core import vf2_match
    from repro_torch.dist import ClusterEngine

    cache, eng._result_cache = eng._result_cache, None
    t = time.perf_counter()
    try:
        lists = {"scalar": [eng.match(q, impl="scalar") for q in queries]}
        for probe, join in PATHS4:
            lists[f"{probe}/{join}"] = eng.match_many(queries, probe_impl=probe, join_impl=join)
        lists["ClusterEngine 2 hosts"] = ClusterEngine(eng, n_hosts=2).match_many(queries)
        sync(dev)
    finally:
        eng._result_cache = cache
    run_s = time.perf_counter() - t
    want = [set(vf2_match(eng.graph, q)) for q in queries]
    for route, got in lists.items():
        for qi, (m, w) in enumerate(zip(got, want)):
            require(set(m) == w and len(m) == len(w),
                    f"{what} {route} query {qi}: {len(m)} matches, VF2 finds {len(w)}")
    n_short_matches = [len(w) for w in want[:n_short]]
    require(all(n > 0 for n in n_short_matches),
            f"{what}: a short-path query has no match to hold ({n_short_matches})")
    return (f"{what}: {len(queries)} queries ({n_short} with no path of "
            f"{eng.cfg.path_length} edges: {n_short_matches} matches) through "
            f"{', '.join(lists)}, every set equal to VF2's ({run_s:.3f} s on the routes)")


def restored_order_check(eng, queries: list, dev, root) -> str:
    """The restored hand-off's order on the card: a port snapshot of ``eng``
    after compactions moved its partitions' sizes off its slots restores the donor's
    stacked slots, fingerprint and lists in order; without the port's meta
    key (the JAX package's layout) it stacks afresh and gives the same sets
    → a summary for the log."""
    from repro_torch.core import GraphUpdate, sort_matches
    from repro_torch.core.stacked import default_slot_of
    from repro_torch.durability import SnapshotStore, engine_fingerprint
    from repro_torch.durability.snapshot import _META_KEY, _SLOT_KEY, restore_engine

    live = np.asarray(eng.stacked_probe().stacked.slot_of).copy()
    fresh = default_slot_of([m.index.n_paths for m in eng.models])
    # 8a's churn leaves the sizes in their build order: shrink the partition
    # in slot 0 (deleting edges inside it, then compacting it) until another
    # partition is larger, so the slots the probe kept are off the fresh layout
    rounds = 0
    while np.array_equal(live, fresh) and rounds < 8:
        top = int(np.argmin(live))
        rem = interior_edges(eng.graph, eng.models[top].members, 24, set())
        eng.apply_updates(GraphUpdate(remove_edges=rem))
        snap = eng.prepare_compaction(top)
        require(eng.install_compaction(snap, eng.build_compaction(snap)),
                f"8d: the compaction of partition {top} was refused")
        require(eng._stacked_probe is not None, "8d: a shrinking partition re-stacked everything")
        rounds += 1
        fresh = default_slot_of([m.index.n_paths for m in eng.models])
    moved = int((live != fresh).sum())
    require(moved > 0, f"8d: {rounds} rounds of deletions left the partitions' sizes in their "
            f"slot order; the check would hold nothing")
    store = SnapshotStore(root, keep=1)
    t = time.perf_counter()
    store.save(eng)
    restored, meta, arrays, _ = store.load()
    sync(dev)
    load_s = time.perf_counter() - t
    require(meta[_SLOT_KEY] == live.tolist(), "8d: the snapshot carries another slot layout")
    require(np.array_equal(restored.stacked_probe().stacked.slot_of, live),
            "8d: the restored engine stacked other slots than its donor's")
    require(engine_fingerprint(restored) == engine_fingerprint(eng),
            "8d: the restored engine's fingerprint differs from its donor's")
    meta = dict(meta)
    del meta[_SLOT_KEY]  # the JAX package's layout
    plain, _ = restore_engine({**arrays, _META_KEY: np.asarray(json.dumps(meta))})
    require(np.array_equal(plain.stacked_probe().stacked.slot_of, fresh),
            "8d: a snapshot without the layout did not stack afresh")
    got = {}
    for name, e in (("donor", eng), ("restored", restored), ("afresh", plain)):
        cache, e._result_cache = e._result_cache, None
        try:
            got[name] = e.match_many(queries, probe_impl="stacked", join_impl="device")
        finally:
            e._result_cache = cache
    require(got["restored"] == got["donor"], "8d: the restored hand-off's lists differ from "
            "its donor's in order")
    require([sort_matches(m) for m in got["afresh"]] == [sort_matches(m) for m in got["donor"]],
            "8d: the engine stacked afresh gives other sets than its donor")
    del restored, plain
    return (f"8d restored hand-off: {moved} of {len(live)} slots off the fresh largest-first "
            f"layout after the compactions ({rounds} round(s) of 24 deletions in slot 0's "
            f"partition, each compacted); a port snapshot saved and restored on the card in "
            f"{load_s:.3f} s took the donor's slots, fingerprint and stacked/device lists in "
            f"order; without the port's key it stacked afresh, sets equal, lists "
            f"{'in the same' if got['afresh'] == got['donor'] else 'in another'} order")


def phase8d_short_paths(dev, eng, queries: list, g, cfg) -> None:
    """The two repairs on the card: short-path queries on 8a's engine (l = 2,
    its deltas and tombstones pending) and on the 50K cell at l = 3, and the
    restored hand-off's order after 8a's compactions."""
    import dataclasses
    import tempfile

    from repro_torch.core import GnnPeEngine

    short = short_path_queries(eng.graph, 2)
    st = eng.delta_stats()
    log(short_path_check(eng, short + queries[:2], len(short), dev,
                         f"8d l = 2, 8a's engine (delta rows {st['delta_rows']}, tombstones "
                         f"{st['tombstones']})"))
    t = time.perf_counter()
    eng3 = GnnPeEngine(dataclasses.replace(cfg, path_length=3)).build(g)
    sync(dev)
    build_s = time.perf_counter() - t
    short = short_path_queries(g, 3)
    log(short_path_check(eng3, short + queries[:2], len(short), dev,
                         f"8d l = 3, the 50K cell ({eng3.offline_stats['n_paths']} paths, "
                         f"built in {build_s:.3f} s)"))
    del eng3
    with tempfile.TemporaryDirectory() as tmp:
        log(restored_order_check(eng, queries, dev, Path(tmp)))


def phase8b_bench_updates(dev) -> dict:
    """``benchmarks/bench_updates.py --full``'s cell on the port: delta
    against rebuild over 6 batches, each strategy's stages timed
    (``StageClock``; the delta engine keeps a stacked probe, so the engine's
    own compaction trigger re-stacks a slot), then the repeat-heavy stream
    with the cache off and on."""
    from repro_torch.core import GnnPeConfig, GnnPeEngine, TrainConfig, sort_matches
    from repro_torch.core import delta as delta_mod
    from repro_torch.core import engine as engine_mod
    from repro_torch.dist import probe as probe_mod
    from repro_torch.graphs import newman_watts_strogatz, random_connected_query

    g = newman_watts_strogatz(10_000, k=4, p=0.1, n_labels=100, seed=13)
    base = dict(n_partitions=10_000 // 250, encoder="monotone", index_kind="grouped",
                group_size=16, train=TrainConfig(max_epochs=150))
    eng = GnnPeEngine(GnnPeConfig(**base, cache=True, delta_compact_min=192,
                                  delta_compact_frac=0.08)).build(g)
    eng.stacked_probe()
    reb = GnnPeEngine(GnnPeConfig(**base)).build(g)

    def sample(n, seed0):
        out = []
        for s in range(n):
            try:
                out.append(random_connected_query(g, 8, seed=seed0 + s))
            except RuntimeError:
                continue
        return out

    queries = sample(8, 77)
    rng = np.random.default_rng(0)
    cache, eng._result_cache = eng._result_cache, None
    stages = update_stages(engine_mod, delta_mod, probe_mod)
    clocks = {k: StageClock(stages, lambda: sync(dev)) for k in ("delta", "rebuild")}
    wall = {"delta": 0.0, "rebuild": 0.0}
    n_mutated = 0
    with SlotUpdates() as slots:
        for b in range(6):
            upd = rand_update(rng, eng.graph)
            for strategy, e in (("delta", eng), ("rebuild", reb)):
                with clocks[strategy]:
                    t = time.perf_counter()
                    s = e.apply_updates(upd, strategy=strategy)
                    sync(dev)
                    wall[strategy] += (time.perf_counter() - t) * 1e3
                n_mutated += len(s["mutated"]) * (strategy == "delta")
            md = [sort_matches(m) for m in eng.match_many(queries)]
            require(md == [sort_matches(m) for m in reb.match_many(queries)],
                    f"8b batch {b}: delta and rebuild match sets differ")
    st = eng.delta_stats()
    require(st["n_compactions"] >= 1 and slots.calls - slots.refused >= 1,
            f"8b: {st['n_compactions']} compactions and {slots.calls - slots.refused} slots "
            "re-stacked by the engine's own trigger; each must be at least 1")
    speedup = wall["rebuild"] / max(wall["delta"], 1e-12)
    log(f"8b delta vs rebuild, 6 batches: delta {wall['delta']:.3f} ms, rebuild "
        f"{wall['rebuild']:.3f} ms, speedup {speedup:.2f}x; match sets identical at every epoch; "
        f"compactions {st['n_compactions']}, update_slot {slots.calls} calls ({slots.refused} "
        f"refused), delta rows {st['delta_rows']}, tombstones {st['tombstones']}")
    for strategy, n_parts in (("delta", n_mutated), ("rebuild", 6 * len(reb.models))):
        log(f"8b {strategy} stages, 6 batches (ms / calls): {clocks[strategy].report(wall[strategy])}; "
            f"{n_parts} partitions re-indexed, {wall[strategy] / max(n_parts, 1):.3f} ms each")
    pool = sample(6, 500)
    stream = [pool[int(rng.integers(0, len(pool)))] for _ in range(48)]

    def lat(q):
        t = time.perf_counter()
        m = eng.match(q)
        sync(dev)
        return time.perf_counter() - t, m

    off = [lat(q) for q in stream]
    cache.clear()
    eng._result_cache = cache
    on = [lat(q) for q in stream]
    for (_, a), (_, b) in zip(off, on):
        require(sort_matches(a) == sort_matches(b), "8b: a cached answer differs")

    def pcts(x):
        a = np.sort(np.asarray([v for v, _ in x])) * 1e3
        return float(a[len(a) // 2]), float(a[min(int(len(a) * 0.95), len(a) - 1)])

    (p50_off, p95_off), (p50_on, p95_on) = pcts(off), pcts(on)
    log(f"8b repeat-heavy stream (pool 6, 48 requests): cache off p50 {p50_off:.3f} ms, p95 "
        f"{p95_off:.3f} ms; cache on p50 {p50_on:.3f} ms, p95 {p95_on:.3f} ms "
        f"({p50_off / max(p50_on, 1e-9):.2f}x at p50); hit rate {cache.stats.hit_rate():.3f}")
    return {"speedup": speedup, "n_compactions": st["n_compactions"]}


def phase8c_gat_bits(dev, eng, queries) -> None:
    """Phase 4's GAT engine: one update through the delta path, then its
    refreshed node embeddings against ``rebuild_indexes()``'s, bit for bit,
    on every partition's vertex set; the match sets exact against VF2."""
    import torch

    upd = rand_update(np.random.default_rng(0), eng.graph)
    s = eng.apply_updates(upd)
    check_against_vf2(eng.graph, queries, eng.match_many(queries), "8c delta")
    touched = eng.epoch_fresh()["touched"]

    def rows(m, v):
        """(|v|, d + d + n_multi·d): each vertex's three embeddings in one row."""
        multi = m.node_emb_multi[:, v].transpose(0, 1).reshape(v.numel(), -1)
        return torch.cat([m.node_emb[v], m.node_emb0[v], multi], dim=1).clone()

    vsets = [m.vertex_set.astype(np.int64) for m in eng.models]
    before = [rows(m, torch.as_tensor(v, device=dev)) for m, v in zip(eng.models, vsets)]
    eng.rebuild_indexes()
    n_rows = n_equal = n_touched = n_touched_equal = 0
    worst = 0.0
    for m, v, old in zip(eng.models, vsets, before):
        same = (old == rows(m, torch.as_tensor(v, device=dev))).all(dim=1).cpu().numpy()
        hit = np.isin(v, touched)
        n_rows, n_equal = n_rows + same.size, n_equal + int(same.sum())
        n_touched += int(hit.sum())
        n_touched_equal += int(same[hit].sum())
        worst = max(worst, float((old - rows(m, torch.as_tensor(v, device=dev))).abs().max()))
    check_against_vf2(eng.graph, queries, eng.match_many(queries), "8c rebuild")
    log(f"8c GAT bits: {s['touched']} touched vertices; on the vertex sets {n_equal} of {n_rows} "
        f"vertices' embeddings equal rebuild_indexes()'s bit for bit ({n_touched_equal} of the "
        f"{n_touched} rows of touched vertices), max |diff| {worst:.3e}: "
        f"{'bit-equal' if n_equal == n_rows else 'NOT bit-equal'}; match sets equal VF2's after "
        f"the update and after the rebuild")


# ---- phase 9 ----------------------------------------------------------------


def p50_p95(xs) -> list:
    return [float(np.percentile(np.asarray(xs, np.float64), q)) for q in (50, 95)]


def phase9a_obs(dev, ctx: dict, eng_g, out: dict) -> None:
    """One traced warm ``match_many`` on four paths: the funnel against the
    pair counters and the engine's own counts, the stage tree and its sums;
    the registry through Prometheus text and a JSON snapshot; warm batches
    with obs on and off, interleaved."""
    from repro_torch import obs
    from repro_torch.core import sort_matches

    eng, queries = ctx["eng"], ctx["queries"]
    want_sets = [sort_matches(m) for m in ctx["matches"]]
    n_matches = sum(len(m) for m in ctx["matches"])
    obs.TRACER.trace_rate = 1.0
    paths = [
        ("loop probe, host join", eng, {}),
        ("stacked probe, host join", eng, dict(probe_impl="stacked")),
        ("the hand-off, device join", eng, dict(probe_impl="stacked", join_impl="device")),
        ("grouped, loop probe, host join", eng_g, {}),
    ]
    n_cands = None
    for what, e, kw in paths:
        lists, st = e.match_many(queries, return_stats=True, **kw)  # warm, untraced
        sync(dev)
        cands = sum(s.candidate_paths for s in st)
        n_cands = cands if n_cands is None else n_cands
        require(cands == n_cands, f"9a {what}: {cands} candidates, the loop probe counts {n_cands}")
        require([sort_matches(m) for m in lists] == want_sets, f"9a {what}: sets differ from phase 3's")
        reset_counters()
        p0 = pair_counts()
        with obs.trace_query(what) as tr:
            e.match_many(queries, **kw)
        sync(dev)
        c, p1 = counters(), pair_counts()
        out["K1"] += c["K1"]
        out["K2"] += c["K2"]
        require(c["K1"] > 0, f"9a {what}: K1 never launched")
        if kw.get("join_impl") == "device":
            require(c["K2"] > 0, f"9a {what}: K2 never launched")
        f = tr.funnel
        require(f["leaf_pairs"] == p1["leaf_pairs"] - p0["leaf_pairs"] > 0
                and f["group_pairs"] == p1["group_pairs"] - p0["group_pairs"],
                f"9a {what}: funnel pairs {f} differ from the counters' deltas")
        require(f["candidates"] == n_cands and f["matches"] == n_matches,
                f"9a {what}: funnel {f} against {n_cands} candidates, {n_matches} matches")
        require((f["surviving_groups"] > 0) == (e is eng_g), f"9a {what}: surviving groups {f}")
        for name in ("embed", "plan", "probe", "assemble", "join"):
            require(len(tr.root.find(name)) == 1, f"9a {what}: span {name} not once")
        parts = tr.root.find("partition")
        require([s.attrs["part"] for s in parts] == list(range(len(e.models))),
                f"9a {what}: partition spans")
        require(sum(s.attrs["main_rows"] for s in parts) == n_cands,
                f"9a {what}: partition rows differ from the candidates")
        stages = {s.name: s.duration_s * 1e3 for s in tr.root.children}
        wall = tr.root.duration_s * 1e3
        ratio = sum(stages.values()) / wall
        require(0.5 <= ratio <= 1.01, f"9a {what}: stages sum to {ratio:.3f} of the root span")
        log(f"9a traced {what}: root {wall:.3f} ms, stages "
            + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
            + f" (sum {ratio:.3f} of the root); funnel group pairs {f['group_pairs']}, surviving "
            f"groups {f['surviving_groups']}, leaf pairs {f['leaf_pairs']}, candidates "
            f"{f['candidates']}, matches {f['matches']} (pruning power {tr.pruning_power():.6f}); "
            f"K1 launches {c['K1']}, K2 {c['K2']}")
    steps = k2_steps(eng, queries, probe_impl="stacked")
    log(f"9a K2 on the hand-off's {len(steps)} real join steps equal to the plain version")
    text = obs.to_prometheus()
    parsed = obs.parse_prometheus(text)
    snap = obs.REGISTRY.snapshot()
    for name, m in snap.items():
        if m["type"] in ("counter", "gauge"):
            for v in m["values"]:
                lab = ",".join(f'{k}="{x}"' for k, x in v["labels"].items())
                key = f"{name}{{{lab}}}" if lab else name
                require(parsed[key] == v["value"], f"9a Prometheus text: {key}")
        elif m["type"] == "histogram":
            for v in m["values"]:
                lab = ",".join(f'{k}="{x}"' for k, x in v["labels"].items())
                key = f"{name}_count{{{lab}}}" if lab else f"{name}_count"
                require(parsed[key] == v["count"], f"9a Prometheus text: {key}")
    path = ROOT / "experiments" / "phase9_metrics.json"
    path.parent.mkdir(exist_ok=True)
    doc = obs.write_json_snapshot(str(path), extra={"phase": "9a"})
    require(json.loads(path.read_text())["metrics"] == obs.REGISTRY.snapshot() == doc["metrics"],
            "9a the JSON snapshot differs from snapshot()")
    log(f"9a registry: {len(snap)} metrics, {len(parsed)} Prometheus series round-trip through "
        f"parse_prometheus; the JSON snapshot ({path.relative_to(ROOT)}) equals snapshot()")
    on, off = [], []
    try:
        for _ in range(5):
            obs.enable()
            on += warm_ms(lambda: eng.match_many(queries), dev, 1)
            obs.disable()
            off += warm_ms(lambda: eng.match_many(queries), dev, 1)
    finally:
        obs.enable()
    log(f"9a warm match_many (loop probe, host join), interleaved: obs on {fmt(on)} ms, obs "
        f"off {fmt(off)} ms; medians {np.median(on):.3f} / {np.median(off):.3f}")


def phase9b_server(dev, ctx: dict, out: dict) -> None:
    """``MatchServer``: 64 requests (phase 3's 16 queries x 4, shuffled),
    ``max_batch`` 8, cost-ranked ticks, 4 update ticks of 2 coalesced
    edge-churn batches; every answer against ``match_many`` at its epoch."""
    import torch

    from repro_torch.kernels.dominance_scan.ref import dominance_scan_pairs_indexed_ref
    from repro_torch.serve import MatchServeConfig, MatchServer

    eng, queries = ctx["eng"], ctx["queries"]
    rng = np.random.default_rng(0)
    stream = [int(i) for i in rng.permutation(np.repeat(np.arange(len(queries)), 4))]
    srv = MatchServer(eng, MatchServeConfig(max_batch=8, schedule="cost"))
    upd_rng = np.random.default_rng(9)
    chunk = len(stream) // 4
    drive_s, n_checked, seen = 0.0, 0, None
    for k in range(4):
        for _ in range(2):
            srv.submit_update(rand_update(upd_rng, eng.graph))
        rids = [(srv.submit(queries[qi]), qi) for qi in stream[k * chunk:(k + 1) * chunk]]
        reset_counters()
        t = time.perf_counter()
        if k == 0:  # one tick's verdicts recorded on their real operands
            seen = recorded_verdicts(srv.step)
        srv.run_until_drained()
        sync(dev)
        drive_s += time.perf_counter() - t
        c = counters()
        out["K1"] += c["K1"]
        out["server_K1"] = out.get("server_K1", 0) + c["K1"]
        require(c["K1"] > 0, f"9b round {k}: K1 never launched")
        want = eng.match_many(queries)
        for rid, qi in rids:
            require(srv.finished[rid] == want[qi],
                    f"9b round {k}: request {rid} (query {qi}) differs from match_many at epoch "
                    f"{eng.epoch}")
            n_checked += 1
    require(seen, "9b the recorded tick made no verdict")
    for a, keep in seen:
        require(torch.equal(keep, dominance_scan_pairs_indexed_ref(*a)),
                "9b K1 on a server tick's pairs differs from the plain version")
    n = check_against_vf2(eng.graph, queries, want, "9b last epoch")
    lat = [srv.latency_s[r] * 1e3 for r in srv.latency_s]
    ticks = [t["wall_s"] * 1e3 for t in srv.tick_stats]
    require(srv.n_updates_applied == 8 and len(srv.update_s) == 4, "9b updates not coalesced 2 a tick")
    log(f"9b MatchServer: {n_checked} answers equal match_many at their epoch ({eng.epoch}), the "
        f"last epoch's {n} matches equal VF2's; {len(stream)} requests in {drive_s:.3f} s = "
        f"{len(stream) / drive_s:.3f} qps (update ticks included); per request (submit to "
        f"answer, host clock) p50 {p50_p95(lat)[0]:.3f} ms, p95 {p50_p95(lat)[1]:.3f} ms; "
        f"{len(ticks)} query ticks p50 {p50_p95(ticks)[0]:.3f} ms, p95 {p50_p95(ticks)[1]:.3f} ms; "
        f"{srv.n_updates_applied} updates coalesced into {len(srv.update_s)} epochs "
        f"({fmt([s * 1e3 for s in srv.update_s])} ms); K1 launches {out['server_K1']}, one "
        f"tick's {len(seen)} verdicts (T = {sum(verdict_pairs(a) for a, _ in seen)}) equal to plain")


def phase9c_standing(dev, ctx: dict, out: dict) -> None:
    """4 subscriptions through the server over 6 churn epochs (5 of 4 + 4
    edges; the sixth removes one edge that no partition holding a candidate
    of the least spread subscription reaches): after each epoch every
    accumulated set against a from-scratch ``match_many``; the fresh-row
    probe's K1 against its plain version; no probe for an unaffected
    subscription."""
    from repro_torch.core import GnnPeEngine, GraphUpdate
    from repro_torch.kernels.dominance_scan import ops as ds
    from repro_torch.serve import MatchServer

    eng, queries = ctx["eng"], ctx["queries"]
    srv = MatchServer(eng)
    sub_qs = queries[:4]
    sids = [srv.subscribe(q) for q in sub_qs]
    work: list = []  # (query index, last_work, K1 launches) per match_incremental

    def counted(q, state=None):
        before = ds.LAUNCHES
        res = GnnPeEngine.match_incremental(eng, q, state)
        work.append((next(i for i, s in enumerate(sub_qs) if s is q), res[0].last_work,
                     ds.LAUNCHES - before))
        return res

    eng.match_incremental = counted
    rng = np.random.default_rng(23)
    launches, verdict_T = 0, 0
    try:
        for ep in range(6):
            upd = rand_update(rng, eng.graph)
            if ep == 5:
                states = [srv.registry.subscription(sid).state for sid in sids]
                aside = min(range(len(sids)), key=lambda i: len(states[i].contributing))
                near = [eng.models[mi].vertex_set for mi in states[aside].contributing]
                e = eng.graph.edge_array()
                far = e[~np.isin(e, np.concatenate(near) if near else []).any(axis=1)]
                require(far.shape[0] > 0, "9c no edge lies outside the subscription's partitions")
                upd = GraphUpdate(remove_edges=far[rng.integers(far.shape[0])][None])
            srv.submit_update(upd)
            reset_counters()
            with DeltaScanProbe() as probe:
                srv.apply_update_tick()
            sync(dev)
            c = counters()
            out["K1"] += c["K1"]
            launches += c["K1"]
            probe.check(f"9c epoch {ep + 1}")
            verdict_T += probe.pairs
            want = eng.match_many(sub_qs)
            for sid, q, w in zip(sids, sub_qs, want):
                acc: set = set()
                for d in srv.match_deltas[sid]:
                    acc = (acc - set(d.retracted)) | set(d.added)
                require(acc == set(w), f"9c epoch {ep + 1}: subscription {sid} differs from "
                        "a from-scratch match_many")
    finally:
        del eng.match_incremental
    rungs = {w for _, w, _ in work}
    require(work[-len(sids) + aside][:2] == (aside, "skip"),
            f"9c the last epoch did not leave subscription {aside} aside: {work[-len(sids):]}")
    skips = [n for _, w, n in work if w == "skip"]
    incr = [n for _, w, n in work if w == "incremental"]
    require(incr and sum(incr) > 0, "9c the fresh-row probe never launched K1")
    require(skips, "9c no subscription was left untouched by an epoch: the check is vacuous")
    require(all(n == 0 for n in skips), "9c an unaffected subscription launched K1")
    log(f"9c standing: {len(sids)} subscriptions over 6 epochs, accumulated sets equal "
        f"from-scratch after each; steps {len(work)}: {len(incr)} incremental ({sum(incr)} K1 "
        f"launches, verdicts T = {verdict_T} in all, equal to plain), {len(skips)} skipped with "
        f"no launch, rungs {sorted(rungs)}; registry {srv.registry.stats()}; K1 launches in the "
        f"subscription ticks {launches}")


def phase9d_service(dev, ctx: dict, out: dict) -> None:
    """``MatchService`` over a ``FlakyEngine``: two tenants, seeded
    transient faults, one hang past the attempt time-out, one poisoned
    query; every ok answer byte-identical to the fault-free one, the
    statuses summing to the requests submitted."""
    import asyncio

    from repro_torch.graphs import random_connected_query
    from repro_torch.serve import FaultSpec, FlakyEngine, MatchService, ServiceConfig

    eng, queries = ctx["eng"], ctx["queries"]
    poisoned = random_connected_query(eng.graph, 8, seed=999)
    want = eng.match_many(queries, probe_impl="stacked")
    # seed 10's draws: call 1 draws 0.956 (no transient, so the planned hang
    # runs), call 2 draws 0.208 (a transient); fifo ticks keep the poisoned
    # request, submitted last, out of every call before its own
    flaky = FlakyEngine(eng, FaultSpec(p_transient=0.25, seed=10, hang_on=(1,), hang_s=2.5,
                                       poison=lambda q: q is poisoned))
    svc = MatchService(flaky, ServiceConfig(
        max_batch=8, probe_impl="stacked", schedule="fifo", attempt_timeout_s=2.0,
        max_retries=10, backoff_base_s=0.01, backoff_max_s=0.05, idle_tick_s=0.02,
        cache_fastpath=False,
    ))
    order = [(i % len(queries), "a" if i % 2 else "b") for i in range(2 * len(queries))]

    async def run():
        await svc.start()
        futs = [svc.submit(queries[qi], tenant=t)[1] for qi, t in order]
        futs.append(svc.submit(poisoned, tenant="a")[1])
        resps = await asyncio.gather(*futs)
        await svc.stop()
        return resps

    reset_counters()
    t = time.perf_counter()
    resps = asyncio.run(asyncio.wait_for(run(), 300))
    sync(dev)
    wall = time.perf_counter() - t
    c = counters()
    out["K1"] += c["K1"]
    require(c["K1"] > 0, "9d K1 never launched")
    poison_resp = resps.pop()
    require(poison_resp.status == "error" and "PoisonedQueryError" in poison_resp.reason,
            f"9d the poisoned request ended {poison_resp.status}: {poison_resp.reason}")
    for (qi, tenant), r in zip(order, resps):
        require(r.ok, f"9d query {qi} of tenant {tenant} ended {r.status}: {r.reason}")
        require(repr(r.matches) == repr(want[qi]), f"9d query {qi}: differs from the fault-free answer")
    cnt = svc.counters
    statuses = ("ok", "rejected", "shed", "expired", "error", "retry-exhausted")
    require(sum(cnt[s] for s in statuses) == cnt["submitted"] == len(order) + 1,
            f"9d the statuses do not sum to the requests submitted: {dict(cnt)}")
    require(cnt["error"] == 1 and cnt["attempt_timeouts"] >= 1 and flaky.n_transient >= 1,
            f"9d the fault schedule did not fire as planned: {dict(cnt)}")
    lat = [r.latency_s * 1e3 for r in resps]
    log(f"9d MatchService (stacked probe, host join), tenants a / b: {len(resps)} ok of "
        f"{cnt['submitted']} submitted in {wall:.3f} s, each byte-identical to the fault-free "
        f"answer, the poisoned request alone quarantined; {flaky.n_transient} transient faults, "
        f"{flaky.n_hangs} hang of 2.5 s, {cnt['attempt_timeouts']} attempt time-outs, "
        f"{cnt['retries']} retries over {flaky.n_calls} engine calls; per request p50 "
        f"{p50_p95(lat)[0]:.3f} ms, p95 {p50_p95(lat)[1]:.3f} ms; statuses "
        + ", ".join(f"{s} {cnt[s]}" for s in statuses) + f"; K1 launches {c['K1']}")


def phase9_serving(dev, ctx: dict, eng_g) -> dict:
    """Phase 9 (the module doc): the serving tier over phase 3's engine."""
    out = {"K1": 0, "K2": 0}
    for name, fn, args in (
        ("9a observability", phase9a_obs, (dev, ctx, eng_g, out)),
        ("9b MatchServer", phase9b_server, (dev, ctx, out)),
        ("9c standing queries", phase9c_standing, (dev, ctx, out)),
        ("9d MatchService under faults", phase9d_service, (dev, ctx, out)),
    ):
        t = time.perf_counter()
        fn(*args)
        log(f"  {name}: {time.perf_counter() - t:.3f} s")
    return out


# ---- phase 10 ---------------------------------------------------------------


def cluster_cell_inputs(n: int = 10_000):
    """``benchmarks/bench_cluster.py --full``'s cell with ``benchmarks/common.py``'s
    defaults → (graph, queries, engine config): NWS n = 10,000, k = 4, p =
    0.1, 100 labels, seed 23; 40 partitions of 250 vertices; l = 2, d = 2,
    n_multi = 2, monotone; the stacked probe; 10 queries of 8 vertices from
    seed 700."""
    from repro_torch.core import GnnPeConfig, TrainConfig
    from repro_torch.graphs import newman_watts_strogatz, random_connected_query

    g = newman_watts_strogatz(n, k=4, p=0.1, n_labels=100, seed=23)
    queries = []
    for s in range(10):
        try:
            queries.append(random_connected_query(g, 8, seed=700 + s))
        except RuntimeError:
            continue
    cfg = GnnPeConfig(path_length=2, emb_dim=2, n_multi=2, n_partitions=n // 250,
                      encoder="monotone", train=TrainConfig(max_epochs=150),
                      probe_impl="stacked")
    return g, queries, cfg


def cluster_worker(root: str, addr: str) -> int:
    """Phase 10e's worker process (``chip_smoke.py --cluster-worker ROOT
    ADDR``): joins the gloo group, builds a replica of the cluster cell's
    engine on the card (the monotone encoder and the seeds make it the
    coordinator's, bit for bit) and serves host 1 over the exchange
    directory until the coordinator's stop blob."""
    import torch

    from repro_torch.core import GnnPeEngine
    from repro_torch.dist import DirExchange, init_distributed, serve_exchange_host

    boot = init_distributed(num_processes=2, process_id=1, coordinator_address=addr,
                            timeout_s=120.0)
    g, _, cfg = cluster_cell_inputs()
    eng = GnnPeEngine(cfg).build(g)
    n = serve_exchange_host(eng, 1, DirExchange(root), timeout=600.0)
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    print(f"WORKER_OK {boot['mode']} {n}", flush=True)
    return 0


def counted(out: dict, fn):
    """``fn()`` with every launch count set to 0 just before it; its K1 and K2
    launches add to ``out`` → (result, counts)."""
    reset_counters()
    res = fn()
    c = counters()
    out["K1"] += c["K1"]
    out["K2"] += c["K2"]
    return res, c


def plan_requests(eng, queries) -> list:
    """Every (query, plan path) of a deg-planned batch."""
    plans = [eng._deg_plan_cached(q) for q in queries]
    return list(dict.fromkeys((qi, p) for qi, pl in enumerate(plans) for p in pl.paths))


def phase10a_50k(dev, ctx: dict, smi: str, out: dict) -> None:
    """The 50K cell at full width through ``ClusterEngine``: phase 3's engine
    (loop probe, host join, phase 9's deltas pending) and two stacked-probe
    engines (host join, device join), each at 1, 2 and 4 local hosts, every
    list equal to the engine's own ``match_many``; a rebalance, K1 on every
    host's subset probe and equal to plain on one host's real pairs, a host
    loss, and warm ms interleaved with single-process."""
    import torch

    from repro_torch.core import GnnPeEngine, sort_matches
    from repro_torch.dist import ClusterEngine
    from repro_torch.kernels.dominance_scan.ref import dominance_scan_pairs_indexed_ref

    g, queries = ctx["g"], ctx["queries"]
    want_sets = [sort_matches(m) for m in ctx["matches"]]
    engines = [("loop probe, host join (phase 3's engine after phase 9)", ctx["eng"])]
    for join in ("numpy", "device"):
        t = time.perf_counter()
        eng = GnnPeEngine(dataclasses.replace(ctx["cfg"], probe_impl="stacked",
                                              join_impl=join)).build(g)
        sync(dev)
        log(f"10a stacked-probe engine for the {join} join: build {time.perf_counter() - t:.3f} s")
        engines.append((f"stacked probe, {'host' if join == 'numpy' else 'device'} join", eng))
    clusters = {}
    for what, eng in engines:
        single, _ = counted(out, lambda: eng.match_many(queries))
        ds = eng.delta_stats()
        for n_hosts in (1, 2, 4):
            cl = ClusterEngine(eng, n_hosts=n_hosts)
            got, c = counted(out, lambda: cl.match_many(queries))
            require(got == single, f"10a {what}, {n_hosts} hosts: lists differ from match_many")
            require(c["K1"] > 0, f"10a {what}, {n_hosts} hosts: K1 never launched")
            require(eng.cfg.join_impl != "device" or c["K2"] > 0,
                    f"10a {what}, {n_hosts} hosts: the coordinator's device join never ran K2")
        place = cl.rebalance()  # after a warm batch: the probe counters are live
        require(place.balanced() and all(h.owned for h in cl.hosts),
                f"10a {what}: the rebalanced placement is off its bound or leaves a host idle")
        got, _ = counted(out, lambda: cl.match_many(queries))
        require(got == single, f"10a {what}: lists after the rebalance differ")
        if eng is ctx["eng"]:
            n = check_against_vf2(eng.graph, queries, got, f"10a {what}")
        else:
            require([sort_matches(m) for m in got] == want_sets, f"10a {what}: sets differ")
            n = sum(len(m) for m in got)
        clusters[what] = (eng, cl, single)
        log(f"10a {what}: lists equal match_many at 1, 2 and 4 hosts (delta rows "
            f"{ds.get('delta_rows', 0)}, tombstones {ds.get('tombstones', 0)}), sets equal VF2's "
            f"({n} matches); rebalanced loads {[round(x) for x in place.loads]} within the bound "
            f"{place.bound:.0f}, owned {[len(h.owned) for h in cl.hosts]}")
    eng, cl, single = clusters["stacked probe, host join"]
    reqs = plan_requests(eng, queries)
    per_host = []
    for host in cl.hosts:
        _, c = counted(out, lambda: host.probe(queries, reqs))
        require(c["K1"] > 0, f"10a host {host.host_id}'s subset probe never launched K1")
        per_host.append(c["K1"])
    seen = recorded_verdicts(lambda: counted(
        out, lambda: eng.probe_candidates(queries, reqs, parts=cl.hosts[0].owned)))
    for args, keep in seen:
        require(torch.equal(keep, dominance_scan_pairs_indexed_ref(*args)),
                "10a K1 on host 0's subset-probe pairs differs from the plain version")
    lost = ClusterEngine(eng, n_hosts=2)
    lost.hosts[1].fail_next = True
    got, _ = counted(out, lambda: lost.match_many(queries))
    require(got == single and lost.stats["host_losses"] == 1,
            f"10a a lost host changed the lists or was not counted ({lost.stats})")
    log(f"10a subset probes: K1 launches per host {per_host}; host 0's {len(seen)} verdicts "
        f"(T = {sum(verdict_pairs(a) for a, _ in seen)}) equal to plain; a host lost mid-gather "
        f"re-probed by the coordinator, lists equal, host_losses {lost.stats['host_losses']}")
    for what, (eng, _, single) in list(clusters.items())[1:]:
        cls = {h: ClusterEngine(eng, n_hosts=h) for h in (1, 2, 4)}
        for c_ in cls.values():
            c_.rebalance()
        times = {k: [] for k in ("single", 1, 2, 4)}
        for _ in range(3):
            times["single"] += warm_ms(lambda: eng.match_many(queries), dev, 1)
            for h, c_ in cls.items():
                times[h] += warm_ms(lambda: c_.match_many(queries), dev, 1)
        prof = profile_counts(lambda: cls[4].match_many(queries), dev)
        log(f"10a warm ms, {what}, interleaved ({smi}): single-process {fmt(times['single'])}; "
            f"1 host {fmt(times[1])}; 2 hosts {fmt(times[2])}; 4 hosts {fmt(times[4])}; "
            f"profiled 4-host call: {prof['wall']:.3f} ms wall, device busy {prof['busy']:.3f} ms "
            f"in {prof['launches']} kernel launches, {prof['dtoh']} device-to-host copies; "
            f"scatter rounds {cls[4].stats['scatter_rounds']}")


def interior_edges(g, members, k: int, skip: set) -> np.ndarray:
    """Up to ``k`` not yet deleted edges with both ends in one partition's
    members (``bench_cluster.py``'s partition-local deletion batch)."""
    mset = set(int(v) for v in members)
    found = []
    for u, v in g.edge_array().tolist():
        if u in mset and v in mset and (u, v) not in skip:
            found.append((u, v))
            if len(found) == k:
                break
    return np.array(found, np.int64).reshape(-1, 2)


def phase10b_cache(dev, out: dict) -> dict:
    """``bench_cluster.py --full``'s cache phase: a 4-host cluster with the
    sharded cache (capacity 256) through 8 partition-local deletion epochs
    of 2 edges, every epoch's sets equal to ``match_many``'s, evictions on
    the owner shards only."""
    from repro_torch.core import GnnPeEngine, GraphUpdate, sort_matches
    from repro_torch.dist import ClusterEngine

    g, queries, cfg = cluster_cell_inputs()
    t = time.perf_counter()
    eng = GnnPeEngine(cfg).build(g)
    sync(dev)
    log(f"10b cluster cell: {g.n_vertices} vertices, {len(eng.models)} partitions, "
        f"{len(queries)} queries; build {time.perf_counter() - t:.3f} s")
    cl = ClusterEngine(eng, n_hosts=4, cache_capacity=256)
    first, _ = counted(out, lambda: cl.match_many(queries))
    require(first == eng.match_many(queries), "10b the cold cluster batch differs from match_many")
    deleted: set = set()
    served = []
    for epoch in range(8):
        mi = epoch % len(eng.models)
        rem = interior_edges(eng.graph, eng.models[mi].members, 2, deleted)
        require(rem.size > 0, f"10b partition {mi} has no interior edge left")
        deleted.update((int(u), int(v)) for u, v in rem)
        cl.apply_updates(GraphUpdate(remove_edges=rem))
        t = time.perf_counter()
        got, _ = counted(out, lambda: cl.match_many(queries))
        sync(dev)
        served.append((time.perf_counter() - t) * 1e3)
        require([sort_matches(m) for m in got] == [sort_matches(m) for m in eng.match_many(queries)],
                f"10b epoch {epoch}: the cluster's sets differ from match_many's")
    loc, st = cl.cache.locality(), cl.cache.stats_dict()
    require(loc["remote_evictions"] == 0 and loc["local_evictions"] > 0,
            f"10b the evictions left the owner shards: {loc}")
    log(f"10b sharded cache over 8 deletion epochs: hit rate {st['hit_rate']:.3f} (hits "
        f"{st['hits']}, misses {st['misses']}), evictions local {loc['local_evictions']}, remote "
        f"{loc['remote_evictions']}, lazy {loc['lazy_evictions']}; shard sizes "
        f"{st['shard_sizes']}; served batches {fmt(served)} ms")
    return {"eng": eng, "cl": cl, "queries": queries, "g": g, "cfg": cfg}


def index_equal(a, b) -> bool:
    """Two packed indexes field for field (the group sidecar included)."""
    import torch

    def same(x, y):
        return (x is None and y is None) or (x is not None and y is not None and torch.equal(x, y))

    if not all(same(getattr(a, k), getattr(b, k))
               for k in ("paths", "emb", "emb0", "emb_multi", "emb_q", "label_hash")):
        return False
    if len(a.levels) != len(b.levels) or any(
        not same(la[k], lb[k]) for la, lb in zip(a.levels, b.levels)
        for k in ("mbr", "mbr0", "mbr_multi")
    ):
        return False
    if (a.groups is None) != (b.groups is None):
        return False
    return a.groups is None or all(
        same(getattr(a.groups, k), getattr(b.groups, k))
        for k in ("group_start", "mbr_hi", "mbr0", "block_group_start")
    )


def phase10c_blue_green(dev, cell: dict, out: dict) -> None:
    """Blue-green on 10b's engine (its deletions pending): the generation
    persisted through ``CheckpointManager``, read back field-equal, the
    buffers drained and the sets unchanged; an update between snapshot and
    install refuses the install; a bit-flipped step raises."""
    import tempfile

    from repro_torch.core import sort_matches
    from repro_torch.dist import ClusterEngine, CorruptCheckpointError
    from repro_torch.dist.checkpoint import CheckpointManager

    eng, cl, queries = cell["eng"], cell["cl"], cell["queries"]
    plain = ClusterEngine(eng, n_hosts=4)
    before, _ = counted(out, lambda: plain.match_many(queries))
    pending = eng.delta_stats()
    require(pending["tombstones"] > 0, "10c no tombstone pending before the swap")
    with tempfile.TemporaryDirectory() as root:
        store = CheckpointManager(root)
        t = time.perf_counter()
        res = cl.rebuild_generation(store=store)
        sync(dev)
        swap_ms = (time.perf_counter() - t) * 1e3
        require(res["installed"] and store.latest_step() == res["generation"],
                f"10c the generation was not installed and persisted: {res}")
        ds = eng.delta_stats()
        require(ds["delta_rows"] == 0 and ds["tombstones"] == 0, "10c the swap left deltas")
        after, _ = counted(out, lambda: plain.match_many(queries))
        require([sort_matches(m) for m in after] == [sort_matches(m) for m in before],
                "10c the swap changed a match set")
        require(after == eng.match_many(queries), "10c lists after the swap differ from match_many")
        t = time.perf_counter()
        loaded = cl.load_generation(store)
        load_ms = (time.perf_counter() - t) * 1e3
        require(loaded["generation"] == res["generation"] and all(
            index_equal(ix, m.index) for ix, m in zip(loaded["indexes"], eng.models)),
            "10c load_generation's indexes differ from the installed ones")
        snap = eng.prepare_generation()
        built = eng.build_generation(snap)
        cl.apply_updates(rand_update(np.random.default_rng(10), eng.graph, 2))
        require(eng.install_generation(snap, built) is False,
                "10c an install after a newer epoch was not refused")
        path = store._path(res["generation"])
        data = bytearray(path.read_bytes())
        data[len(data) // 2] ^= 0x20
        path.write_bytes(bytes(data))
        try:
            cl.load_generation(store, generation=res["generation"])
            raise AssertionError("10c a bit-flipped generation loaded")
        except CorruptCheckpointError:
            pass
    log(f"10c blue-green: generation {res['generation']} built, persisted and installed in "
        f"{swap_ms:.3f} ms (pending before: {pending['delta_rows']} buffer rows, "
        f"{pending['tombstones']} tombstones, drained), read back field-equal in {load_ms:.3f} ms; "
        "sets unchanged, lists equal match_many; a stale install refused; a bit-flipped step "
        "raised CorruptCheckpointError")


def phase10d_router(dev, cell: dict, out: dict) -> None:
    """``ClusterRouter`` over a 4-host cluster with the sharded cache: 32
    requests in 4 ticks of 8, two of them after an update; every answer
    equal to a cache-less ``ClusterEngine.match_many`` at its epoch."""
    from repro_torch.dist import ClusterEngine
    from repro_torch.serve import ClusterRouter

    eng, queries = cell["eng"], cell["queries"]
    rt = ClusterRouter(ClusterEngine(eng, n_hosts=4, cache_capacity=256), max_batch=8)
    check = ClusterEngine(eng, n_hosts=4)
    rng = np.random.default_rng(0)
    order = [queries[int(i)] for i in rng.integers(0, len(queries), 32)]
    asked = {}
    ticks = []
    t0 = time.perf_counter()
    for rnd in range(4):
        if rnd in (1, 3):
            rt.submit_update(rand_update(rng, eng.graph, 2))
        for q in order[8 * rnd : 8 * rnd + 8]:
            asked[rt.submit(q)] = q
        done = set(rt.finished)
        t = time.perf_counter()
        n, _ = counted(out, rt.step)
        sync(dev)
        ticks.append((time.perf_counter() - t) * 1e3)
        new = [r for r in rt.finished if r not in done]
        require(n == 8 and len(new) == 8, f"10d tick {rnd} served {n}")
        want, _ = counted(out, lambda: check.match_many([asked[r] for r in new]))
        require([rt.finished[r] for r in new] == want,
                f"10d tick {rnd}: an answer differs from ClusterEngine.match_many at its epoch")
    wall = time.perf_counter() - t0
    st = rt.stats()
    lat = [v * 1e3 for v in rt.latency_s.values()]
    rt.close()
    log(f"10d ClusterRouter: 32 requests in 4 ticks (2 after an update), every answer equal "
        f"to ClusterEngine.match_many at its epoch; ticks {fmt(ticks)} ms; per request p50 "
        f"{p50_p95(lat)[0]:.3f} ms, p95 {p50_p95(lat)[1]:.3f} ms; cache hit rate "
        f"{st['cache']['hit_rate']:.3f}; epoch {eng.epoch}; {wall:.3f} s with the checks")


def phase10e_two_process(dev, root: str, worker, boot_thread, boot: dict, out: dict) -> None:
    """Two processes on one card: this process coordinates ``LocalHost(0)``
    and ``ExchangeHost(1)``, the worker serves host 1 from its replica of
    the cluster cell; the lists equal single-process ``match_many`` and the
    worker's candidates equal this process's own ``probe_candidates``."""
    from repro_torch.core import GnnPeEngine
    from repro_torch.dist import ClusterEngine, DirExchange, ExchangeHost, LocalHost

    g, queries, cfg = cluster_cell_inputs()
    eng = GnnPeEngine(cfg).build(g)
    single, _ = counted(out, lambda: eng.match_many(queries))
    boot_thread.join(timeout=150)
    require(not boot_thread.is_alive(), "10e init_distributed never returned")
    remote = ExchangeHost(1, DirExchange(root), timeout=300.0)
    cl = ClusterEngine(eng, hosts=[LocalHost(0, eng), remote])
    require(remote.owned, "10e placement left the worker idle")
    t = time.perf_counter()
    got, _ = counted(out, lambda: cl.match_many(queries))
    ms = (time.perf_counter() - t) * 1e3
    require(got == single and cl.stats["host_losses"] == 0,
            f"10e the two-process lists differ from match_many ({cl.stats})")
    reqs = plan_requests(eng, queries)
    theirs = remote.probe(queries, reqs)
    mine, _ = counted(out, lambda: eng.probe_candidates(queries, reqs, parts=remote.owned))
    require(list(theirs) == list(mine) and all(
        np.array_equal(a, b) for k in mine for a, b in zip(theirs[k], mine[k])),
        "10e the worker's candidates differ from this process's for the same parts")
    cl.shutdown()
    rc = worker.wait(timeout=120)
    w_out = (Path(root) / "worker.out").read_text()
    require(rc == 0 and "WORKER_OK" in w_out,
            f"10e the worker ended {rc}: {w_out[-2000:]}"
            f"{(Path(root) / 'worker.err').read_text()[-2000:]}")
    log(f"10e two processes on one card: init_distributed mode {boot.get('mode')} "
        f"({boot.get('error', 'gloo group of 2')}); worker: {w_out.strip()}; lists equal "
        f"match_many ({ms:.3f} ms, cold on the worker's side); the worker's {len(theirs)} "
        f"candidate entries equal this process's for parts {remote.owned}")


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def timed_step(name: str, fn, *args):
    t = time.perf_counter()
    res = fn(*args)
    log(f"  {name}: {time.perf_counter() - t:.3f} s")
    return res


def phase10_cluster(dev, ctx: dict, smi: str) -> dict:
    """Phase 10 (the module doc): the cluster tier on one card."""
    import tempfile
    import threading

    import torch

    from repro_torch.dist import init_distributed

    out = {"K1": 0, "K2": 0}
    addr = f"127.0.0.1:{free_port()}"
    with tempfile.TemporaryDirectory() as root:
        # the worker starts first: its start-up and build overlap 10a-d
        with open(Path(root) / "worker.out", "w") as wo, open(Path(root) / "worker.err", "w") as we:
            worker = subprocess.Popen(
                [sys.executable, str(ROOT / "chip_smoke.py"), "--cluster-worker", root, addr],
                stdout=wo, stderr=we,
            )
        boot: dict = {}
        boot_thread = threading.Thread(
            target=lambda: boot.update(init_distributed(2, 0, addr, timeout_s=120.0)), daemon=True
        )
        boot_thread.start()
        try:
            timed_step("10a the 50K cell through ClusterEngine", phase10a_50k, dev, ctx, smi, out)
            cell = timed_step("10b the cluster cell's sharded cache", phase10b_cache, dev, out)
            timed_step("10c blue-green generations", phase10c_blue_green, dev, cell, out)
            timed_step("10d ClusterRouter", phase10d_router, dev, cell, out)
            timed_step("10e two processes", phase10e_two_process, dev, root, worker, boot_thread,
                       boot, out)
        finally:
            if worker.poll() is None:
                worker.kill()
                worker.wait()
            if torch.distributed.is_initialized():
                torch.distributed.destroy_process_group()
    return out


# ---- phase 11 ---------------------------------------------------------------

# the crash sweep's kill points at the JAX package's tests' ``at`` values
KILL_SWEEP = (("before_log", 3), ("after_log", 5), ("after_apply", 4), ("mid_snapshot", 2),
              ("after_snapshot", 2))
SWEEP_CONFIGS = {"path-loop": dict(index_kind="path", probe_impl="loop"),
                 "grouped-stacked": dict(index_kind="grouped", probe_impl="stacked")}


def durability_cell_inputs():
    """``benchmarks/bench_durability.py --full``'s cell with ``benchmarks/common.py``'s
    defaults → (graph, queries, engine config, update stream): NWS n = 4,000, k = 4,
    p = 0.1, 100 labels, seed 11; 4 partitions of 1,000 vertices; l = 2, d = 2,
    n_multi = 2, monotone; 6 queries of 8 vertices from seed 300; 10 epochs of 4
    random edges added and 2 removed, from ``default_rng(7)``."""
    from repro_torch.core import GnnPeConfig, GraphUpdate, TrainConfig
    from repro_torch.graphs import newman_watts_strogatz, random_connected_query

    g = newman_watts_strogatz(4000, k=4, p=0.1, n_labels=100, seed=11)
    queries = []
    for s in range(6):
        try:
            queries.append(random_connected_query(g, 8, seed=300 + s))
        except RuntimeError:
            continue
    cfg = GnnPeConfig(path_length=2, emb_dim=2, n_multi=2, n_partitions=4, encoder="monotone",
                      train=TrainConfig(max_epochs=150))
    rng = np.random.default_rng(7)
    stream = []
    for _ in range(10):
        e = g.edge_array()
        stream.append(GraphUpdate(add_edges=rng.integers(0, g.n_vertices, size=(4, 2)),
                                  remove_edges=e[rng.choice(e.shape[0], size=2, replace=False)]))
    return g, queries, cfg, stream


def recorded_k1_verdicts(fn) -> list:
    """Every fused leaf verdict of one ``fn()`` call, the probe's and the delta
    buffers' scan: (where, (segments, eps), keep)."""
    from repro_torch.core import delta as delta_mod
    from repro_torch.core import index as index_mod

    seen = []
    saved = index_mod._pairs_keep_mask, delta_mod._pairs_keep_mask

    def recording(where, keep_mask):
        def record(*a):
            res = keep_mask(*a)
            seen.append((where, a, res))
            return res
        return record

    index_mod._pairs_keep_mask = recording("probe", saved[0])
    delta_mod._pairs_keep_mask = recording("delta scan", saved[1])
    try:
        fn()
    finally:
        index_mod._pairs_keep_mask, delta_mod._pairs_keep_mask = saved
    return seen


def time_appends(dur, sink: list) -> None:
    """Record the seconds of each of ``dur``'s WAL appends (framing, write,
    flush and fsync) in ``sink``."""
    append = dur.wal.append

    def timed(*a, **kw):
        t = time.perf_counter()
        append(*a, **kw)
        sink.append(time.perf_counter() - t)

    dur.wal.append = timed


def durable_stream(srv, updates, crash_type) -> str | None:
    """Apply ``updates`` one tick each through ``srv`` until a simulated crash
    → the kill point it hit, or None."""
    for u in updates:
        srv.submit_update(u)
        try:
            srv.apply_update_tick()
        except crash_type as e:
            return e.point
    return None


def phase11a_durable_50k(dev, ctx: dict, smi: str, root: Path, out: dict) -> None:
    """The durable 50K cell: phase 3's engine and queries (loop probe, host
    join, the deltas of phases 9 and 10 pending) behind a ``MatchServer``
    with ``DurabilityConfig(snapshot_every=4)``; 10 epochs of
    ``bench_updates.py``'s churn with a crash after the 7th epoch's log;
    recovery on the card against a control restored from the genesis
    snapshot and given the same epochs."""
    import torch

    from repro_torch.core import apply_graph_update
    from repro_torch.durability import (
        CrashPoint,
        Durability,
        DurabilityConfig,
        SimulatedCrash,
        engine_fingerprint,
        recover_server,
    )
    from repro_torch.kernels.dominance_scan.ref import dominance_scan_pairs_indexed_ref
    from repro_torch.serve import MatchServeConfig, MatchServer

    eng, queries = ctx["eng"], ctx["queries"]
    cfg = DurabilityConfig(str(root / "11a"), snapshot_every=4)
    rng = np.random.default_rng(11)
    shadow, stream = eng.graph, []
    for _ in range(10):
        stream.append(rand_update(rng, shadow))
        shadow = apply_graph_update(shadow, stream[-1])[0]

    appends: list = []
    dur = Durability(cfg, crash=CrashPoint("after_log", at=7))
    time_appends(dur, appends)
    e0 = eng.epoch
    t = time.perf_counter()
    srv = MatchServer(eng, MatchServeConfig(max_batch=16, durability=dur))  # the genesis snapshot
    genesis_s = time.perf_counter() - t
    snap = dur.snapshots.last_save
    npz = dur.snapshots.mgr._path(e0).stat().st_size
    log(f"  11a genesis snapshot at epoch {e0}: {snap['bytes']} array bytes ({npz} on disk) in "
        f"{genesis_s:.3f} s (engine read back {snap['state_s']:.3f} s, write and verify "
        f"{snap['seconds'] - snap['state_s']:.3f} s); card: {smi}")
    t = time.perf_counter()
    control = dur.snapshots.load(step=e0, device=dev)[0]
    sync(dev)
    log(f"  11a the control restored from the genesis snapshot on the card: "
        f"{time.perf_counter() - t:.3f} s; card: {smi}")
    srv.submit_update(stream[0])
    for q in queries:
        srv.submit(q)
    srv.step()  # the first update tick, then the 16-query batch
    require(len(srv.finished) == len(queries), "11a: the server's first tick left queries queued")
    served = [srv.finished[r] for r in sorted(srv.finished)]
    point = durable_stream(srv, stream[1:], SimulatedCrash)
    require(point == "after_log", f"11a: the stream crashed at {point}, not after the 7th log")
    require(eng.epoch == e0 + 6, f"11a: the crash left epoch {eng.epoch - e0}, not 6")
    ticks = list(srv.update_s)
    del srv, eng
    ctx.pop("eng")
    torch.cuda.empty_cache()

    rec_srv, info = recover_server(cfg, MatchServeConfig(max_batch=16), device=dev)
    rec = rec_srv.engine
    time_appends(rec_srv.durability, appends)
    require(info["epoch"] == e0 + 7 and info["snapshot_epoch"] == e0 + 4,
            f"11a: recovered to epoch {info['epoch'] - e0} from snapshot "
            f"{info['snapshot_epoch'] - e0}, not 7 from 4")
    bare = []
    for u in stream[:7]:
        t = time.perf_counter()
        control.apply_updates([u])
        sync(dev)
        bare.append(time.perf_counter() - t)
        if len(bare) == 1:
            require(control.match_many(queries) == served,
                    "11a: the server's first batch differs from the control's")
    require(engine_fingerprint(rec) == engine_fingerprint(control),
            "11a: the recovered engine's fingerprint differs from the control's")
    lists = rec.match_many(queries)
    require(lists == control.match_many(queries),
            "11a: the recovered engine's lists differ from the control's")
    pending = rec.delta_stats()
    require(pending["delta_rows"] > 0, "11a: no delta rows pending after the replay")
    k1 = counters()["K1"]
    seen = recorded_k1_verdicts(lambda: rec.match_many(queries))
    launched = counters()["K1"] - k1
    t_pairs = {w: verdict_pairs(a) for w, a, _ in seen}
    require(set(t_pairs) == {"probe", "delta scan"} and min(t_pairs.values()) > 0
            and launched == len(seen) == 2,
            f"11a: the recovered batch made {launched} K1 launches for verdicts {t_pairs}")
    for where, (segs, eps), keep in seen:
        require(torch.equal(keep, dominance_scan_pairs_indexed_ref(segs, eps)),
                f"11a: K1 on the recovered batch's {where} differs from the plain version")
    for u in stream[7:]:
        rec_srv.submit_update(u)
        rec_srv.apply_update_tick()
        t = time.perf_counter()
        control.apply_updates([u])
        sync(dev)
        bare.append(time.perf_counter() - t)
    require(engine_fingerprint(rec) == engine_fingerprint(control),
            "11a: the fingerprints differ after the stream's last epoch")
    lists = rec.match_many(queries)
    require(lists == control.match_many(queries), "11a: the last epoch's lists differ")
    n_matches = check_against_vf2(rec.graph, queries, lists, "11a last epoch")
    require(len(appends) == 10, f"11a: {len(appends)} WAL appends, not 10")
    epoch_ms = [a * 1e3 for a in appends]
    build_s = float(rec.offline_stats["total_time"])
    log(f"  11a recovery on the card: {info['recovery_s']:.3f} s (verified load and restore "
        f"{info['load_s']:.3f} s, replay of {info['replayed']} epochs {info['replay_s']:.3f} s) "
        f"against the build's {build_s:.3f} s + the whole stream's 10 epochs "
        f"{sum(bare):.3f} s = {build_s + sum(bare):.3f} s; card: {smi}")
    log(f"  11a WAL appends (fsync) of the 10 epoch records: p50 {np.percentile(epoch_ms, 50):.3f} "
        f"ms, p95 {np.percentile(epoch_ms, 95):.3f} ms; bare apply_updates a churn epoch "
        f"{fmt([b * 1e3 for b in bare], 1)} ms; the WAL tax over bare apply_updates "
        f"{sum(appends) / sum(bare):.4%} (printed only); durable ticks "
        f"before the crash {fmt([x * 1e3 for x in ticks], 1)} ms; card: {smi}")
    log(f"  11a recovered == control (fingerprint and lists) at epochs 7 and 10; the last "
        f"epoch's {n_matches} matches equal VF2's; K1 on the recovered batch with "
        f"{pending['delta_rows']} delta rows and {pending['tombstones']} tombstones pending: "
        f"{launched} launches (T: {t_pairs}), each equal to the plain version; card: {smi}")
    out["rec_srv"] = rec_srv


def phase11b_sweep(dev, smi: str, root: Path, cell) -> None:
    """``bench_durability.py --full``'s cell: each kill point x {path-loop,
    grouped-stacked} recovered fingerprint-equal to its control; a torn tail
    and a bit-flipped newest snapshot recovered; ``recover_server`` with two
    subscriptions re-registering each once."""
    from repro_torch.core import GnnPeEngine
    from repro_torch.durability import (
        CrashPoint,
        Durability,
        DurabilityConfig,
        SimulatedCrash,
        engine_fingerprint,
        engine_state,
        flip_byte,
        recover_engine,
        recover_server,
        restore_engine,
        truncate_tail,
    )
    from repro_torch.durability.snapshot import _META_KEY
    from repro_torch.serve import MatchServeConfig, MatchServer

    g, queries, cfg, stream = cell
    stream = stream[:7]
    for name, kw in SWEEP_CONFIGS.items():
        eng = GnnPeEngine(dataclasses.replace(cfg, **kw)).build(g)
        meta, arrays = engine_state(eng)
        full = {**arrays, _META_KEY: np.asarray(json.dumps(meta))}
        del eng

        def fresh():
            return restore_engine(full, device=dev)[0]

        ctrl, controls = fresh(), {}
        for k, u in enumerate(stream, start=1):  # the control's state at every epoch
            ctrl.apply_updates([u])
            controls[k] = (engine_fingerprint(ctrl), ctrl.match_many(queries))
        del ctrl
        ok = []
        for point, at in KILL_SWEEP:
            d = root / f"11b-{name}-{point}"
            dur = Durability(DurabilityConfig(str(d), snapshot_every=3),
                             crash=CrashPoint(point, at=at))
            hit = durable_stream(MatchServer(fresh(), MatchServeConfig(durability=dur)), stream,
                                 SimulatedCrash)
            require(hit == point, f"11b {name}: the crash hit {hit}, not {point}")
            rec, info = recover_engine(DurabilityConfig(str(d), snapshot_every=3), device=dev)
            fp, lists = controls[info["epoch"]]
            require(engine_fingerprint(rec) == fp and rec.match_many(queries) == lists,
                    f"11b {name}/{point}@{at}: the recovered engine differs from its control")
            ok.append(f"{point}@{at} -> epoch {info['epoch']} (snapshot {info['snapshot_epoch']}, "
                      f"{info['replayed']} replayed, {info['recovery_s']:.3f} s)")
        log(f"  11b {name}: 5 of 5 kill points fingerprint-equal to the control: "
            + "; ".join(ok) + f"; card: {smi}")
        if name != "path-loop":
            continue
        d = root / "11b-torn"
        dur = Durability(DurabilityConfig(str(d), snapshot_every=0),
                         crash=CrashPoint("after_log", at=4))
        durable_stream(MatchServer(fresh(), MatchServeConfig(durability=dur)), stream,
                       SimulatedCrash)
        truncate_tail(sorted((d / "wal").glob("seg_*.wal"))[-1], 7)
        rec, info = recover_engine(DurabilityConfig(str(d)), device=dev)
        require(info["epoch"] == 3 and info["truncated_bytes"] > 0
                and engine_fingerprint(rec) == controls[3][0],
                "11b: the torn tail did not recover to epoch 3's state")
        # the newest snapshot (epoch 4) committed, the crash before its prune: the
        # WAL still holds epochs 3 and 4, which the fallback to snapshot 2 replays
        d = root / "11b-flip"
        dur = Durability(DurabilityConfig(str(d), snapshot_every=2),
                         crash=CrashPoint("after_snapshot", at=3))  # genesis, 2, then 4
        hit = durable_stream(MatchServer(fresh(), MatchServeConfig(durability=dur)), stream,
                             SimulatedCrash)
        require(hit == "after_snapshot", f"11b: the flip case crashed at {hit}")
        flip_byte(dur.snapshots.mgr._path(4), offset=-50)
        rec, info = recover_engine(DurabilityConfig(str(d), snapshot_every=2), device=dev)
        require(info["snapshot_epoch"] == 2 and info["epoch"] == 4
                and engine_fingerprint(rec) == controls[4][0],
                "11b: the bit-flipped newest snapshot did not fall back to epoch 2")
        log(f"  11b torn tail: recovered to epoch 3 (7 bytes cut); bit-flipped snapshot 4: "
            f"fell back to snapshot 2 and replayed {info['replayed']} epochs; both equal the "
            f"control; card: {smi}")
        d = root / "11b-subs"
        dur = Durability(DurabilityConfig(str(d), snapshot_every=3),
                         crash=CrashPoint("after_apply", at=5))
        srv = MatchServer(fresh(), MatchServeConfig(durability=dur))
        subs = [q for q, m in zip(queries, controls[7][1]) if m][:2] or queries[:2]
        sids = [srv.subscribe(q) for q in subs]
        durable_stream(srv, stream, SimulatedCrash)
        rec_srv, info = recover_server(DurabilityConfig(str(d), snapshot_every=3), device=dev)
        require(sorted(info["subscriptions"]) == sorted(sids), "11b: subscriptions lost")
        want = rec_srv.engine.match_many(subs)
        for sid, m in zip(sids, want):
            require(len(rec_srv.match_deltas[sid]) == 1
                    and rec_srv.standing_matches(sid) == sorted(set(m)),
                    f"11b: subscription {sid} was not re-registered once with the "
                    f"from-scratch set")
        log(f"  11b recover_server: {len(sids)} subscriptions re-registered once each at epoch "
            f"{info['epoch']}, sets of {[len(m) for m in want]} matches equal to "
            f"match_many's; card: {smi}")


def child_env() -> dict:
    """This process's environment with the repository's ``src`` first on the
    child's module path."""
    import os

    path = os.environ.get("PYTHONPATH")
    return {**os.environ, "PYTHONPATH": str(ROOT / "src") + (os.pathsep + path if path else "")}


def wal_child(args: list, err: Path, kill_epoch: int | None = None):
    """``examples/serve_queries_torch.py --wal`` in a child process, its
    standard error to ``err``; with ``kill_epoch`` a thread SIGKILLs it once
    that epoch's line is out → (process, thread, lines)."""
    import signal
    import threading

    with open(err, "w") as fe:
        p = subprocess.Popen([sys.executable, str(ROOT / "examples" / "serve_queries_torch.py"),
                              *args], stdout=subprocess.PIPE, stderr=fe, text=True,
                             env=child_env())
    lines: list = []

    def watch():
        for line in p.stdout:
            lines.append(line.rstrip())
            if kill_epoch is not None and line.startswith(f"[wal] epoch {kill_epoch}/"):
                p.send_signal(signal.SIGKILL)
                break

    th = threading.Thread(target=watch, daemon=True)
    th.start()
    return p, th, lines


WAL_ARGS = ["--n", "4000", "--labels", "100", "--graph-seed", "11", "--index-kind", "path",
            "--wal-updates", "8", "--snapshot-every", "3"]
WAL_KILL_EPOCH = 4


def phase11c_sigkill(dev, smi: str, root: Path, children: dict) -> None:
    """The victim was SIGKILLed after epoch 3's line; this process recovers
    its directory on the card and finishes the stream through the example's
    own loop; the final line must equal the control child's."""
    import importlib.util
    import signal
    import types

    from repro_torch.graphs import newman_watts_strogatz

    results = {}
    for tag in ("control", "victim"):
        p, th, lines = children[tag]
        rc = p.wait(timeout=300)
        th.join(timeout=30)
        err = (root / f"11c-{tag}.err").read_text()
        if tag == "control":
            require(rc == 0, f"11c: the control child failed ({rc}): {err[-2000:]}")
        else:
            require(rc == -signal.SIGKILL,
                    f"11c: the victim ended with {rc} before its kill: {err[-2000:]}")
        results[tag] = lines
    m = [ln for ln in results["control"] if ln.startswith("[wal] final")]
    require(len(m) == 1, "11c: the control child printed no final line")
    want = m[0]
    spec = importlib.util.spec_from_file_location("serve_queries_torch",
                                                  ROOT / "examples" / "serve_queries_torch.py")
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    g = newman_watts_strogatz(4000, k=4, p=0.1, n_labels=100, seed=11)
    args = types.SimpleNamespace(wal=str(root / "11c-victim"), snapshot_every=3, wal_updates=8,
                                 batch=6, device=str(dev))
    t = time.perf_counter()
    final = ex._run_wal(None, g, args)
    got = f"[wal] final epoch={final[0]} fingerprint={final[1]} match_digest={final[2]}"
    require(got == want, f"11c: after SIGKILL and recovery {got!r}, never killed {want!r}")
    log(f"  11c SIGKILL after epoch {WAL_KILL_EPOCH} of 8 (the victim's last lines: "
        f"{results['victim'][-2:]}); recovered here and finished in "
        f"{time.perf_counter() - t:.3f} s: {got} == the uninterrupted child's; card: {smi}")


def phase11d_scrub(dev, smi: str, root: Path, rec_srv, cli) -> None:
    """``scrub(sample=8)`` on 11a's recovered engine; a narrowed MBR planted
    on a clone; the CLI on 11a's directory."""
    from repro_torch.durability import engine_state, restore_engine, scrub_engine
    from repro_torch.durability.snapshot import _META_KEY

    rep = rec_srv.scrub(sample=8)
    require(rep["ok"], f"11d: scrub of the recovered engine: {rep['violations'][:4]}")
    meta, arrays = engine_state(rec_srv.engine)
    t = time.perf_counter()
    clone = restore_engine({**arrays, _META_KEY: np.asarray(json.dumps(meta))}, device=dev)[0]
    restore_s = time.perf_counter() - t
    del arrays
    mi = rep["partitions_checked"][0]
    clone.models[mi].index.levels[0]["mbr"][0, 0, 1] -= 10  # a narrowed MBR
    bad = scrub_engine(clone, sample=8)
    require(any(v["partition"] == mi and v["check"] == "mbr" for v in bad["violations"]),
            "11d: the planted narrowed MBR was not found")
    out = cli.communicate(timeout=300)[0]
    require(cli.returncode == 0, f"11d: the scrub CLI exited {cli.returncode}: "
            f"{(root / '11d-cli.err').read_text()[-2000:]}")
    report = json.loads(out)
    require(report["ok"] and len(report["partitions_checked"]) == min(8, len(clone.models)),
            "11d: the scrub CLI's report is not clean")
    log(f"  11d scrub(sample=8) of the recovered engine ok in {rep['scrub_s']:.3f} s "
        f"(partitions {rep['partitions_checked']}); the planted MBR found on a clone "
        f"(restored on the card in {restore_s:.3f} s); the CLI on 11a's directory: rc 0, "
        f"recovered epoch {report['recovered_epoch']}, scrub {report['scrub_s']:.3f} s; "
        f"card: {smi}")


def phase11_durability(dev, ctx: dict, smi: str) -> dict:
    """Phase 11 (the module doc): durability on the card."""
    import tempfile

    import torch

    out: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        reset_counters()
        timed_step("11a the durable 50K cell", phase11a_durable_50k, dev, ctx, smi, root, out)
        # the children run beside 11b: the scrub CLI over 11a's directory, the
        # uninterrupted run of the example and its victim
        with open(root / "11d-cli.err", "w") as fe:
            cli = subprocess.Popen([sys.executable, "-m", "repro_torch.durability.scrub", "--dir",
                                    str(root / "11a"), "--sample", "8"], env=child_env(),
                                   stdout=subprocess.PIPE, stderr=fe, text=True)
        children = {
            tag: wal_child(WAL_ARGS + ["--wal", str(root / f"11c-{tag}")], root / f"11c-{tag}.err",
                           kill_epoch=WAL_KILL_EPOCH if tag == "victim" else None)
            for tag in ("control", "victim")
        }
        try:
            timed_step("11b the crash sweep", phase11b_sweep, dev, smi, root,
                       durability_cell_inputs())
            timed_step("11c a real SIGKILL", phase11c_sigkill, dev, smi, root, children)
            timed_step("11d scrub", phase11d_scrub, dev, smi, root, out.pop("rec_srv"), cli)
        finally:
            for p in [cli] + [c[0] for c in children.values()]:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        out["K1"] = counters()["K1"]
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------- phase 12 --

TRAIN_GRAD_L2 = 5e-3  # a gradient leaf, card against plain / CPU: relative L2 of the difference
TRAIN_GRAD_MAX = 1e-3  # and each element within this · the leaf's max |want| (not the tables)
TRAIN_LOSS_REL = 1e-4  # the DCN-v2 loss, card against CPU (K5's 3xTF32 forward holds 1e-4)
K6_GRAD_REL_L2 = 1e-3  # K6's q, k, v gradients against autograd of the plain attention


def grads_close(got, want, what: str, l2: float = TRAIN_GRAD_L2, max_rel: float = TRAIN_GRAD_MAX,
                rows: tuple = ()) -> float:
    """Every leaf of ``got`` against its ``want`` leaf (trees of one
    structure, compared on ``want``'s device): the relative L2 norm of the
    difference within ``l2`` and each element within ``max_rel`` of the
    leaf's largest |entry|, except for the leaves at the indices ``rows``,
    held to ``l2`` alone (an embedding table's rows are single samples'
    gradients, which a ReLU that flips under the forward's rounding changes
    by percents) → the worst ratio to a limit.  A leaf that is zero where
    ``want``'s is not (a gradient that never arrived) fails at once."""
    from repro_torch.train import tree_leaves

    worst = 0.0
    for i, (a, b) in enumerate(zip(tree_leaves(got), tree_leaves(want), strict=True)):
        a = a.to(b.device).double()
        b = b.double()
        require(bool(torch_isfinite(a)), f"{what}: leaf {i} is not finite")
        top, norm = float(b.abs().max()), float(b.norm())
        if top == 0:
            require(float(a.abs().max()) == 0, f"{what}: leaf {i} should have no gradient")
            continue
        require(float(a.abs().max()) > 0,
                f"{what}: leaf {i} got no gradient (all zero, want max |g| {top:.3g})")
        rel = float((a - b).norm()) / norm
        require(rel <= l2, f"{what}: leaf {i} differs, relative L2 {rel:.3g} > {l2}")
        worst = max(worst, rel / l2)
        if i not in rows:
            err = float((a - b).abs().max())
            require(err <= max_rel * top,
                    f"{what}: leaf {i} differs, |err| {err:.3g} > {max_rel} x {top:.3g}")
            worst = max(worst, err / (max_rel * top))
    return worst


def torch_isfinite(t) -> bool:
    import torch

    return bool(torch.isfinite(t).all())


class PlainKernels:
    """Within this context the models reach the plain versions of K4, K5 and
    K6 under ordinary autograd instead of the kernels' Functions."""

    def __enter__(self):
        from repro_torch.kernels.cross_interact import ops as ci
        from repro_torch.kernels.flash_attention import ops as fa
        from repro_torch.kernels.flash_attention.ref import flash_attention_plain
        from repro_torch.kernels.star_agg import ops as sa

        self.saved = [(sa, "star_agg", sa.star_agg), (ci, "cross_interact", ci.cross_interact),
                      (fa, "flash_attention", fa.flash_attention)]
        sa.star_agg = sa.star_agg_ref
        ci.cross_interact = ci.cross_interact_ref
        fa.flash_attention = (lambda q, k, v, causal=True, window=None, chunk=1024:
                              flash_attention_plain(q, k, v, causal, window, chunk))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def timed_calls(spans: list):
    """Wrap each (label, module, function name) so every call is timed by CUDA
    events into ``marks`` → (marks, restore)."""
    import torch

    marks: list = []
    originals = [getattr(mod, name) for _, mod, name in spans]

    def timed(label, fn):
        def run(*a, **kw):
            s_, e_ = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s_.record()
            res = fn(*a, **kw)
            e_.record()
            marks.append((label, s_, e_))
            return res
        return run

    for (label, mod, name), fn in zip(spans, originals):
        setattr(mod, name, timed(label, fn))

    def restore():
        for (_, mod, name), fn in zip(spans, originals):
            setattr(mod, name, fn)

    return marks, restore


def split_ms(marks: list, labels: list) -> dict:
    """Summed event ms of each label's calls."""
    out = {label: 0.0 for label in labels}
    for label, s_, e_ in marks:
        out[label] += s_.elapsed_time(e_)
    return out


def warm_train_steps(step, state: list, batch, dev, n: int, warmup: int = 1) -> tuple:
    """``warmup`` then ``n`` steps of ``step`` carrying ``state`` = [params,
    opt], each ending in ``synchronize`` → (ms of each timed step, the losses
    of all steps)."""
    ms, losses = [], []
    for i in range(warmup + n):
        t = time.perf_counter()
        state[0], state[1], met = step(state[0], state[1], batch)
        sync(dev)
        dt = (time.perf_counter() - t) * 1e3
        losses.append(float(met["loss"]))
        if i >= warmup:
            ms.append(dt)
    return ms, losses


def phase12a_dcn_train(dev, smi: str, out: dict) -> None:
    """DCN-v2 ``train_batch`` at the published width, B = 65,536 (nothing cut)."""
    import torch

    from repro_torch.configs import build_step, get_arch, init_params, opt_init, resolve_config
    from repro_torch.data import RecsysSyntheticData
    from repro_torch.kernels.cross_interact import ops as ci
    from repro_torch.kernels.star_agg import ops as sa
    from repro_torch.models import dcn_loss
    from repro_torch.train import (
        OptConfig,
        adamw_update,
        tree_leaves,
        tree_map,
        tree_to_device,
        tree_unflatten,
        value_and_grad,
    )

    arch = get_arch("dcn-v2")
    cell = arch.cell("train_batch")
    cfg = resolve_config(arch, cell, smoke=False)
    B = cell.meta["batch"]
    t = time.perf_counter()
    params = init_params(arch, cfg, seed=0, device=dev, train=True)
    batch = tree_to_device(RecsysSyntheticData(cfg, batch=B, seed=0).batch_at(0), dev)
    opt_cfg = OptConfig(lr=1e-3, warmup_steps=0, total_steps=100)
    step, takes_opt = build_step(arch, cell, cfg, opt_cfg=opt_cfg)
    require(takes_opt, "train_batch: build_step gave no train step")
    opt = opt_init(params)
    sync(dev)
    log(f"12a dcn-v2 train_batch: B = {B}, params and batch on the card in "
        f"{time.perf_counter() - t:.3f} s; card: {smi}")

    # ---- the main path: one train step, its launches counted ----------------
    reset_counters()
    new_params, new_opt, met = step(params, opt, batch)
    sync(dev)
    c = counters()
    out["K4"] += c["K4"]
    out["K5"] += c["K5"]
    require(c["K4"] == 1 and c["K5"] == cfg.n_cross_layers,
            f"12a: a train step launched K4 {c['K4']} and K5 {c['K5']} times, want 1 and "
            f"{cfg.n_cross_layers}")
    loss_card = float(met["loss"])

    def lf(p, b):
        return dcn_loss(p, b, cfg)

    # ---- the Functions' gradients against autograd of the plain forward -----
    (l_k, _), g_k = value_and_grad(lf, params, batch)
    with PlainKernels():
        (l_p, _), g_p = value_and_grad(lf, params, batch)
    rows = tuple(i for i, x in enumerate(tree_leaves(params)) if x is params["tables"])
    w = grads_close(g_k, g_p, "12a gradients, Functions against plain autograd", rows=rows)
    log(f"12a gradients through K4's and K5's Functions equal autograd through the plain "
        f"forward on the card: worst ratio to a limit {w:.3g} (relative L2 {TRAIN_GRAD_L2} a "
        f"leaf; each element {TRAIN_GRAD_MAX} of the leaf's max |g|, the tables excepted); loss "
        f"{float(l_k):.7f} against {float(l_p):.7f}")
    # the planted fault: a K5 wrapper whose output is detached
    saved = ci.cross_interact
    ci.cross_interact = lambda *a: ci._forward(*a).detach()
    try:
        (_, _), g_bad = value_and_grad(lf, params, batch)
    finally:
        ci.cross_interact = saved
    try:
        grads_close(g_bad, g_p, "planted detached K5", rows=rows)
        caught = False
    except AssertionError as e:
        caught = True
        log(f"12a control, a K5 wrapper with a detached output: the gradient check fails ({e})")
    require(caught, "12a: a detached K5 output passed the gradient check")
    del g_bad, g_p

    # ---- one step against the port's CPU run of the same params and batch ---
    t = time.perf_counter()
    cpu = torch.device("cpu")
    p_cpu = tree_map(lambda x: x.to(cpu), params)
    b_cpu = tree_map(lambda x: x.to(cpu), batch)
    (l_cpu, _), g_cpu = value_and_grad(lf, p_cpu, b_cpu)
    cpu_s = time.perf_counter() - t
    require(abs(loss_card - float(l_cpu)) <= TRAIN_LOSS_REL * abs(float(l_cpu)),
            f"12a: the card's loss {loss_card} differs from the CPU's {float(l_cpu)}")
    wg = grads_close(g_k, g_cpu, "12a gradients, card against CPU", rows=rows)
    # the card's AdamW against the CPU's on the card's gradients
    g_card_cpu = tree_map(lambda x: x.to(cpu), g_k)
    want_p, want_opt, _ = adamw_update(g_card_cpu, tree_map(lambda x: x.to(cpu), opt), p_cpu,
                                       opt_cfg)
    wp = grads_close(new_params, want_p, "12a new params, card AdamW against CPU AdamW", 1e-6,
                     1e-5)
    wm = grads_close(new_opt["m"], want_opt["m"], "12a AdamW m", 1e-6, 1e-5)
    log(f"12a one train step against the CPU (CPU forward and backward {cpu_s:.3f} s): loss "
        f"{loss_card:.7f} against {float(l_cpu):.7f} (limit {TRAIN_LOSS_REL} relative), "
        f"gradients worst ratio to a limit {wg:.3g}, the card's AdamW on its gradients against "
        f"the CPU's: params {wp:.3g}, m {wm:.3g} (limits relative L2 1e-6, each element 1e-5 "
        f"of the leaf's max |entry|)")
    del p_cpu, b_cpu, g_cpu, g_card_cpu, want_p, want_opt, g_k, new_params, new_opt

    # ---- warm steps ----------------------------------------------------------
    torch.cuda.reset_peak_memory_stats(dev)
    state = [params, opt]
    ms, losses = warm_train_steps(step, state, batch, dev, n=6)
    med = float(np.median(ms))
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    out["dcn_step_ms"] = med
    log(f"12a train_batch warm step ms {fmt(ms)} (median {med:.3f}), {B / med * 1e3:.0f} rows/s, "
        f"peak memory {peak:.2f} GiB, losses {', '.join(f'{x:.5f}' for x in losses)}; "
        f"card: {smi}")

    # ---- the step's split: forward, backward, optimizer ----------------------
    spans = [("K4 forward", sa, "_forward"), ("K5 forward", ci, "_forward"),
             ("K4 backward (index_add_)", sa, "star_agg_backward"),
             ("K5 backward (matmuls)", ci, "cross_interact_backward")]
    marks, restore = timed_calls(spans)
    phases = {"forward": 0.0, "backward": 0.0, "optimizer": 0.0}
    reps = 3
    try:
        for _ in range(reps):
            torch.cuda._sleep(SPIN_CYCLES * 40)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            ev[0].record()
            with torch.enable_grad():
                live = tree_map(lambda x: x.detach().requires_grad_(True), state[0])
                loss, _ = lf(live, batch)
                ev[1].record()
                gl = [torch.zeros_like(x) if g_ is None else g_ for x, g_ in zip(
                    tree_leaves(live), torch.autograd.grad(loss, tree_leaves(live),
                                                           allow_unused=True))]
            ev[2].record()
            new = adamw_update(tree_unflatten(live, gl), state[1], state[0], opt_cfg)
            ev[3].record()
            ev[3].synchronize()
            for k, (a, b_) in zip(phases, ((0, 1), (1, 2), (2, 3))):
                phases[k] += ev[a].elapsed_time(ev[b_]) / reps
            del live, loss, gl, new
    finally:
        restore()
    spent = split_ms(marks, [label for label, _, _ in spans])
    spent = {k: v / reps for k, v in spent.items()}
    log("12a train step split by CUDA events (host enqueue hidden behind a spin): "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in phases.items())
        + "; inside them " + ", ".join(f"{k} {v:.3f} ms" for k, v in spent.items())
        + f"; the rest of the forward (dense features, the MLP's SGEMMs, the loss) "
        f"{phases['forward'] - spent['K4 forward'] - spent['K5 forward']:.3f} ms, of the "
        f"backward {phases['backward'] - spent['K4 backward (index_add_)'] - spent['K5 backward (matmuls)']:.3f}"
        f" ms; card: {smi}")
    out["dcn_split"] = {**phases, **spent}
    top_kernels(lambda: step(state[0], state[1], batch), dev, "12a one train step", med, n=10)
    del state, params, opt, batch
    torch.cuda.empty_cache()


def phase12b_lm_train(dev, smi: str, out: dict) -> None:
    """gemma3-1b ``train_4k`` at the published width and depth (26 layers),
    the global batch cut to 4 sequences of 4,096 in ``grad_accum`` 4 (8 until the
    script's time needed the room)."""
    import dataclasses

    import torch

    from repro_torch.configs import build_step, get_arch, init_params, opt_init, resolve_config
    from repro_torch.train import step as tstep
    from repro_torch.data import LMSyntheticData
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import (
        attention_scale,
        flash_attention_plain,
        k6_agreement,
    )
    from repro_torch.models import lm_loss
    from repro_torch.models import transformer as tmod
    from repro_torch.train import OptConfig, tree_map, tree_to_device

    arch = get_arch("gemma3-1b")
    cell = arch.cell("train_4k")
    B, accum = 4, 4
    cfg = dataclasses.replace(resolve_config(arch, cell, smoke=False), grad_accum=accum)
    S = cell.meta["seq_len"]
    t = time.perf_counter()
    params = init_params(arch, cfg, seed=0, device=dev, train=True)
    batch = tree_to_device(LMSyntheticData(cfg.vocab, batch=B, seq_len=S, seed=0).batch_at(0), dev)
    opt_cfg = OptConfig(lr=1e-3, warmup_steps=0, total_steps=100)
    step, takes_opt = build_step(arch, cell, cfg, opt_cfg=opt_cfg)
    require(takes_opt, "train_4k: build_step gave no train step")
    opt = opt_init(params)
    sync(dev)
    n_params = sum(x.numel() for x in [params["embed"], params["final_norm"]]
                   + [x for layer in params["layers"] for x in layer.values()])
    log(f"12b gemma3-1b train_4k: {n_params} float32 master params, batch {B} x {S} "
        f"(cut from 256) in grad_accum {accum}, remat {cfg.remat}, loss_chunk {cfg.loss_chunk}; "
        f"set up in {time.perf_counter() - t:.3f} s; card: {smi}")

    # ---- the main path: one train step, K6 counted ----------------------------
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counters()
    t = time.perf_counter()
    state = [params, opt]
    state[0], state[1], met = step(state[0], state[1], batch)
    sync(dev)
    first_ms = (time.perf_counter() - t) * 1e3
    first_loss = float(met["loss"])
    k6 = counters()["K6"]
    out["K6"] += k6
    per_mb = cfg.n_layers * (2 if cfg.remat else 1)
    require(k6 == per_mb * accum,
            f"12b: a train step launched K6 {k6} times, want {per_mb} a microbatch x {accum}")
    log(f"12b first step {first_ms:.1f} ms, loss {float(met['loss']):.5f}; K6 launched {k6} "
        f"times ({cfg.n_layers} a microbatch forward, as many again in remat's recompute)")

    # ---- the first loss against the CPU's on a short slice --------------------
    sl = {k: v[:1, :640].contiguous() for k, v in batch.items()}
    with torch.no_grad():
        card = float(lm_loss(params, sl, cfg)[0])
        t = time.perf_counter()
        p_cpu = tree_map(lambda x: x.cpu(), params)
        want = float(lm_loss(p_cpu, tree_map(lambda x: x.cpu(), sl), cfg)[0])
        cpu_s = time.perf_counter() - t
        del p_cpu
    lim = LM_TOL["atol"] + LM_TOL["rtol"] * abs(want)
    require(abs(card - want) <= lim, f"12b: the card's loss {card} differs from the CPU's {want}")
    log(f"12b loss at B = 1, S = 640 on the card {card:.6f}, on the CPU {want:.6f} (CPU "
        f"{cpu_s:.3f} s): |diff| {abs(card - want):.3g} within phase 7's atol "
        f"{LM_TOL['atol']} + rtol {LM_TOL['rtol']} ({lim:.3g})")

    # ---- K6's Function gradients against autograd of the plain attention ------
    seen: list = []
    orig = fa._forward

    def rec(*a):
        seen.append(a)
        return orig(*a)

    fa._forward = rec
    try:
        with torch.no_grad():
            tmod._hidden(params, batch["tokens"][:1], cfg, remat=False)
    finally:
        fa._forward = orig
    g = torch.Generator(device=dev).manual_seed(7)
    for layer in (0, 5):  # a local layer, then a global one
        q, k, v, causal, window, chunk = seen[layer]
        ins = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
        o = fa.flash_attention(*ins, causal=causal, window=window, chunk=chunk)
        up = torch.randn(o.shape, generator=g, device=dev).to(o.dtype)
        got = torch.autograd.grad(o, ins, up)
        ins2 = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
        o2 = flash_attention_plain(*ins2, causal, window, chunk)
        want_g = torch.autograd.grad(o2, ins2, up)
        # K6's own output at S = 4,096, held as phase 7 holds it: the gradient
        # comparison below only shows the Function is wired into autograd, since
        # its backward is autograd of this same plain attention
        fwd = k6_agreement(o.detach(), o2.detach(),
                           attention_scale(q, k, v, causal, window, chunk))
        require(fwd["ok"], f"12b K6's output on layer {layer} (S = {q.shape[1]}) differs from "
                f"its plain version: max |err| {fwd['max_abs_err']:.3g}, worst |err| / limit "
                f"{fwd['worst']:.3g}, relative L2 {fwd['rel_l2']:.3g} (limit 5e-3)")
        rels = [f"o worst |err| / limit {fwd['worst']:.3g} rel L2 {fwd['rel_l2']:.3g} "
                f"max |err| {fwd['max_abs_err']:.3g}"]
        for name, a, b_ in zip("qkv", got, want_g):
            a, b_ = a.float(), b_.float()
            rel = float((a - b_).norm() / b_.norm())
            mx = float((a - b_).abs().max())
            require(rel <= K6_GRAD_REL_L2 and mx <= 2.0**-7 * float(b_.abs().max()),
                    f"12b K6 d{name} on layer {layer}: relative L2 {rel:.3g}, max |err| {mx:.3g}")
            rels.append(f"d{name} rel L2 {rel:.3g} max |err| {mx:.3g}")
        log(f"12b K6 on layer {layer} ({'global' if window is None else 'local'}, "
            f"S = {q.shape[1]}) against the plain attention, its output and its Function's "
            f"gradients: {', '.join(rels)} (output: phase 7's per-element limit and relative "
            f"L2 5e-3; gradients: relative L2 {K6_GRAD_REL_L2}, max |err| 2^-7 of max |want|)")
        del ins, ins2, o, o2, got, want_g, up
    del seen

    # ---- warm steps on the fixed batch: the loss must fall ---------------------
    ms, losses = warm_train_steps(step, state, batch, dev, n=2, warmup=0)
    # the third, split by CUDA events around the calls
    spans = [("K6 forward (with remat's recompute)", fa, "_forward"),
             ("attention backward (plain, recomputed)", fa, "flash_attention_backward"),
             ("CE forward", tmod, "cross_entropy_loss"),
             ("optimizer", tstep, "adamw_update")]
    marks, restore = timed_calls(spans)
    try:
        s_, e_ = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t = time.perf_counter()
        s_.record()
        state[0], state[1], met = step(state[0], state[1], batch)
        e_.record()
        e_.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
        losses.append(float(met["loss"]))
    finally:
        restore()
    losses = [float(first_loss)] + losses
    require(losses[-1] < losses[0] and all(np.isfinite(losses)),
            f"12b: the loss did not fall over {len(losses)} steps on a fixed batch: {losses}")
    med = float(np.median(ms))
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    out["lm_step_ms"] = med
    log(f"12b train_4k warm step ms {fmt(ms, 1)} (median {med:.1f}), {B * S / med * 1e3:.0f} "
        f"tokens/s, peak memory {peak:.2f} GiB, losses {', '.join(f'{x:.4f}' for x in losses)}; "
        f"card: {smi}")
    total = s_.elapsed_time(e_)
    spent = split_ms(marks, [label for label, _, _ in spans])
    log(f"12b the last step by CUDA events around the calls (host enqueue not hidden): "
        f"{total:.1f} ms = " + " + ".join(f"{k} {v:.1f}" for k, v in spent.items())
        + f" + the rest (GEMMs, norms, RoPE, CE backward) {total - sum(spent.values()):.1f}; "
        f"card: {smi}")
    out["lm_split"] = {"step": total, **spent}
    # the profiler over one microbatch's step (a step's 134 K launches take it a minute)
    step1, _ = build_step(arch, cell, dataclasses.replace(cfg, grad_accum=1), opt_cfg=opt_cfg)
    one = {k: v[:1] for k, v in batch.items()}
    step1(state[0], state[1], one)
    top_kernels(lambda: step1(state[0], state[1], one), dev,
                "12b one microbatch's train step (B = 1, optimizer included)", med / accum, n=12)
    del state, params, opt, batch
    torch.cuda.empty_cache()


def train_worker(directory: str) -> int:
    """A ``Trainer`` on the card at the smoke width with the preemption
    handler installed; writes ``started`` into ``directory`` at step 5 and
    prints its summary as JSON when the loop ends (after a SIGTERM)."""
    import torch  # noqa: F401

    from repro_torch.train import OptConfig, Trainer, TrainerConfig

    loss_fn, params, batch_at = smoke_lm(None)  # the card

    def batch_fn(step):
        if step == 5:
            (Path(directory) / "started").write_text("5")
        return batch_at(step)

    tr = Trainer(loss_fn, params, batch_fn,
                 TrainerConfig(total_steps=5_000, ckpt_every=100_000,
                               ckpt_dir=str(Path(directory) / "ckpt"),
                               opt=OptConfig(lr=3e-3, warmup_steps=0, total_steps=1000)))
    tr.install_preemption_handler()
    out = tr.run()
    print(json.dumps({k: out[k] for k in ("final_step", "preempted")}), flush=True)
    return 0


def smoke_lm(device):
    """The smoke gemma3-1b in bf16 (K6 takes bf16 on the card) with its
    synthetic data → (loss_fn, float32 master params, batch_at)."""
    import dataclasses

    from repro_torch.configs import get_arch, init_params, resolve_config
    from repro_torch.data import LMSyntheticData
    from repro_torch.models import lm_loss

    arch = get_arch("gemma3-1b")
    cfg = dataclasses.replace(resolve_config(arch, arch.cell("train_4k"), smoke=True),
                              dtype="bfloat16")
    params = init_params(arch, cfg, seed=0, device=device, train=True)
    data = LMSyntheticData(cfg.vocab, batch=2, seq_len=64, seed=0)
    return (lambda p, b: lm_loss(p, b, cfg)), params, data.batch_at


def phase12c_trainer(dev, smi: str, root: Path) -> None:
    """The ``Trainer`` on the card at the smoke width."""
    from repro_torch.train import OptConfig

    opt = OptConfig(lr=3e-3, warmup_steps=0, total_steps=40)
    # the three launchers and the example run in child processes beside the checks below
    # (after each other until phase 15 needed the time); their output is read at the end
    t_children = time.perf_counter()
    procs = {arch: subprocess.Popen([sys.executable, "-m", "repro_torch.launch.train", "--arch",
                                     arch, "--smoke", "--steps", "30"], stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True, env=child_env())
             for arch in ("dcn-v2", "gemma3-1b", "deepseek-v2-lite-16b")}
    # 80 steps (cut from 200 to make room for phase 14; the example asserts its loss drops 20 %)
    procs["example"] = subprocess.Popen(
        [sys.executable, str(ROOT / "examples" / "train_lm_torch.py"), "--steps", "80",
         "--ckpt-dir", str(root / "example")], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=child_env())
    try:
        phase12c_checks(dev, root, opt)
        outs = {name: p.communicate(timeout=600) for name, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    for name, (so, se) in outs.items():
        rc = procs[name].returncode
        if name == "example":
            require(rc == 0, f"12c: examples/train_lm_torch.py exited {rc}: {se[-2000:]}")
            log(f"12c examples/train_lm_torch.py in a child process: {so.strip().splitlines()[-1]}")
            continue
        require(rc == 0 and "[train] done" in so,
                f"12c: repro_torch.launch.train --arch {name} exited {rc}: {se[-2000:]}")
        log(f"12c python -m repro_torch.launch.train --arch {name} --smoke --steps 30 in a child "
            f"process: {so.strip().splitlines()[-1]}")
    log(f"12c the three launchers and the example, beside the checks: "
        f"{time.perf_counter() - t_children:.3f} s")


def phase12c_checks(dev, root: Path, opt) -> None:
    """12c's checks in this process: resume, SIGTERM, the watchdog, compression."""
    import os
    import signal

    import torch

    from repro_torch.dist.checkpoint import CheckpointManager
    from repro_torch.train import CompressionConfig, Trainer, TrainerConfig, wire_bytes

    def trainer(d, loss_fn=None, params=None, batch_at=None, **kw):
        lf, p, ba = smoke_lm(dev)
        return Trainer(loss_fn or lf, params or p, batch_at or ba,
                       TrainerConfig(ckpt_dir=str(root / d), opt=opt, **kw))

    # ---- checkpoint and a resume that reproduces the uninterrupted run -------
    t = time.perf_counter()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        kw = dict(total_steps=20, ckpt_every=10, async_checkpoint=False)
        straight = trainer("straight", **kw)
        straight.run(20)
        first = trainer("resumed", **kw)
        first.run(10)
        again = trainer("resumed", **kw)
        require(again.try_resume() and again.step == 10, "12c: no resume from step 10")
        again.run(10)
    finally:
        torch.use_deterministic_algorithms(False)
    from repro_torch.train import tree_leaves

    same = all(torch.equal(a, b) for a, b in zip(tree_leaves(straight.params),
                                                  tree_leaves(again.params)))
    require(same, "12c: the resumed run's params differ from the uninterrupted run's")
    log(f"12c Trainer resume: 10 steps, checkpoint, a new Trainer resumed and ran 10 more: every "
        f"param bit-equal to 20 uninterrupted steps (deterministic algorithms on), losses "
        f"{straight.history[0]['loss']:.4f} -> {straight.history[-1]['loss']:.4f}, "
        f"{time.perf_counter() - t:.3f} s")

    # ---- SIGTERM in a child process leaves a checkpoint -----------------------
    t = time.perf_counter()
    d = root / "sigterm"
    d.mkdir()
    p = subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--train-worker", str(d)],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                         env=child_env())
    try:
        deadline = time.time() + 180
        while not (d / "started").exists():
            if p.poll() is not None:
                raise AssertionError(f"12c: the train worker exited early: {p.stderr.read()}")
            require(time.time() < deadline, "12c: the train worker never reached step 5")
            time.sleep(0.1)
        os.kill(p.pid, signal.SIGTERM)
        so, se = p.communicate(timeout=120)
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
    require(p.returncode == 0, f"12c: the train worker exited {p.returncode}: {se[-2000:]}")
    summary = json.loads(so.strip().splitlines()[-1])
    latest = CheckpointManager(d / "ckpt").latest_step()
    require(summary["preempted"] and latest == summary["final_step"] >= 5,
            f"12c: after SIGTERM {summary}, latest checkpoint {latest}")
    log(f"12c SIGTERM to a training child at step >= 5: it checkpointed step {latest} and "
        f"exited 0 ({time.perf_counter() - t:.3f} s)")

    # ---- the straggler watchdog on an injected delay --------------------------
    lf, params, batch_at = smoke_lm(dev)
    hit: dict = {}

    def slow_loss(p_, b_):
        if int(b_["step"]) == 25 and not hit:
            hit["at"] = 25
            time.sleep(0.5)
        return lf(p_, b_)

    wd = trainer("watchdog", loss_fn=slow_loss, params=params,
                 batch_at=lambda s: {**batch_at(s), "step": np.asarray(s)}, total_steps=30,
                 ckpt_every=1000)
    res = wd.run()
    require(any(e["step"] == 25 for e in wd.straggler_events),
            f"12c: the watchdog missed the delayed step: {wd.straggler_events}")
    ev25 = next(e for e in wd.straggler_events if e["step"] == 25)
    log(f"12c watchdog: {res['stragglers']} straggler event(s), step 25 at "
        f"{ev25['dt'] * 1e3:.1f} ms against a median of {ev25['median'] * 1e3:.2f} ms")

    # ---- int8 and top-k compression -------------------------------------------
    for kind in ("int8", "topk"):
        comp = CompressionConfig(kind=kind, topk_frac=0.1)
        tr = trainer(f"comp_{kind}", total_steps=20, ckpt_every=1000, compression=comp)
        res = tr.run()
        first_l, last_l = tr.history[0]["loss"], res["final_loss"]
        require(np.isfinite(last_l) and last_l < first_l and tr.residual is not None,
                f"12c {kind}: loss {first_l} -> {last_l}")
        log(f"12c {kind} compression with error feedback: 20 steps, loss {first_l:.4f} -> "
            f"{last_l:.4f}, {wire_bytes(tr.params, comp)} wire bytes a step against "
            f"{wire_bytes(tr.params, CompressionConfig())} uncompressed")


def phase12_training(dev, smi: str) -> dict:
    import tempfile

    out: dict = {"K4": 0, "K5": 0, "K6": 0}
    for name, fn in (("12a dcn-v2 train_batch", lambda: phase12a_dcn_train(dev, smi, out)),
                     ("12b gemma3-1b train_4k", lambda: phase12b_lm_train(dev, smi, out))):
        t = time.perf_counter()
        fn()
        log(f"phase {name}: {time.perf_counter() - t:.3f} s; card: {smi}")
    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        phase12c_trainer(dev, smi, Path(d))
    log(f"phase 12c the Trainer at the smoke width: {time.perf_counter() - t:.3f} s; card: {smi}")
    return out


# ---- phase 13 -----------------------------------------------------------------

# (arch, the layers the card holds (None: all) and why, prefill_32k's B, decode_32k's B and why)
LM_FAMILY = (
    ("minitron-4b", None, 1, 8,
     "4.3 GB of KV a sequence; prefill_32k at B = 1 returns 16.8 GB of logits, B = 32 would "
     "return 537 GB"),
    ("command-r-plus-104b", (8, "the 64 layers are 214 GB in bf16; 8 (25.2 GB) with the "
                               "embedding and untied head (12.6 GB) fit the card"), 1, 16,
     "17 GB of KV at 8 layers"),
    ("deepseek-v2-lite-16b", None, 1, 16, "1.02 GB of latent cache a sequence"),
    ("qwen3-moe-235b-a22b", (8, "the 94 layers are 470 GB in bf16; 8 (39.8 GB) with the "
                               "embedding and head (2.5 GB) fit the card"), 1, 16,
     "8.6 GB of KV at 8 layers"),
)
CPU_DEPTH = 2  # layers of the CPU comparisons (deepseek's: the dense layer and one MoE layer)
CPU_TOKENS = 64  # the prefix the CPU's bf16 prefill runs
ROUTE_LIMIT = 0.01  # share of (token, layer) top-k sets the card and the CPU may route apart


def k6_rows_check(res, q, k, v, rows: slice, chunk: int, what: str) -> dict:
    """K6's output ``res`` at the query rows ``rows`` against the plain
    ``chunked_attention`` of those rows over every key (``ref.k6_agreement``,
    unchanged): the plain version of the whole layer would hold (S, S)
    float32 scores a chunk at a time, tens of GB at 96 heads."""
    import torch

    from repro_torch.kernels.flash_attention.ref import chunked_attention, k6_agreement

    B, S, Hq, dh = q.shape
    Hkv, dv = k.shape[2], v.shape[-1]
    pos = torch.arange(S, dtype=torch.int32, device=q.device)
    qs = q[:, rows].reshape(B, -1, Hkv, Hq // Hkv, dh)
    want = chunked_attention(qs, k, v, pos[rows], pos, None, chunk).reshape(B, -1, Hq, dv)
    scale = chunked_attention(qs, k, v.abs(), pos[rows], pos, None, chunk).reshape(B, -1, Hq, dv)
    r = k6_agreement(res[:, rows], want, scale)
    require(r["ok"], f"{what} differs from its plain version: max |err| {r['max_abs_err']:.3g}, "
            f"worst |err| / limit {r['worst']:.3g}, relative L2 {r['rel_l2']:.3g}")
    return r


def topk_sets_differ(a, b) -> int:
    """Rows (tokens) whose top-k expert sets differ between (T, K) id tensors."""
    return int((a.sort(-1).values != b.sort(-1).values).any(-1).sum())


def rows_routed_apart(card_routes: list, cpu_routes: list):
    """(T,) bool over the tokens of two runs' recorded ``_route`` calls (the
    same MoE layers in order): true where a token's top-k set differs in any
    layer; None where no layer was recorded."""
    apart = None
    for (_, _, (a, _v, _x)), (_, _, (b, _w, _y)) in zip(card_routes, cpu_routes):
        d = (a.cpu().sort(-1).values != b.cpu().sort(-1).values).any(-1)
        apart = d if apart is None else apart | d
    return apart


def close_where_routed_alike(card, want, apart, what: str):
    """``lm_close`` over the rows (first dim) that ``apart`` does not mark →
    (max |diff|, relative L2), or None where every row routed apart."""
    if apart is not None and bool(apart.any()):
        if bool(apart.all()):
            return None
        card, want = card[~apart], want[~apart]
    return lm_close(card, want, what)


def recording(mod, name: str, sink: list, keep=lambda i: True):
    """A context that wraps ``mod.name`` so each call appends (its index, its
    args, its result) to ``sink`` where ``keep(index)``; restored on exit."""
    import contextlib

    @contextlib.contextmanager
    def ctx():
        fn = getattr(mod, name)
        n = [0]

        def rec(*a, **kw):
            res = fn(*a, **kw)
            if keep(n[0]):
                sink.append((n[0], a, res))
            n[0] += 1
            return res

        setattr(mod, name, rec)
        try:
            yield
        finally:
            setattr(mod, name, fn)

    return ctx()


def cut_params(params: dict, depth: int, device) -> dict:
    """The model's first ``depth`` layers, embedding, final norm and head on ``device``."""
    from repro_torch.train.functional import tree_to_device

    return tree_to_device({**{k: v for k, v in params.items() if k != "layers"},
                           "layers": params["layers"][:depth]}, device)


def phase13_prefill(dev, flush, smi, arch, cfg, params, B: int, out: dict) -> None:
    """prefill_32k at full width: K6 once a layer and equal to its plain
    version, the MoE routing against the CPU's on the card's own layer
    inputs, warm ms and the step's split; K6 timed on a real layer."""
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import build_step, make_batch
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as tr

    name, L = arch.name, cfg.n_layers
    cell = arch.cell("prefill_32k")
    batch = {"tokens": make_batch(arch, cell, cfg, seed=1, smoke=False, device=dev)["tokens"][:B]}
    S = batch["tokens"].shape[1]
    step, _ = build_step(arch, cell, cfg)
    attn, routes = [], []
    keep_layers = {0, 1, L - 1} if cfg.first_dense else {0, L - 1}
    reset_counters()  # counts from here to the end of the forward
    with recording(fa, "flash_attention", attn, keep=lambda i: i in keep_layers), \
            recording(moe_mod, "_route", routes):
        t = time.perf_counter()
        logits = step(params, batch)
        sync(dev)
        cold_ms = (time.perf_counter() - t) * 1e3
    k6 = counters()["K6"]
    out["K6"] += k6
    require(k6 == L, f"{name} prefill_32k: K6 launched {k6} times in one forward, not {L}")
    require(logits.shape == (B, S, cfg.vocab) and logits.dtype == cfg.compute_dtype,
            f"{name} prefill_32k: logits of shape {tuple(logits.shape)}, {logits.dtype}")
    require(all(bool(torch.isfinite(logits[b, i:i + 4096]).all())
                for b in range(B) for i in range(0, S, 4096)), f"{name}: logits not finite")
    del logits
    checks = []
    for i, (q, k, v), res in ((i, a[:3], r) for i, a, r in attn):
        for rows in (slice(0, 1024), slice(S - 1024, S)):
            checks.append(k6_rows_check(res, q, k, v, rows, cfg.kv_chunk,
                                        f"{name} prefill_32k layer {i}, rows {rows.start}-"
                                        f"{rows.stop - 1}"))
    shape = f"q {tuple(attn[-1][1][0].shape)}, v {tuple(attn[-1][1][2].shape)}"
    log(f"13 {name} prefill_32k (B = {B}, S = {S}): K6 x{k6} in one forward (one a layer), layers "
        f"{sorted(keep_layers)} held against the plain chunked_attention at query rows 0-1023 and "
        f"{S - 1024}-{S - 1} over every key ({shape}): worst |err| / limit "
        f"{max(c['worst'] for c in checks):.3g}, largest relative L2 "
        f"{max(c['rel_l2'] for c in checks):.3g}, max |err| "
        f"{max(c['max_abs_err'] for c in checks):.3g}; logits finite; cold {cold_ms:.3f} ms")
    out["K6_err"] = max(out["K6_err"], *(c["max_abs_err"] for c in checks))

    if routes:  # the card's routing against the CPU's on the card's own layer inputs
        mcfg = cfg.moe
        diff, drops, entries = 0, 0, 0
        for _, (x, router, _m), (topi, topv, _aux) in routes:
            want = moe_mod._route(x.cpu(), router.cpu(), mcfg)[0]
            diff += topk_sets_differ(topi.cpu(), want)
            plan = moe_mod.dispatch_plan(topi, topv, mcfg)
            drops += int((~plan["keep"]).sum())
            entries += plan["keep"].numel()
        share = diff / (len(routes) * S * B)
        require(share <= ROUTE_LIMIT, f"{name}: {share:.4%} of (token, layer) top-{mcfg.top_k} "
                f"sets differ between the card and the CPU (limit {ROUTE_LIMIT:.0%})")
        log(f"13 {name} routing: {len(routes)} MoE layers x {B * S} tokens, the CPU's float32 "
            f"router on the card's own layer inputs: {diff} top-{mcfg.top_k} sets of "
            f"{len(routes) * B * S} differ ({share:.4%}, limit {ROUTE_LIMIT:.0%}); capacity "
            f"{plan['cap']} a layer: {drops} of {entries} (token, expert) entries dropped "
            f"({drops / entries:.3%})")
        x_moe = routes[-1][1][0]  # the last MoE layer's input, (B·S, D)
        p_moe = params["layers"][-1]["moe"]
        top_kernels(lambda: moe_mod.moe_block(x_moe, p_moe, mcfg), dev,
                    f"13 {name} prefill_32k, the last layer's moe_block on its real input",
                    time_ms(lambda: moe_mod.moe_block(x_moe, p_moe, mcfg), (), 1, flush,
                            warmup=1), n=6)
        del x_moe
    routes.clear()

    warm = warm_ms(lambda: step(params, batch), dev, runs=2)
    med = float(np.median(warm))
    out["prefill_ms"] = med
    log(f"13 {name} prefill_32k: warm {fmt(warm)} ms, median {med:.3f} ms, {B * S / med * 1e3:.1f} "
        f"tokens/s; card: {smi}")
    kernels = [("K6 attention", fa, "flash_attention")]
    if cfg.moe is not None:
        kernels.append(("MoE FFN", tr, "moe_block"))
    step_breakdown(step, (params, batch), f"13 {name} prefill_32k", med, kernels,
                   "embedding, norms, QKV and RoPE, wo, dense MLPs, head and the rest", reps=1)

    # ---- K6 at this arch's shape (its last layer), beside plain and SDPA -------
    q, k, v = attn[-1][1][:3]
    attn.clear()
    Hq, Hkv, dh, dv = q.shape[2], k.shape[2], q.shape[3], v.shape[3]
    vp = F.pad(v, (0, dh - dv)) if dv < dh else v

    def sdpa(q, k, v):
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=True,
            enable_gqa=True).transpose(1, 2)

    k6_ms = time_ms(lambda q, k, v: fa.flash_attention(q, k, v), (q, k, v), 5, flush)
    bound = k6_bound_ms(B, S, Hq, Hkv, dh, None, dv)
    lib_ms = time_ms(sdpa, (q, k, vp), 5, flush)
    try:  # (S, 1024) float32 scores a chunk for every head
        plain = f"{time_ms(flash_attention_plain, (q, k, v), 1, flush, warmup=1):.3f} ms"
    except torch.OutOfMemoryError as e:
        plain = f"not measured: out of memory ({str(e).splitlines()[0][:80]})"
    torch.cuda.empty_cache()
    flops = k6_flops(B, S, Hq, dh, None, dv)
    out.setdefault("K6_shapes", []).append((name, k6_ms, bound, lib_ms, plain))
    log(f"13 {name} K6 (B={B}, S={S}, Hq={Hq}, Hkv={Hkv}, G={Hq // Hkv}, dqk={dh}, dv={dv}"
        f"{', v padded to ' + str(dh) if dv < dh else ''}; causal): {k6_ms:.6f} ms, "
        f"{flops / k6_ms / 1e9:.1f} TFLOP/s, {k6_ms / bound[0]:.3f}x its bound {bound[0]:.6f} ms "
        f"({bound[1]}, {flops / 1e12:.2f} TFLOP); SDPA (is_causal, enable_gqa"
        f"{', on the padded v' if dv < dh else ''}) {lib_ms:.6f} ms, {flops / lib_ms / 1e9:.1f} "
        f"TFLOP/s; plain version {plain}; {L} launches a forward; card: {smi}")


def phase13_cpu_prefill(dev, arch, cfg, params, cpu_p) -> None:
    """The first CPU_DEPTH layers on a CPU_TOKENS-token prompt: the card's
    logits against the port's CPU run of the same params (``cpu_p``, those
    layers on the host); for a MoE arch also layer by layer, the CPU given the
    card's input to each layer."""
    import dataclasses

    import torch

    from repro_torch.configs import build_step, make_batch
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as tr
    from repro_torch.models.common import rms_norm

    name = arch.name
    cfg_c = dataclasses.replace(cfg, n_layers=CPU_DEPTH)
    card_p = cut_params(params, CPU_DEPTH, dev)
    cell = arch.cell("prefill_32k")
    tok = make_batch(arch, cell, cfg, seed=2, smoke=False, device=dev)["tokens"][:1, :CPU_TOKENS]
    step, _ = build_step(arch, cell, cfg_c)
    layers, card_routes, cpu_routes = [], [], []
    with recording(tr, "_layer", layers), recording(moe_mod, "_route", card_routes):
        card = step(card_p, {"tokens": tok.contiguous()}).cpu()
    t = time.perf_counter()
    with recording(moe_mod, "_route", cpu_routes):
        want = step(cpu_p, {"tokens": tok.cpu()})
    cpu_s = time.perf_counter() - t
    diff = sum(topk_sets_differ(a[2][0].cpu(), b[2][0]) for a, b in zip(card_routes, cpu_routes))
    mx, rel = float((card.float() - want.float()).abs().max()), float(
        (card.float() - want.float()).norm() / want.float().norm())
    what = (f"13 {name} prefill logits, {CPU_DEPTH} layers, B = 1, S = {CPU_TOKENS}, against the "
            f"CPU's (CPU run {cpu_s:.3f} s): max |diff| {mx:.4g}, relative L2 {rel:.4g}, largest "
            f"|logit| {float(want.abs().max()):.4g}")
    if cfg.moe is None or diff == 0:
        lm_close(card, want, what)
        log(what + (f"; every top-{cfg.moe.top_k} set routed alike" if cfg.moe else "")
            + f"; within rtol {LM_TOL['rtol']} / atol {LM_TOL['atol']} / relative L2 {LM_REL_L2}")
    else:
        log(what + f"; {diff} of {len(card_routes) * CPU_TOKENS} (token, layer) top-"
            f"{cfg.moe.top_k} sets routed apart on the two sides' own inputs, so held layer by "
            f"layer below")
    if cfg.moe is None:
        return
    # layer by layer: each layer's output on the card against the CPU's on the card's input
    pos = torch.arange(CPU_TOKENS, dtype=torch.int32)
    worst = (0.0, 0.0)
    for i, (x, p, _c, _pos, is_g, _mesh), (y, _aux) in ((i, a, r) for i, a, r in layers):
        got = tr._layer(x.cpu(), cpu_p["layers"][i], cfg_c, pos, is_g)[0]
        r = lm_close(y.cpu(), got, f"13 {name} layer {i} on the card's input")
        worst = (max(worst[0], r[0]), max(worst[1], r[1]))
    head = tr._head(cpu_p, cfg_c)
    last = layers[-1][2][0].cpu()
    r = lm_close(card[0], (rms_norm(last, cpu_p["final_norm"]) @ head)[0],
                 f"13 {name} head on the card's last hidden states")
    log(f"13 {name} layer by layer ({CPU_DEPTH} layers, the CPU given the card's input to each): "
        f"every output within rtol {LM_TOL['rtol']} / atol {LM_TOL['atol']} / relative L2 "
        f"{LM_REL_L2}, largest max |diff| {worst[0]:.4g}, relative L2 {worst[1]:.4g}; the head on "
        f"the card's last hidden states {r[0]:.4g} ({r[1]:.4g})")


def decode_batch_on(dev, arch, cfg, B: int, cell_name: str, seed: int) -> dict:
    """The cell's decode batch at B rows: the cache filled on the card from a
    seeded generator (standard normal, as make_batch fills it), tokens from
    NumPy, cur_len as make_batch sets it."""
    import torch

    from repro_torch.configs import input_specs

    spec = input_specs(arch, arch.cell(cell_name), cfg)["cache"]
    g = torch.Generator(device=dev).manual_seed(seed)
    cache = {n: torch.randn((s[0], B) + s[2:], generator=g, device=dev, dtype=dt)
             for n, (s, dt) in spec.items()}
    S = next(iter(spec.values()))[0][2]
    tokens = np.random.default_rng(seed).integers(0, cfg.vocab, (B,)).astype(np.int32)
    return {"cache": cache, "tokens": torch.from_numpy(tokens).to(dev),
            "cur_len": torch.tensor(min(5, S - 1), dtype=torch.int32)}


def phase13_decode(dev, smi, arch, cfg, params, cpu_p, B: int, why: str, out: dict) -> None:
    """decode_32k (and long_500k where the arch runs it) at full width: warm
    steps at cur_len 5, the profiler's kernels; a check step at S − 2 on the
    first CPU_DEPTH layers against the CPU."""
    import dataclasses

    import torch

    from repro_torch.configs import build_step
    from repro_torch.models import moe as moe_mod

    name = arch.name
    for cell_name, b, seed in (("decode_32k", B, 2), ("long_500k", 1, 3)):
        cell = arch.cell(cell_name)
        if cell.skip:
            log(f"13 {name} {cell_name}: skipped, as the reference skips it ({cell.skip})")
            continue
        step, _ = build_step(arch, cell, cfg)
        t = time.perf_counter()
        batch = decode_batch_on(dev, arch, cfg, b, cell_name, seed)
        sync(dev)
        S = next(iter(batch["cache"].values())).shape[2]
        gb = sum(c.numel() for c in batch["cache"].values()) * 2 / 1e9
        log(f"13 {name} {cell_name}: B = {b}{' (' + why + ')' if cell_name == 'decode_32k' else ''}"
            f", cache {', '.join(f'{n} {tuple(c.shape)}' for n, c in batch['cache'].items())} bf16 "
            f"({gb:.2f} GB) filled in {time.perf_counter() - t:.3f} s")
        logits, _ = step(params, batch)
        sync(dev)
        require(logits.shape == (b, cfg.vocab) and bool(torch.isfinite(logits).all()),
                f"{name} {cell_name}: logits of shape {tuple(logits.shape)} are not finite")
        warm = warm_ms(lambda: step(params, batch), dev, runs=3)
        med = float(np.median(warm))
        out.setdefault("decode_ms", {})[cell_name] = med
        log(f"13 {name} {cell_name} (B = {b}, cur_len {int(batch['cur_len'])}): warm {fmt(warm)} "
            f"ms, median {med:.3f} ms, {b / med * 1e3:.1f} tokens/s; logits finite; card: {smi}")
        if cell_name == "decode_32k":
            top_kernels(lambda: step(params, batch), dev, f"13 {name} decode_32k, one warm step",
                        med, n=5)
            # the check step near the cache end, on the first CPU_DEPTH layers, rows 0-1
            cfg_c = dataclasses.replace(cfg, n_layers=CPU_DEPTH)
            cstep = build_step(arch, cell, cfg_c)[0]
            cut = {"cache": {n: c[:CPU_DEPTH, :2].clone() for n, c in batch["cache"].items()},
                   "tokens": batch["tokens"][:2], "cur_len": torch.tensor(S - 2, dtype=torch.int32)}
            cpu = {"cache": {n: c.cpu() for n, c in cut["cache"].items()},
                   "tokens": cut["tokens"].cpu(), "cur_len": cut["cur_len"]}
            card_routes, cpu_routes = [], []
            with recording(moe_mod, "_route", card_routes):
                card_logits, card_cache = cstep(cut_params(params, CPU_DEPTH, dev), cut)
            with recording(moe_mod, "_route", cpu_routes):
                want, want_cache = cstep(cpu_p, cpu)
            apart = rows_routed_apart(card_routes, cpu_routes)
            n_apart = 0 if apart is None else int(apart.sum())
            require(n_apart < 2, f"13 {name} decode check step: both rows routed apart")
            mx, rel = close_where_routed_alike(card_logits.cpu(), want, apart,
                                               f"13 {name} decode check step")
            rows = [lm_close(card_cache[n][:, :, S - 2].cpu(), want_cache[n][:, :, S - 2],
                             f"13 {name} decode check step, cache {n} rows") for n in card_cache]
            log(f"13 {name} decode_32k check step at cur_len {S - 2} ({CPU_DEPTH} layers, rows "
                f"0-1, over {S - 1} cached rows{'' if cfg.moe is None else f'; {n_apart} row(s) routed apart, not held'}): "
                f"logits equal the CPU's, max |diff| {mx:.4g} "
                f"(relative L2 {rel:.4g}); written cache rows "
                + ", ".join(f"{n} {r[0]:.4g} ({r[1]:.4g})" for n, r in zip(card_cache, rows)))
            del cut, cpu, card_cache, want_cache
        del batch, logits
        torch.cuda.empty_cache()


def phase13_engine(dev, smi, arch, cfg, params, cpu_p) -> None:
    """``DecodeEngine`` over the arch's cache: 6 requests through 4 slots at
    full depth (timed); then on the first CPU_DEPTH layers with every tick's
    tokens and logits recorded and replayed through the CPU's decode_step."""
    import dataclasses

    import torch

    from repro_torch.models import decode_step, init_cache
    from repro_torch.models import moe as moe_mod
    from repro_torch.serve import DecodeEngine, ServeConfig
    from repro_torch.serve import engine as engine_mod

    name = arch.name
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab, int(rng.integers(4, 9))).tolist() for _ in range(6)]
    scfg = ServeConfig(max_batch=4, max_len=256, eos_token=-1)

    def run(p, c, record=None):
        eng = DecodeEngine(p, c, scfg, device=dev)
        for pr in prompts:
            eng.submit(pr, max_new=8)
        t = time.perf_counter()
        if record is None:
            done = eng.run_until_drained()
        else:
            with recording(engine_mod, "decode_step", record):
                done = eng.run_until_drained()
        return eng, done, time.perf_counter() - t

    eng, done, wall = run(params, cfg)
    require(sorted(done) == list(range(6)) and all(len(v) == 8 for v in done.values()),
            f"13 {name} DecodeEngine: {sorted(done)} finished")
    log(f"13 {name} DecodeEngine (4 slots, cache {', '.join(sorted(eng.cache))}): 6 requests of "
        f"4-8 prompt tokens, 8 new each, 2 in reused slots; {eng.cur_len} ticks in {wall:.3f} s, "
        f"{wall / eng.cur_len * 1e3:.3f} ms a tick, {6 * 8 / wall:.1f} generated tokens/s; "
        f"card: {smi}")
    cfg_c = dataclasses.replace(cfg, n_layers=CPU_DEPTH)
    ticks, card_routes = [], []
    with recording(moe_mod, "_route", card_routes):
        eng, done_c, _ = run(cut_params(params, CPU_DEPTH, dev), cfg_c, ticks)
    n_moe = sum(cfg_c.is_moe(i) for i in range(CPU_DEPTH))
    cache = init_cache(cfg_c, scfg.max_batch, scfg.max_len, device="cpu")
    worst, gaps, n_apart = (0.0, 0.0), [], 0
    for t, (_, (_p, _c, toks, cur, _cfg), (card_logits, _)) in enumerate(ticks):
        cpu_routes = []
        with recording(moe_mod, "_route", cpu_routes):
            want, cache = decode_step(cpu_p, cache, toks.cpu(), cur, cfg_c)
        apart = rows_routed_apart(card_routes[t * n_moe:(t + 1) * n_moe], cpu_routes)
        n_apart += 0 if apart is None else int(apart.sum())
        r = close_where_routed_alike(card_logits.cpu(), want, apart,
                                     f"13 {name} DecodeEngine tick {cur}")
        if r is None:
            continue
        worst = (max(worst[0], r[0]), max(worst[1], r[1]))
        alike = slice(None) if apart is None else ~apart
        pick = card_logits.float().argmax(-1).cpu()[alike]
        w = want.float()[alike]
        gaps.append(float((w.max(-1).values - w.gather(-1, pick[:, None])[:, 0]).max()))
    rows = len(ticks) * scfg.max_batch
    require(n_apart <= 0.1 * rows, f"13 {name} DecodeEngine: {n_apart} of {rows} (tick, slot) "
            f"rows routed apart between the card and the CPU")
    require(max(gaps) <= LM_TOL["atol"], f"13 {name} DecodeEngine: a token the card picked is "
            f"{max(gaps):.4g} below the CPU's largest logit")
    log(f"13 {name} DecodeEngine on {CPU_DEPTH} layers, every tick replayed through the CPU's "
        f"decode_step on the card's own tokens ({len(ticks)} ticks, slots reused; {n_apart} of "
        f"{rows} (tick, slot) rows routed apart on the two sides' own inputs, not held): logits "
        f"within tolerance, largest max |diff| {worst[0]:.4g} (relative L2 {worst[1]:.4g}); each picked "
        f"token's CPU logit within {max(gaps):.3g} of the CPU's largest (limit {LM_TOL['atol']}); "
        f"{sum(1 for g in gaps if g == 0.0)} of {len(gaps)} ticks picked the CPU's argmax in "
        f"every slot")
    del eng, cache, done_c
    torch.cuda.empty_cache()


def phase13_launchers(smi: str) -> None:
    """``python -m repro_torch.launch.serve`` in child processes side by side
    on the card: the LM mode over deepseek's MLA cache and the GNN-PE mode."""
    t = time.perf_counter()
    argvs = (["--mode", "lm", "--arch", "deepseek-v2-lite-16b", "--requests", "6"],
             ["--mode", "gnnpe", "--n", "2000", "--requests", "20"])
    procs = [subprocess.Popen([sys.executable, "-m", "repro_torch.launch.serve", *argv],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=child_env()) for argv in argvs]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for argv, p, (so, se) in zip(argvs, procs, outs):
        require(p.returncode == 0 and "[serve]" in so,
                f"13: repro_torch.launch.serve {' '.join(argv)} exited {p.returncode}: "
                f"{se[-2000:]}")
        log(f"13 python -m repro_torch.launch.serve {' '.join(argv)} in a child process: "
            f"{so.strip().splitlines()[-1]}; card: {smi}")
    log(f"13 the two serve launchers side by side: {time.perf_counter() - t:.3f} s")


def phase13_lm_family(dev, flush, smi: str) -> dict:
    """The rest of the LM family at full width, through ``repro_torch.configs``."""
    import dataclasses

    import torch

    from repro_torch.configs import get_arch, init_params, resolve_config

    out: dict = {"K6": 0, "K6_err": 0.0}
    for name, depth, b_pre, b_dec, why in LM_FAMILY:
        t0 = time.perf_counter()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        arch = get_arch(name)
        full = resolve_config(arch, arch.cell("prefill_32k"), smoke=False)
        cfg = full if depth is None else dataclasses.replace(full, n_layers=depth[0])
        t = time.perf_counter()
        params = init_params(arch, cfg, seed=0, device=dev)
        sync(dev)
        log(f"13 {name} ({arch.source}): {full.n_params()} params ({2 * full.n_params() / 1e9:.1f} "
            f"GB in bf16, {full.n_active_params()} active); depth "
            + (f"all {full.n_layers} layers" if depth is None else
               f"cut {full.n_layers} -> {depth[0]} ({depth[1]})")
            + f": {cfg.n_params()} params drawn on the card in {time.perf_counter() - t:.3f} s "
            f"(float32 from a seeded CUDA generator, each tensor cast to bf16 as drawn; the router "
            f"float32)")
        phase13_prefill(dev, flush, smi, arch, cfg, params, b_pre, out)
        t = time.perf_counter()
        cpu_p = cut_params(params, CPU_DEPTH, "cpu")
        log(f"13 {name}: the first {CPU_DEPTH} layers, embedding and head copied to the host for "
            f"the CPU's runs in {time.perf_counter() - t:.3f} s")
        phase13_cpu_prefill(dev, arch, cfg, params, cpu_p)
        phase13_decode(dev, smi, arch, cfg, params, cpu_p, b_dec, why, out)
        if cfg.use_mla:
            phase13_engine(dev, smi, arch, cfg, params, cpu_p)
        log(f"13 {name}: peak device memory {torch.cuda.max_memory_allocated(dev) / 2**30:.3f} "
            f"GiB, {time.perf_counter() - t0:.3f} s; card: {smi}")
        del params, cpu_p
    phase13_launchers(smi)
    return out


# ---- phase 14 -----------------------------------------------------------------

GNN_ARCHS = ("gin-tu", "graphsage-reddit", "schnet", "mace")
GNN_LOSS_REL = 1e-4  # a GNN step's loss, card against CPU: within this · max(1, |CPU loss|)
LAYER_REL = 1e-4  # the first layer on the card against its float64 recomputation, · (1 + max|ref|)
FN_GRAD_REL = 1e-5  # segment_sum's gradient against autograd of the plain sum, relative L2
FN_EDGES = 4 << 20  # the edges of that gradient check
# the partition loss against the dense path's within PART_LOSS · max(1, |dense loss|), each
# gradient element within PART_GRAD · max(1, the leaf's max |g|): the reference test's limits,
# set there for a loss of about 1.4, scaled to the magnitude (gin's loss here is about 1.8e3)
PART_LOSS = 2e-4
PART_GRAD = 5e-4
PLANTED = 3  # index rows planted a query in the online cell
HEAD_ROWS = 1 << 20  # the online counts held exactly against the CPU's on these first rows


def peak_gib(dev) -> float:
    import torch

    return torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda" else float("nan")


def reset_peak(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)


def on_cpu(tree):
    from repro_torch.train import tree_map

    return tree_map(lambda t: t.detach().cpu(), tree)


class GnnBatches:
    """``make_batch`` of a GNN cell once for each layout of its specs: the
    four archs draw a cell's batch alike unless one draws positions."""

    def __init__(self, smoke: bool, smi: str):
        self.smoke, self.smi, self.cache = smoke, smi, {}

    def get(self, arch, cell, cfg, dev) -> dict:
        from repro_torch.configs import input_specs, make_batch

        key = (cell.name, tuple(input_specs(arch, cell, cfg, smoke=self.smoke)))
        if key not in self.cache:
            t = time.perf_counter()
            self.cache[key] = make_batch(arch, cell, cfg, seed=0, smoke=self.smoke, device=dev)
            sync(dev)
            log(f"14 {cell.name} batch of {', '.join(key[1])}: drawn (make_batch, NumPy) and on "
                f"the card in {time.perf_counter() - t:.3f} s")
        return self.cache[key]


def gnn_step_vs_cpu(step, params, opt, batch, what: str) -> tuple:
    """One train step on the card and the same step on the CPU from copies of
    the same params, state and batch: the losses within ``GNN_LOSS_REL``, each
    gradient leaf (AdamW's first moment after the step, 0.1 · the clipped
    gradient) within phase 12a's relative L2 of the CPU's → (new params, new
    state, loss, CPU loss, worst ratio to the limit).  Not per element: a leaf
    whose entries are small differences of large terms (mace's second mix
    bias, 7.9e-6 beside terms of ~1e-2) differs by 1e-3 of its max between
    any two summation orders."""
    from repro_torch.train import tree_leaves

    new_p, new_o, met = step(params, opt, batch)
    loss = float(met["loss"])
    _, cpu_o, cpu_m = step(on_cpu(params), on_cpu(opt), on_cpu(batch))
    want = float(cpu_m["loss"])
    require(math.isfinite(loss) and abs(loss - want) <= GNN_LOSS_REL * max(1.0, abs(want)),
            f"{what}: loss {loss!r} on the card, {want!r} on the CPU")
    n = len(tree_leaves(cpu_o["m"]))
    worst = grads_close(new_o["m"], cpu_o["m"], f"{what} gradients", rows=tuple(range(n)))
    return new_p, new_o, loss, want, worst


def phase14a_zoo(dev, smi: str, smoke: bool, out: dict) -> None:
    """Each GNN arch at its published width on full_graph_sm, molecule and
    minibatch_lg at the cells' full sizes (nothing cut)."""
    from repro_torch.configs import build_step, get_arch, init_params, opt_init, resolve_config
    from repro_torch.train import OptConfig, tree_leaves

    batches = GnnBatches(smoke, smi)
    opt_cfg = OptConfig(lr=1e-3, warmup_steps=0, total_steps=100)
    for cell_name in ("full_graph_sm", "molecule", "minibatch_lg"):
        for name in GNN_ARCHS:
            arch = get_arch(name)
            cell = arch.cell(cell_name)
            cfg = resolve_config(arch, cell, smoke=smoke)
            reset_peak(dev)
            params = init_params(arch, cfg, seed=0, device=dev)
            batch = batches.get(arch, cell, cfg, dev)
            step, takes_opt = build_step(arch, cell, cfg, opt_cfg=opt_cfg)
            require(takes_opt, f"14a {name}/{cell_name}: build_step gave no train step")
            what = f"14a {name}/{cell_name}"
            new_p, new_o, loss, want, worst = gnn_step_vs_cpu(step, params, opt_init(params),
                                                              batch, what)
            ms, _ = warm_train_steps(step, [new_p, new_o], batch, dev, n=5)
            peak = peak_gib(dev)
            out[(name, cell_name)] = (float(np.median(ms)), peak)
            log(f"{what} ({cfg.kind}, H = {cfg.d_hidden}, {cfg.n_layers} layers, "
                f"{sum(p.numel() for p in tree_leaves(params))} params; the batch's "
                + ", ".join(f"{k} {tuple(v.shape)}" for k, v in batch.items() if k != "blocks")
                + f"): loss {loss:.6f} on the card, {want:.6f} on the CPU; gradients at "
                f"{worst:.3f} of the relative L2 limit; warm step median {np.median(ms):.3f} ms "
                f"({fmt(ms)}); peak {peak:.3f} GiB; card: {smi}")
    batches.cache.clear()


def phase14b_ogb(dev, smi: str, smoke: bool, out: dict) -> None:
    """ogb_products at the cell's full size (2,449,056 padded nodes,
    123,718,304 directed edges) for each arch: the first layer against its
    float64 recomputation on the card, ``segment_sum``'s gradient against
    autograd of the plain sum on the first 4 M edges, a train step."""
    import torch

    from repro_torch.configs import build_step, get_arch, init_params, opt_init, resolve_config
    from repro_torch.models import gnn as gm
    from repro_torch.train import OptConfig, tree_map

    batches = GnnBatches(smoke, smi)
    opt_cfg = OptConfig(lr=1e-3, warmup_steps=0, total_steps=100)
    gen = torch.Generator(device=dev).manual_seed(14)
    for name in GNN_ARCHS:
        arch = get_arch(name)
        cell = arch.cell("ogb_products")
        cfg = resolve_config(arch, cell, smoke=smoke)
        what = f"14b {name}/ogb_products"
        reset_peak(dev)
        params = init_params(arch, cfg, seed=0, device=dev)
        batch = batches.get(arch, cell, cfg, dev)
        N, E = batch["node_feat"].shape[0], batch["edge_index"].shape[0]
        geometric = cfg.kind in ("schnet", "mace")
        chunk = gm._edge_chunk(cfg, None)

        # ---- the first layer against its float64 recomputation, chunk by chunk ----
        t = time.perf_counter()
        with torch.no_grad():
            h0 = gm._mlp_apply(params["encode"], batch["node_feat"])
            edges = gm._sorted_edges(batch["edge_index"], N)
            if geometric:
                fn = gm._schnet_rows if cfg.kind == "schnet" else gm._mace_rows

                def first(p, h, pos, c):
                    return gm._by_rows(fn, p, h, pos, edges, c, chunk)

                part = "layer 1"
            else:
                how = "sum" if cfg.kind == "gin" else cfg.aggregator

                def first(p, h, pos, c):
                    return gm._aggregate(h, edges, how, chunk)

                part = f"layer 1's {how} aggregation"
            args = (params["layers"][0], h0, batch.get("positions"), cfg)
            t1 = time.perf_counter()
            got = first(*args)
            sync(dev)
            wall = (time.perf_counter() - t1) * 1e3
            if dev.type == "cuda":
                top_kernels(lambda: first(*args), dev, f"{what} {part} forward ({wall:.3f} ms)",
                            wall, n=5, cpu_ops=False)
            ref = first(tree_map(lambda x: x.double(), params["layers"][0]), h0.double(),
                        None if args[2] is None else args[2].double(),
                        dataclasses.replace(cfg, dtype="float64"))
            top = float(ref.abs().max())
            err = float((got.double() - ref).abs().max())
            del got, ref
        require(err <= LAYER_REL * (1 + top),
                f"{what}: {part} |err| {err:.3g} against float64 > {LAYER_REL} x (1 + {top:.3g})")
        checks = (f"{part} within {err:.3g} of its float64 recomputation (max |ref| {top:.4g}, "
                  f"{chunk} edges a chunk)")

        # ---- segment_sum's gradient against autograd of the plain sum ----
        k = min(FN_EDGES, E)
        src, dst = edges.src[:k], edges.dst[:k]
        h = h0.detach().requires_grad_(True)
        g_out = torch.randn(h0.shape, generator=gen, device=dev)
        small = k // 3 + 1  # three chunks, the last short
        (g_fn,) = torch.autograd.grad(gm.segment_sum(h, src, dst, N, small), h, g_out)
        (g_plain,) = torch.autograd.grad(h.new_zeros(h0.shape).index_add(0, dst, h[src]), h, g_out)
        rel = float((g_fn - g_plain).norm() / g_plain.norm())
        require(rel <= FN_GRAD_REL, f"{what}: segment_sum's gradient on {k} edges, relative L2 "
                f"{rel:.3g} against the plain sum's autograd > {FN_GRAD_REL}")
        checks += (f"; segment_sum's gradient on the first {k} edges in chunks of {small} at "
                   f"relative L2 {rel:.3g} of the plain sum's autograd")
        del h0, edges, src, dst, h, g_out, g_fn, g_plain
        check_s = time.perf_counter() - t

        # ---- one train step (nothing compiles: the first step is a warm one) ----
        step, _ = build_step(arch, cell, cfg, opt_cfg=opt_cfg)
        t = time.perf_counter()
        _, _, met = step(params, opt_init(params), batch)
        sync(dev)
        ms = (time.perf_counter() - t) * 1e3
        loss = float(met["loss"])
        require(math.isfinite(loss), f"{what}: loss {loss!r}")
        peak = peak_gib(dev)
        out[(name, "ogb_products")] = (ms, peak)
        log(f"{what} ({cfg.kind}, H = {cfg.d_hidden}, {cfg.n_layers} layers; N = {N}, E = {E}, "
            f"nothing cut): {checks} ({check_s:.3f} s); train step loss {loss:.6f} in "
            f"{ms:.3f} ms; peak {peak:.3f} GiB; card: {smi}")
        del params, batch
    batches.cache.clear()


def partition_configs(smoke: bool) -> dict:
    """gin-tu's and graphsage-reddit's ogb_products configs, partition-parallel on 2 shards."""
    from repro_torch.configs import get_arch, resolve_config

    out = {}
    for name in ("gin-tu", "graphsage-reddit"):
        arch = get_arch(name)
        cfg = resolve_config(arch, arch.cell("ogb_products"), smoke=smoke)
        out[name] = (arch, dataclasses.replace(cfg, partition_parallel=True, n_shards=2))
    return out


def partition_worker(rank: int, port: str, directory: str, device: str, smoke: bool) -> int:
    """One rank of phase 14c: this shard's partition-parallel train step
    (``build_step`` with ``partition_parallel``) over gloo; rank 0 writes the
    loss and the first moments of each arch."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import build_step, init_params, opt_init
    from repro_torch.train import OptConfig, tree_leaves, tree_unflatten

    dev = torch.device(device)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2,
                            rank=rank)
    try:
        arrays = np.load(Path(directory) / "batch.npz")
        shard = {k: torch.from_numpy(arrays[k][rank:rank + 1]).to(dev) for k in arrays.files}
        for name, (arch, cfg) in partition_configs(smoke).items():
            saved = np.load(Path(directory) / f"params_{name}.npz")
            template = init_params(arch, cfg, seed=0, device="cpu")
            params = tree_unflatten(template, [torch.from_numpy(saved[f"arr_{i}"]).to(dev) for i
                                               in range(len(tree_leaves(template)))])
            step, _ = build_step(arch, arch.cell("ogb_products"), cfg,
                                 OptConfig(lr=1e-3, warmup_steps=0, total_steps=100))
            _, opt, met = step(params, opt_init(params), shard)
            if rank == 0:
                np.savez(Path(directory) / f"got_{name}.npz", float(met["loss"]),
                         float(met["grad_norm"]), *[x.cpu().numpy() for x in tree_leaves(opt["m"])])
        dist.barrier()
    finally:
        dist.destroy_process_group()
    print("partition worker ok", flush=True)
    return 0


def phase14c_partition(dev, smi: str, smoke: bool, root: Path) -> None:
    """The partition-parallel loss in 2 processes sharing the card over gloo,
    on a 20,000-vertex ER graph in 2 shards, against the dense path here."""
    import torch

    from repro_torch.configs import build_step, init_params, opt_init
    from repro_torch.graphs import erdos_renyi, partition_graph
    from repro_torch.models import build_partition_batch
    from repro_torch.train import OptConfig, tree_leaves

    t = time.perf_counter()
    n = 200 if smoke else 20_000
    g = erdos_renyi(n, avg_degree=8, n_labels=4, seed=14)
    cfgs = partition_configs(smoke)
    d_in = next(iter(cfgs.values()))[1].d_in
    n_cls = next(iter(cfgs.values()))[1].n_classes
    rng = np.random.default_rng(14)
    feat = rng.normal(size=(n, d_in)).astype(np.float32)
    labels = rng.integers(0, n_cls, n).astype(np.int32)
    part = partition_graph(g, 2, seed=0)
    pb = build_partition_batch(g, feat, labels, part, 2)
    np.savez(root / "batch.npz", **pb)
    params = {}
    for name, (arch, cfg) in cfgs.items():
        params[name] = init_params(arch, cfg, seed=0, device=dev)
        np.savez(root / f"params_{name}.npz", *[x.cpu().numpy() for x in tree_leaves(params[name])])
    log(f"14c ER graph n = {n}, {g.n_edges} edges, 2 shards (edge cut {part.edge_cut(g)}; "
        f"shards of {pb['node_feat'].shape[1]} rows, {pb['boundary_index'].shape[1]} boundary "
        f"rows, {pb['halo_flat'].shape[1]} halo slots, {pb['edge_index'].shape[1]} edges) in "
        f"{time.perf_counter() - t:.3f} s")
    port = free_port()
    t = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--partition-worker",
                               str(r), str(port), str(root), dev.type, "smoke" if smoke else "full"],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=child_env()) for r in range(2)]
    e = g.edge_array()
    dense = {"node_feat": torch.from_numpy(feat).to(dev),
             "edge_index": torch.from_numpy(np.concatenate([e, e[:, ::-1]]).astype(np.int32)).to(dev),
             "labels": torch.from_numpy(labels).to(dev)}
    want = {}
    for name, (arch, cfg) in cfgs.items():
        dcfg = dataclasses.replace(cfg, partition_parallel=False)
        step, _ = build_step(arch, arch.cell("ogb_products"), dcfg,
                             OptConfig(lr=1e-3, warmup_steps=0, total_steps=100))
        _, opt, met = step(params[name], opt_init(params[name]), dense)
        want[name] = (float(met["loss"]), float(met["grad_norm"]), tree_leaves(opt["m"]))
    try:
        outs = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (so, se) in zip(procs, outs):
        require(p.returncode == 0 and "partition worker ok" in so,
                f"14c: a partition worker exited {p.returncode}: {se[-2000:]}")
    for name, (loss, gn, m) in want.items():
        got = np.load(root / f"got_{name}.npz")
        p_loss, p_gn = float(got["arr_0"]), float(got["arr_1"])
        require(abs(p_loss - loss) <= PART_LOSS * max(1.0, abs(loss)),
                f"14c {name}: partition loss {p_loss!r} against the dense {loss!r}")

        def grad(x, norm):
            return np.asarray(x, np.float64) / (0.1 * min(1.0, 1.0 / max(norm, 1e-9)))

        worst = 0.0
        for i, w in enumerate(m):
            want_g = grad(w.cpu().numpy(), gn)
            lim = PART_GRAD * max(1.0, float(np.abs(want_g).max()))
            diff = float(np.abs(grad(got[f"arr_{i + 2}"], p_gn) - want_g).max())
            require(diff <= lim, f"14c {name}: gradient leaf {i} differs by {diff:.3g} > {lim:.3g}")
            worst = max(worst, diff / lim)
        log(f"14c {name}: partition-parallel train step in 2 processes over gloo (halo rows "
            f"through the host): loss {p_loss:.6f} against the dense path's {loss:.6f} on the card "
            f"(|diff| {abs(p_loss - loss):.3g}, limit {PART_LOSS} x max(1, |loss|)), gradients at "
            f"{worst:.3g} of their limit ({PART_GRAD} x max(1, max |g|)); card: {smi}")
    log(f"14c: the two processes and the dense path in {time.perf_counter() - t:.3f} s")


def phase14d_gnnpe(dev, smi: str, smoke: bool, out: dict) -> None:
    """GNN-PE's own cells at their full configs: one offline train step of
    64 stacked partition encoders × 8,192 pairs against the CPU, and the
    online scan over 10⁸ indexed paths in its four variants, with planted
    rows, the first 2²⁰ rows' counts held exactly against the CPU's."""
    import itertools

    import torch

    from repro_torch.configs import build_step, get_arch, init_params, make_batch, opt_init
    from repro_torch.configs import resolve_config
    from repro_torch.train import OptConfig

    arch = get_arch("gnn-pe-offline")
    cell = arch.shapes[0]
    cfg = resolve_config(arch, cell, smoke=smoke)
    reset_peak(dev)
    params = init_params(arch, cfg, seed=0, device=dev)
    batch = make_batch(arch, cell, cfg, seed=0, smoke=smoke, device=dev)
    step, takes_opt = build_step(arch, cell, cfg, OptConfig(lr=1e-3, warmup_steps=0, total_steps=100))
    require(takes_opt, "14d gnn-pe-offline: no train step")
    what = "14d gnn-pe-offline/offline_pairs"
    new_p, new_o, loss, want, worst = gnn_step_vs_cpu(step, params, opt_init(params), batch, what)
    ms, _ = warm_train_steps(step, [new_p, new_o], batch, dev, n=3)
    out["offline"] = (float(np.median(ms)), peak_gib(dev))
    log(f"{what} (m = {cfg.m} encoders x {cfg.pairs_per_step} pairs, theta = {cfg.theta}): loss "
        f"{loss:.6f} on the card, {want:.6f} on the CPU; gradients at {worst:.3f} of the relative "
        f"L2 limit; warm step median {np.median(ms):.3f} ms ({fmt(ms)}); peak "
        f"{out['offline'][1]:.3f} GiB; card: {smi}")
    del params, new_p, new_o, batch

    arch = get_arch("gnn-pe-online")
    cell = arch.shapes[0]
    base = resolve_config(arch, cell, smoke=smoke)
    for qi, lh in itertools.product((False, True), (False, True)):
        cfg = dataclasses.replace(base, quantize_int8=qi, label_hash=lh)
        what = f"14d gnn-pe-online/online_scan (quantize_int8={qi}, label_hash={lh})"
        reset_peak(dev)
        params = init_params(arch, cfg, seed=0, device=dev)
        batch = make_batch(arch, cell, cfg, seed=0, smoke=smoke, device=dev)
        step, _ = build_step(arch, cell, cfg)
        before = step(params, batch)
        Q = batch["q"].shape[0]
        head = min(HEAD_ROWS, cfg.n_paths)
        rows = torch.from_numpy(np.random.default_rng(14).choice(head, Q * PLANTED,
                                                                  replace=False)).to(dev)
        owner = torch.arange(Q, device=dev).repeat_interleave(PLANTED)

        def at(r):
            return {k: v[r] for k, v in params.items()}

        lost = step(at(rows), batch)
        params["emb"][rows] = batch["q"][owner]
        params["emb0"][rows] = batch["q0"][owner]
        gained = step(at(rows), batch)
        after = step(params, batch)
        rise = after - before
        require(torch.equal(rise, gained - lost), f"{what}: counts rose by {rise.tolist()}, the "
                f"planted rows account for {(gained - lost).tolist()}")
        require(bool((gained >= PLANTED).all()), f"{what}: a planted row missed its query: "
                f"{gained.tolist()}")
        exact = int((rise == PLANTED).sum())
        got = step({k: v[:head] for k, v in params.items()}, batch).cpu()
        cpu = step(on_cpu({k: v[:head] for k, v in params.items()}), on_cpu(batch))
        require(torch.equal(got, cpu), f"{what}: the first {head} rows' counts differ from the "
                f"CPU's: {got.tolist()} against {cpu.tolist()}")
        ms = warm_ms(lambda: step(params, batch), dev, runs=2)
        peak = peak_gib(dev)
        out[("online", qi, lh)] = (float(np.median(ms)), peak)
        log(f"{what}: {cfg.n_paths} paths x {cfg.d_cat} ({params['emb'].dtype}), {Q} queries; "
            f"counts before {before.sum().item()} in all, {PLANTED} rows planted a query: "
            f"{exact} of {Q} rose by exactly {PLANTED}, every rise = the planted rows' matches "
            f"minus the overwritten rows'; the first {head} rows' counts equal the CPU's; warm "
            f"scan median {np.median(ms):.3f} ms ({fmt(ms)}); peak {peak:.3f} GiB; card: {smi}")
        del params, batch


def phase14e_launchers(smi: str, extra: tuple = (), beside=lambda: None) -> None:
    """``python -m repro_torch.launch.train --smoke --steps 20`` for each GNN
    arch and gnn-pe-offline, in child processes side by side on the card,
    while ``beside()`` runs here."""
    t = time.perf_counter()
    names = GNN_ARCHS + ("gnn-pe-offline",)
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", name, "--smoke",
         "--steps", "20", *extra], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=child_env()) for name in names}
    try:
        beside()
        outs = {name: p.communicate(timeout=600) for name, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    for name, (so, se) in outs.items():
        rc = procs[name].returncode
        require(rc == 0 and "[train] done" in so,
                f"14e: repro_torch.launch.train --arch {name} exited {rc}: {se[-2000:]}")
        log(f"14e python -m repro_torch.launch.train --arch {name} --smoke --steps 20: "
            f"{so.strip().splitlines()[-1]}")
    log(f"14e the five launchers side by side, beside 14c: {time.perf_counter() - t:.3f} s; "
        f"card: {smi}")


def phase14_gnn(dev, smi: str, smoke: bool = False, extra: tuple = ()) -> dict:
    """The GNN zoo and GNN-PE's own cells through ``repro_torch.configs``."""
    import tempfile

    out: dict = {}
    t = time.perf_counter()
    phase14a_zoo(dev, smi, smoke, out)
    log(f"phase 14a the zoo on full_graph_sm / molecule / minibatch_lg: "
        f"{time.perf_counter() - t:.3f} s; card: {smi}")
    t = time.perf_counter()
    phase14b_ogb(dev, smi, smoke, out)
    log(f"phase 14b the zoo on ogb_products: {time.perf_counter() - t:.3f} s; card: {smi}")
    t = time.perf_counter()

    def partition():  # 14c, with 14e's children beside it (no metric reads 14c's time)
        with tempfile.TemporaryDirectory() as d:
            phase14c_partition(dev, smi, smoke, Path(d))
        log(f"phase 14c the partition-parallel loss in 2 processes: "
            f"{time.perf_counter() - t:.3f} s; card: {smi}")

    phase14e_launchers(smi, extra, beside=partition)
    t = time.perf_counter()
    phase14d_gnnpe(dev, smi, smoke, out)
    log(f"phase 14d gnn-pe-offline and gnn-pe-online: {time.perf_counter() - t:.3f} s; card: {smi}")
    return out


# ---- phase 15: the meshes ------------------------------------------------------------------

MESH_T = 4096  # tokens (and sequence length) a data shard of 15a, a microbatch of 15b
PIPE_M = 4  # 15b's microbatches


def mesh_times(fn, dev, runs: int = 3) -> list:
    """Warm ms of ``fn()`` on the host clock to a ``synchronize``, after one
    untimed call."""
    fn()
    return warm_ms(fn, dev, runs)


def mesh_worker(kind: str, rank: int, port: str, directory: str, device: str,
                smoke: bool) -> int:
    """One rank of phase 15a (``moe``: 4 ranks, a (data 2 × model 2) mesh) or
    15b (``pipe``: 2 ranks, a ``pipe`` mesh) over gloo on ``device`` (the
    card; the CPU and the smoke configs to rehearse it); writes its readings
    to ``DIR/{kind}_{rank}.json``."""
    import torch
    import torch.distributed as dist

    world = 4 if kind == "moe" else 2
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                            rank=rank)
    try:
        with torch.no_grad():
            dev = torch.device(device)
            out = (mesh_moe_rank if kind == "moe" else mesh_pipe_rank)(rank, dev, smoke)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    (Path(directory) / f"{kind}_{rank}.json").write_text(json.dumps(out))
    print("mesh worker ok", flush=True)
    return 0


def mesh_moe_rank(rank: int, dev, smoke: bool) -> dict:
    """15a on one rank: deepseek-v2-lite-16b's first 2 layers at the published
    width from seeded params; its first MoE layer on this data shard's 4,096
    tokens, expert-parallel with ``fsdp`` off and on, against the local
    ``moe_block`` on the same tokens; then ``lm_forward(mesh=)`` on this data
    shard's sequence against the local forward."""
    import torch

    from repro_torch.configs import get_arch, init_params, resolve_config
    from repro_torch.dist.sharding import DP, P, lm_param_specs, local_shard, shard_tree
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import (expert_parallel_specs, lm_forward, moe_block,
                                    moe_token_spec)
    from repro_torch.models import moe as moe_mod

    arch = get_arch("deepseek-v2-lite-16b")
    cfg = dataclasses.replace(resolve_config(arch, arch.cell("prefill_32k"), smoke=smoke),
                              n_layers=2)
    T = 64 if smoke else MESH_T
    params = init_params(arch, cfg, seed=0, device=dev)
    mesh = make_local_mesh(2, 2, device=dev)
    out = {"coord": list(mesh.get_coordinate())}
    gen = torch.Generator(device=dev).manual_seed(15)
    x = torch.randn((2 * T, cfg.d_model), generator=gen, device=dev).to(cfg.compute_dtype)
    xspec = moe_token_spec(x.shape[0], mesh)
    xl = local_shard(x, xspec, mesh)
    full = params["layers"][1]["moe"]
    for fsdp in (False, True):
        mcfg = dataclasses.replace(cfg.moe, fsdp=fsdp)
        specs = lm_param_specs({"layers": [{"moe": full}]}, fsdp=fsdp)["layers"][0]["moe"]
        local = shard_tree(full, specs, mesh)
        routes = []
        with recording(moe_mod, "_route", routes):
            got, _ = moe_block(xl, local, mcfg, mesh)
            want, _ = moe_block(xl, full, mcfg)
        plans = [moe_mod.dispatch_plan(r[0], r[1], mcfg) for _, _, r in routes]
        require(all(torch.equal(plans[0][k], plans[1][k]) for k in ("token", "expert", "keep")),
                f"15a fsdp={fsdp}: the kept and dropped (token, expert) sets differ from the "
                f"local moe_block's")
        mx, rel = lm_close(got.cpu(), want.cpu(), f"15a rank {rank} MoE layer fsdp={fsdp}")
        # fsdp's all-gathers through the host take about 1.5 s a call: one warm run
        ms = mesh_times(lambda: moe_block(xl, local, mcfg, mesh), dev, runs=1 if fsdp else 3)
        solo = mesh_times(lambda: moe_block(xl, full, mcfg), dev)
        out[f"moe_fsdp{int(fsdp)}"] = {
            "max_abs": mx, "rel_l2": rel, "ms": ms, "local_ms": solo,
            "kept": int(plans[0]["keep"].sum()), "dropped": int((~plans[0]["keep"]).sum())}
        del local
    tokens = torch.randint(0, cfg.vocab, (2, T), generator=gen, device=dev)
    mine = local_shard(tokens, P(DP, None), mesh)
    local = shard_tree(params, expert_parallel_specs(params), mesh)
    reset_counters()
    got = lm_forward(local, mine, cfg, mesh)[0]
    out["K6"] = counters()["K6"]
    require(out["K6"] == cfg.n_layers or dev.type != "cuda", f"15a rank {rank}: K6 launched "
            f"{out['K6']} times in a {cfg.n_layers}-layer forward")
    want = lm_forward(params, mine, cfg)[0]
    mx, rel = lm_close(got.cpu(), want.cpu(), f"15a rank {rank} lm_forward(mesh=) logits")
    del got, want
    fa_before = fa.LAUNCHES
    ms = mesh_times(lambda: lm_forward(local, mine, cfg, mesh), dev)
    solo = mesh_times(lambda: lm_forward(params, mine, cfg), dev)
    require(fa.LAUNCHES > fa_before or dev.type != "cuda", "15a: the timed forwards launched no K6")
    out["lm"] = {"max_abs": mx, "rel_l2": rel, "ms": ms, "local_ms": solo,
                 "peak_gib": peak_gib(dev)}
    return out


def mesh_pipe_rank(rank: int, dev, smoke: bool) -> dict:
    """15b on one rank: gemma3-1b's 26 layers at the published width as 2
    stages of 13, ``pipeline_apply`` over M = 4 microbatches of (1, 4,096,
    1,152) hidden states against the 26 layers in sequence on the card."""
    import torch

    from repro_torch.configs import get_arch, init_params, resolve_config
    from repro_torch.dist import pipeline_apply
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import lm_layers

    arch = get_arch("gemma3-1b")
    cfg = resolve_config(arch, arch.cell("prefill_32k"), smoke=smoke)
    params = init_params(arch, cfg, seed=0, device=dev)
    mesh = make_mesh((2,), ("pipe",), device=dev)
    k = mesh.get_local_rank("pipe")
    per = cfg.n_layers // 2
    gen = torch.Generator(device=dev).manual_seed(15)
    tokens = torch.randint(0, cfg.vocab, (PIPE_M, 1, 64 if smoke else MESH_T), generator=gen,
                           device=dev)
    xs = params["embed"][tokens].to(cfg.compute_dtype)  # (M, 1, S, D)
    mine = params["layers"][k * per:(k + 1) * per]

    def stage(layers, x):
        return lm_layers(x, layers, cfg, start=k * per)[0]

    reset_counters()
    got = pipeline_apply(stage, mine, xs, mesh)
    k6 = counters()["K6"]
    require(k6 == per * PIPE_M or dev.type != "cuda", f"15b rank {rank}: K6 launched {k6} times, "
            f"not {per} layers x {PIPE_M} microbatches")

    def sequential():
        return torch.stack([lm_layers(x, params["layers"], cfg)[0] for x in xs])

    want = sequential()
    equal = bool(torch.equal(got, want))
    diff = float((got.float() - want.float()).abs().max())
    require(equal, f"15b rank {rank}: the pipeline's outputs differ from the 26 layers in "
            f"sequence by up to {diff:.3g}")
    ms = mesh_times(lambda: pipeline_apply(stage, mine, xs, mesh), dev)
    seq = mesh_times(sequential, dev)
    return {"stage": k, "K6": k6, "equal": equal, "ms": ms, "sequential_ms": seq,
            "peak_gib": peak_gib(dev)}


def run_mesh_workers(kind: str, world: int, root: Path, device: str = "cuda",
                     smoke: bool = False) -> list:
    """Start ``world`` ranks of ``mesh_worker`` together and wait for all →
    each rank's readings; fails if any rank exits non-zero or says nothing."""
    port = free_port()
    procs = [subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--mesh-worker",
                               kind, str(r), str(port), str(root), device,
                               "smoke" if smoke else "full"], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=child_env())
             for r in range(world)]
    try:
        outs = [p.communicate(timeout=400) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, (so, se)) in enumerate(zip(procs, outs)):
        require(p.returncode == 0 and "mesh worker ok" in so,
                f"15 {kind} rank {r} exited {p.returncode}: {se[-3000:]}")
    return [json.loads((root / f"{kind}_{r}.json").read_text()) for r in range(world)]


def phase15a_expert_parallel(smi: str, root: Path) -> dict:
    t = time.perf_counter()
    ranks = run_mesh_workers("moe", 4, root)
    for r in ranks:
        c = r["coord"]
        for key in ("moe_fsdp0", "moe_fsdp1"):
            m = r[key]
            log(f"15a deepseek-v2-lite-16b's first MoE layer (64 experts, 32 a model rank), "
                f"{key[4:]}, rank at (data {c[0]}, model {c[1]}), T = {MESH_T} tokens of its data "
                f"shard: max |diff| {m['max_abs']:.4g}, relative L2 {m['rel_l2']:.4g} against the "
                f"local moe_block on the same tokens; kept {m['kept']}, dropped {m['dropped']} "
                f"(token, expert) entries, the same sets; ms expert-parallel {fmt(m['ms'])}, local "
                f"{fmt(m['local_ms'])} (4 processes share one card: the split's cost, not a "
                f"speed-up); card: {smi}")
        m = r["lm"]
        log(f"15a lm_forward(mesh=) of 2 layers, rank at (data {c[0]}, model {c[1]}), one "
            f"sequence of {MESH_T}: K6 x{r['K6']}; logits max |diff| {m['max_abs']:.4g}, relative "
            f"L2 {m['rel_l2']:.4g} against the local forward; ms mesh {fmt(m['ms'])}, local "
            f"{fmt(m['local_ms'])}; peak {m['peak_gib']:.3f} GiB; card: {smi}")
    log(f"15a expert parallelism in 4 processes: {time.perf_counter() - t:.3f} s")
    return {"K6": sum(r["K6"] for r in ranks), "ranks": ranks}


def phase15b_gpipe(smi: str, root: Path) -> dict:
    t = time.perf_counter()
    ranks = run_mesh_workers("pipe", 2, root)
    for r in ranks:
        log(f"15b gemma3-1b as 2 stages of 13 layers, stage {r['stage']}: K6 x{r['K6']}; the last "
            f"stage's outputs of {PIPE_M} microbatches of (1, {MESH_T}, 1152) bit-equal to the 26 "
            f"layers in sequence: {r['equal']}; ms pipeline {fmt(r['ms'])}, sequential "
            f"{fmt(r['sequential_ms'])} (both stages share one card: the bubble and the host "
            f"hand-offs, not a speed-up); peak {r['peak_gib']:.3f} GiB; card: {smi}")
    log(f"15b GPipe in 2 processes: {time.perf_counter() - t:.3f} s")
    return {"K6": sum(r["K6"] for r in ranks)}


def phase15c_part(dev, eng, queries, smi: str) -> dict:
    """The stacked probe over ``part`` lists: the card 2 and 3 times, and
    every visible card where there are several."""
    import torch

    from repro_torch.dist import StackedProbe, probe as probe_mod, use_devices
    from repro_torch.kernels.dominance_scan.ref import dominance_scan_pairs_indexed_ref

    t = time.perf_counter()
    calls = []
    probe_fn = probe_mod.StackedProbe.probe

    def record(self, *a, **kw):
        res = probe_fn(self, *a, **kw)
        calls.append((a, kw, res))
        return res

    probe_mod.StackedProbe.probe = record
    try:
        want = eng.match_many(queries, probe_impl="stacked")
    finally:
        probe_mod.StackedProbe.probe = probe_fn
    sets = [set(m) for m in want]
    one_ms = mesh_times(lambda: eng.match_many(queries, probe_impl="stacked"), dev, runs=1)
    out = {"K1": 0}
    lists_n = [[dev] * 2, [dev] * 3]
    if torch.cuda.device_count() > 1:
        lists_n.append([torch.device("cuda", i) for i in range(torch.cuda.device_count())])
    indexes = [m.index for m in eng.models]
    for devices in lists_n:
        n = len(devices)
        # a probe laid out over n shards, on the probe calls of the batch above
        many = StackedProbe(indexes, leaf_pair_cap=eng.cfg.stacked_leaf_pair_cap,
                            devices=devices)
        for a, kw, res in calls:
            require(kw.get("live_mask") is None, "15c: a fresh engine has no tombstones")
            got = many.probe(*a, **kw)
            got = got[0] if kw.get("return_stats") else got
            res = res[0] if kw.get("return_stats") else res
            require(all(torch.equal(x, y) for pw, pg in zip(res, got) for x, y in zip(pw, pg)),
                    f"15c: the probe over {n} devices differs from one device's")
        # the engine's own probe over the list: lists in order, the hand-off's sets
        reset_counters()
        with use_devices("part", devices):
            seen = recorded_verdicts(lambda: eng.match_many(queries, probe_impl="stacked"))
            k1 = counters()["K1"]
            got = eng.match_many(queries, probe_impl="stacked")
            handoff = eng.match_many(queries, probe_impl="stacked", join_impl="device")
            require(eng.stacked_probe().stacked.n_shards == n, "15c: the engine's probe did "
                    f"not split over {n} devices")
            ms = mesh_times(lambda: eng.match_many(queries, probe_impl="stacked"), dev, runs=1)
        require(got == want, f"15c: the stacked probe's lists over {n} devices differ from one "
                f"device's")
        require([set(m) for m in handoff] == sets, f"15c: the hand-off over {n} devices gives "
                f"other sets")
        require(k1 > 0 and len(seen) > 0, f"15c: K1 did not launch over {n} devices")
        for (segs, eps), keep in seen:
            require(torch.equal(keep, dominance_scan_pairs_indexed_ref(segs, eps)),
                    "15c: K1 on the real pairs differs from the plain version")
        out["K1"] += k1
        log(f"15c the stacked probe over a part list of {n} ({', '.join(map(str, devices))}): "
            f"{len(calls)} recorded probe calls and the engine's lists equal one device's in "
            f"order, the hand-off's sets equal; K1 x{k1}, {len(seen)} verdicts equal to plain; "
            f"warm host join ms {fmt(ms)} against one device's {fmt(one_ms)} (one card listed "
            f"{n} times: the split's cost, not a speed-up); card: {smi}")
    if torch.cuda.device_count() == 1:
        log("15c one visible card: the every-card list is the one-device probe")
    eng.stacked_probe()  # placed back on the default list
    log(f"15c the part lists: {time.perf_counter() - t:.3f} s")
    return out


def phase15d_join(dev, eng, queries, smi: str) -> dict:
    """The device join over ``join`` lists of 2 and 3 entries."""
    import torch

    from repro_torch.dist import use_devices

    t = time.perf_counter()
    out = {"K2": 0}
    for what, batch in (("16 queries", queries), ("3 isomorphic queries",
                                                  iso_batch(eng.graph, 8, 3, seed=15))):
        eng.match_many(batch, join_impl="device")  # warms the pair-bucket guesses
        steps1 = k2_steps(eng, batch)
        want = eng.match_many(batch, join_impl="device")
        one_ms = mesh_times(lambda: eng.match_many(batch, join_impl="device"), dev, runs=1)
        for n in (2, 3):
            with use_devices("join", [dev] * n):
                reset_counters()
                steps = k2_steps(eng, batch)
                k2 = counters()["K2"]
                got = eng.match_many(batch, join_impl="device")
                ms = mesh_times(lambda: eng.match_many(batch, join_impl="device"), dev, runs=1)
            require(got == want, f"15d {what}: the device join over {n} devices differs from "
                    f"one device's")
            require(len(steps) == n * len(steps1) == k2,
                    f"15d {what}: {len(steps)} K2 verdicts over {n} devices against "
                    f"{len(steps1)} on one")
            out["K2"] += k2
            log(f"15d the device join over a join list of {n}, {what}: lists equal one "
                f"device's ({sum(map(len, got))} matches); K2 x{k2} ({len(steps1)} a shard, each "
                f"equal to plain); warm ms {fmt(ms)} against one device's {fmt(one_ms)} (the "
                f"split's cost on one card); card: {smi}")
    log(f"15d the join lists: {time.perf_counter() - t:.3f} s")
    return out


def phase15_lists(dev, smi: str, ctx: dict | None = None) -> dict:
    """The stacked probe and the device join over in-process device lists
    (15c, 15d) on the 50K cell: phase 3's engine from ``ctx``, handed over
    before any update touches it, else (``--only 15``) the cell built afresh."""
    import torch

    from repro_torch.core import GnnPeEngine

    log(f"phase 15c-d: {torch.cuda.device_count()} visible card(s); card: {smi}")
    if ctx is None:
        t = time.perf_counter()
        g, queries, cfg = cell_50k_inputs()
        eng = GnnPeEngine(cfg).build(g)
        log(f"15 the 50K cell's engine built in {time.perf_counter() - t:.3f} s")
    else:
        eng, queries = ctx["eng"], ctx["queries"]
    out = {"c": phase15c_part(dev, eng, queries, smi), "d": phase15d_join(dev, eng, queries, smi)}
    out["K1"], out["K2"] = out["c"]["K1"], out["d"]["K2"]
    return out


def phase15_meshes(smi: str) -> dict:
    """Expert parallelism and GPipe over processes sharing the card (gloo):
    15a and 15b."""
    import tempfile

    import torch

    log(f"phase 15a-b: {torch.cuda.device_count()} visible card(s); card: {smi}")
    out: dict = {}
    with tempfile.TemporaryDirectory() as d:
        out["a"] = phase15a_expert_parallel(smi, Path(d))
        out["b"] = phase15b_gpipe(smi, Path(d))
    out["K6"] = out["a"]["K6"] + out["b"]["K6"]
    return out


# 16a's production cells (arch, shape, mesh kind) and 16b's (the same cell on a (1, 1) mesh)
DRYRUN_CELLS = [("gemma3-1b", "train_4k", "single"), ("qwen3-moe-235b-a22b", "train_4k", "multi"),
                ("dcn-v2", "serve_bulk", "single"), ("gin-tu", "full_graph_sm", "single"),
                ("graphsage-reddit", "minibatch_lg", "single"),
                ("command-r-plus-104b", "train_4k", "multi"), ("mace", "ogb_products", "single"),
                ("mace", "ogb_products", "multi")]
# 16a's cells cut for time (REPRO_OVERRIDES): command-r's 64 layers trace in minutes, 2 in seconds
DRYRUN_CUT = {("command-r-plus-104b", "train_4k", "multi"): "n_layers=2"}
# 16a's scaling bound: a cell's collective bytes a device on (2, 16, 16) at most its own on
# (16, 16) × max(1.05, the JAX package's multi/single ratio) + 64 MB; the ratio from the JAX
# package's dry-run of mace ogb_products (12.623 / 20.540 GB a device)
DRYRUN_SCALING = {("mace", "ogb_products"): 12.623 / 20.540}
# the JAX package's memory figure a device (argument + output - alias + temp) for each 16a
# cell it lowers, from its dry-run on the CPU (`python -m repro.launch.dryrun`, 512 host
# devices); dcn-v2's raises on its own `tables` spec.  A cell whose figure fits the card
# must fit it in the port too.
REF_MEMORY_GB = {("gemma3-1b", "train_4k", "single"): 14.224,
                 ("qwen3-moe-235b-a22b", "train_4k", "multi"): 30.158,
                 ("dcn-v2", "serve_bulk", "single"): None,
                 ("gin-tu", "full_graph_sm", "single"): 0.004,
                 ("graphsage-reddit", "minibatch_lg", "single"): 0.053,
                 ("command-r-plus-104b", "train_4k", "multi"): 20.471,  # at 2 layers
                 ("mace", "ogb_products", "single"): 153.685,
                 ("mace", "ogb_products", "multi"): 76.923}
PREFILL_B = 2  # phase 7's prefill_32k batch, 16b's
HBM_BYTES = 80e9  # an H100's memory


def dryrun_worker(out: str) -> int:
    """16a's child (``chip_smoke.py --dryrun-worker OUT``): the dry-run of
    ``DRYRUN_CELLS`` and of gemma3-1b ``prefill_32k`` at B = 2 on a (1, 1)
    mesh, CPU-only (no card visible, so no second CUDA context shares the
    card; its meshes are still of the card's type, as the dry-run's are on
    any host), on one host thread pinned to one core at a
    lower priority: it runs beside phases 2 to 15, whose host-bound phases it
    must not slow → OUT, the records."""
    import os

    import torch

    os.sched_setaffinity(0, {max(os.sched_getaffinity(0))})
    os.nice(10)
    torch.set_num_threads(1)
    from repro_torch.launch.dryrun import run_cell

    recs = []
    for a, s, m in DRYRUN_CELLS:
        cut = DRYRUN_CUT.get((a, s, m))
        if cut:
            os.environ["REPRO_OVERRIDES"] = cut
        recs.append({**run_cell(a, s, m, None), "overrides": cut})
        os.environ.pop("REPRO_OVERRIDES", None)
    recs.append(run_cell("gemma3-1b", "prefill_32k", "single", None,
                         mesh_shape=((1, 1), ("data", "model")), batch=PREFILL_B))
    Path(out).write_text(json.dumps(recs))
    return 0


def start_dryrun(root: Path) -> dict:
    """16a's child, started at the top of the script → {"proc", "out", "err", "t"}."""
    import os

    import atexit

    out, err = root / "dryrun.json", root / "dryrun.err"
    env = {**child_env(), "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1",
           "CUDA_VISIBLE_DEVICES": ""}
    with open(err, "w") as fe:
        proc = subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--dryrun-worker",
                                 str(out)], stdout=subprocess.DEVNULL, stderr=fe, env=env,
                                cwd=os.getcwd())

    def stop():  # a failed phase leaves no child behind
        if proc.poll() is None:
            proc.kill()
            proc.wait()

    atexit.register(stop)
    return {"proc": proc, "out": out, "err": err}


def phase16a_dryrun(child: dict, smi: str, timeout: float) -> list:
    """Collect 16a's child: every cell ``ok``; per-device flops, bytes,
    collective bytes by kind and peak beside the card's 80 GB."""
    p = child["proc"]
    try:
        rc = p.wait(timeout=max(timeout, 1.0))
    except subprocess.TimeoutExpired:
        p.kill()
        p.wait()
        raise AssertionError(f"16a: the dry-run child did not end within {timeout:.0f} s more")
    require(rc == 0 and child["out"].exists(),
            f"16a: the dry-run child exited {rc}: {child['err'].read_text()[-3000:]}")
    recs = json.loads(child["out"].read_text())
    for rec in recs:
        what = (f"{rec['arch']} {rec['shape']} on the {rec['mesh']} mesh"
                + (f" ({rec['overrides']})" if rec.get("overrides") else ""))
        require(rec["status"] == "ok", f"16a {what}: {rec['status']}: {rec.get('error')}\n"
                f"{rec.get('traceback', '')}")
        require(rec["mesh_device"] == "cuda",
                f"16a {what}: a {rec['mesh_device']} mesh plans gloo's collectives, not NCCL's")
        peak = rec["memory"]["peak_memory_in_bytes"]
        key = (rec["arch"], rec["shape"], rec["mesh"])
        ref = REF_MEMORY_GB.get(key)
        ref_txt = ("" if key not in REF_MEMORY_GB else " (the JAX package's plan raises)"
                   if ref is None else f" (the JAX package's plan {ref:.3f} GB)")
        if ref is not None and ref * 1e9 <= HBM_BYTES or key in DRYRUN_CUT:
            require(peak <= HBM_BYTES, f"16a {what}: a peak of {peak / 1e9:.3f} GB a device does "
                    f"not fit the card's {HBM_BYTES / 1e9:.0f} GB; the JAX package's plan takes "
                    f"{ref:.3f} GB")
        coll = ", ".join(f"{k} {v / 1e9:.3f} GB" for k, v in sorted(rec["collective_bytes"].items()))
        log(f"16a dry-run {what} ({rec['n_devices']} ranks, {rec['mesh_device']} mesh): per device "
            f"{rec['flops']:.6e} flops, {rec['bytes']:.6e} bytes ({rec['bytes_fused']:.6e} fused), "
            f"collectives {coll or 'none'} ({rec['collective_count']}), peak "
            f"{peak / 1e9:.3f} GB of {HBM_BYTES / 1e9:.0f} GB"
            f"{'' if peak <= HBM_BYTES else ' (does not fit)'}{ref_txt}, args "
            f"{rec['memory']['argument_size_in_bytes'] / 1e9:.3f} GB; {rec['n_ops']} ops; "
            f"traced in {rec['trace_s']} s; card: {smi}")
    by = {(r["arch"], r["shape"], r["mesh"]): r for r in recs}
    for (arch, shape), ratio in DRYRUN_SCALING.items():
        one, pod = (by[(arch, shape, m)]["collective_bytes_total"] for m in ("single", "multi"))
        bound = one * max(1.05, ratio) + 64e6
        require(pod <= bound, f"16a {arch} {shape}: {pod / 1e9:.3f} GB of collectives a device on "
                f"(2, 16, 16), past {bound / 1e9:.3f} GB (its {one / 1e9:.3f} GB on (16, 16) × "
                f"max(1.05, the JAX package's {ratio:.3f}) + 64 MB)")
        log(f"16a {arch} {shape}: collectives a device {one / 1e9:.3f} GB on (16, 16), "
            f"{pod / 1e9:.3f} GB on (2, 16, 16) ({pod / one:.3f}×, the JAX package's "
            f"{ratio:.3f}×), within {bound / 1e9:.3f} GB; counts "
            f"{by[(arch, shape, 'single')]['collective_count']} and "
            f"{by[(arch, shape, 'multi')]['collective_count']}")
    log(f"16a the dry-run child's cells traced in {sum(r['trace_s'] for r in recs):.2f} s in all, "
        f"beside phases 2 to 15")
    return recs


def example_child(args: list, root: Path, name: str) -> dict:
    """One of 16c's examples in a child process → {"proc", "out", "err"}."""
    out, err = root / f"{name}.out", root / f"{name}.err"
    with open(out, "w") as fo, open(err, "w") as fe:
        proc = subprocess.Popen([sys.executable, str(ROOT / "examples" / args[0]), *args[1:]],
                                stdout=fo, stderr=fe, env=child_env())
    return {"proc": proc, "out": out, "err": err, "name": name}


def phase16b_counted_step(dev) -> dict:
    """gemma3-1b ``prefill_32k`` at B = 2 on the card: one warm step under
    ``op_cost`` (K6 26 times), a separate uncounted step timed by CUDA
    events → {"flops", "bytes", "K6", "ms"}."""
    import torch

    from repro_torch.configs import build_step, get_arch, init_params, make_batch, resolve_config
    from repro_torch.launch.op_cost import analyze_step

    arch = get_arch("gemma3-1b")
    cell = arch.cell("prefill_32k")
    cfg = resolve_config(arch, cell, smoke=False)
    params = init_params(arch, cfg, seed=0, device=dev)
    batch = {"tokens": make_batch(arch, cell, cfg, seed=1, smoke=False,
                                  device=dev)["tokens"][:PREFILL_B]}
    step, _ = build_step(arch, cell, cfg)
    with torch.no_grad():
        step(params, batch)  # warm
        sync(dev)
        reset_counters()  # the counted step's launches, from here
        cost = analyze_step(step, params, batch, real=True)
        sync(dev)
        k6 = counters()["K6"]
        torch.cuda._sleep(SPIN_CYCLES)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        step(params, batch)
        end.record()
        end.synchronize()
    del params
    torch.cuda.empty_cache()
    return {"flops": cost["flops"], "bytes": cost["bytes"], "K6": k6,
            "ms": start.elapsed_time(end), "n_ops": cost["n_ops"]}


def phase16_mesh_tools(dev, smi: str, child: dict, root: Path) -> dict:
    """Phase 16: 16b the counted step beside 16c's examples in children, then
    16c's results, then 16a's dry-run child."""
    t = time.perf_counter()
    kids = [example_child(["quickstart_torch.py"], root, "quickstart"),
            example_child(["chaos_crash_torch.py", "--kill-epoch", "3"], root, "chaos")]
    try:
        b = phase16b_counted_step(dev)
        log(f"16b gemma3-1b prefill_32k at B = {PREFILL_B}, one warm step counted on the card: "
            f"{b['flops']:.6e} flops, {b['bytes']:.6e} bytes, {b['n_ops']} ops, K6 x{b['K6']}; "
            f"an uncounted step {b['ms']:.3f} ms by CUDA events; {time.perf_counter() - t:.3f} s; "
            f"card: {smi}")
        require(b["K6"] == 26, f"16b: K6 launched {b['K6']} times in the counted step, not 26")
        outs = {}
        for k in kids:
            rc = k["proc"].wait(timeout=600)
            outs[k["name"]] = k["out"].read_text()
            require(rc == 0, f"16c {k['name']}: exit {rc}: {k['err'].read_text()[-3000:]}")
    finally:
        for k in kids:
            if k["proc"].poll() is None:
                k["proc"].kill()
                k["proc"].wait()
    agree = outs["quickstart"].count("(oracle agrees)")
    require(agree == 3, f"16c quickstart_torch.py: {agree} of 3 queries equal VF2's")
    finals = [ln for ln in outs["chaos"].splitlines() if ln.startswith("[wal] final ")]
    require("[chaos] ok: recovered replica identical to control" in outs["chaos"]
            and len(finals) == 2 and finals[0] == finals[1],
            f"16c chaos_crash_torch.py: final lines {finals}")
    log(f"16c quickstart_torch.py on the card: 3 queries' sets equal VF2's; chaos_crash_torch.py "
        f"--kill-epoch 3: {finals[1]} after the SIGKILL and restart, equal to the control's; "
        f"{time.perf_counter() - t:.3f} s; card: {smi}")

    recs = phase16a_dryrun(child, smi, timeout=max(60.0, 1100.0 - (time.perf_counter() - T0)))
    one = recs[-1]
    require(one["flops"] == b["flops"] and one["bytes"] == b["bytes"],
            f"16b: the counted step's flops {b['flops']!r} and bytes {b['bytes']!r} differ from "
            f"the dry-run's on a (1, 1) mesh, {one['flops']!r} and {one['bytes']!r}")
    c_ms = b["flops"] / BF16_OPS_PER_S * 1e3
    m_ms = b["bytes"] / HBM_BYTES_PER_S * 1e3
    share = max(c_ms, m_ms) / b["ms"]
    log(f"16b the roofline of that step: {c_ms:.3f} ms of flops at 989 TFLOP/s, {m_ms:.3f} ms of "
        f"bytes at 3.35 TB/s, against {b['ms']:.3f} ms: {share:.1%} of the roofline "
        f"({'compute' if c_ms >= m_ms else 'memory'} bound); flops and bytes equal the dry-run's "
        f"on a (1, 1) mesh; card: {smi}")
    require(share <= 1.0, f"16b: the step ran at {share:.1%} of its roofline: the count is wrong")
    log(f"phase 16 the mesh tools: {time.perf_counter() - t:.3f} s; card: {smi}")
    return {"K6": b["K6"], "share": share}


def load_port(src: Path, name: str):
    """The port's package at ``src/repro_torch`` imported under ``name`` (its
    imports are all relative, so a second checkout's, a parent commit's,
    loads beside this one's, with its own kernels built from its own
    sources).  Two checkouts that register the same custom ops cannot load
    together."""
    import importlib
    import importlib.util

    pkg = src / "repro_torch"
    spec = importlib.util.spec_from_file_location(name, pkg / "__init__.py",
                                                  submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return {m: importlib.import_module(f"{name}.{m}") for m in (
        "configs", "kernels.build", "kernels.star_agg.ops", "kernels.cross_interact.ops",
        "kernels.flash_attention.ops")}


def host_ab(parent: Path, rounds: int = 12) -> int:
    """``chip_smoke.py --host-ab DIR [ROUNDS]``: the serving paths' host time,
    this tree's port against the one in ``DIR/src`` (a parent commit unpacked
    by ``git archive``), both loaded in this one process and read in turns
    on one card (parent, this, this, parent, ...; ``ROUNDS`` of each, then as
    many beside phase 16a's dry-run child).  Each turn reads, on the host
    clock to a ``synchronize``: dcn-v2 ``serve_p99``'s warm step (B = 512: K4
    once, K5 three times; median of 21), gemma3-1b ``decode_32k``'s at
    B = 64 (phase 7's; median of 5), and the mean host ms to enqueue K4 and
    K5 at ``serve_p99``'s shapes and K6 at B = 1, S = 4,096, Hq = 8,
    dh = 256.  Both trees step on the same params and batches.  This tree's
    K4 is also read through its custom op, which the wrapper skips on a
    plain card tensor.  Prints one JSON line of each reading's median,
    quartiles, min and max over the turns, and the pairs (turn i of each
    side) in which this tree read below the parent, with the card's name and
    power limit; not part of the full run."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    import tempfile

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    ports = {"parent": load_port(parent.resolve() / "src", "repro_torch_parent"),
             "this": load_port(ROOT / "src", "repro_torch")}
    for port in ports.values():
        port["kernels.build"].build_all()
    dev = torch.device("cuda")
    cfgs = ports["this"]["configs"]

    def setup(arch_name: str, cell_name: str):
        arch = cfgs.get_arch(arch_name)
        cell = arch.cell(cell_name)
        cfg = cfgs.resolve_config(arch, cell, smoke=False)
        return arch, cell, cfg, cfgs.init_params(arch, cfg, seed=0, device=dev)

    with torch.no_grad():
        d_arch, d_cell, d_cfg, d_params = setup("dcn-v2", "serve_p99")
        d_batch = cfgs.make_batch(d_arch, d_cell, d_cfg, seed=1, smoke=False, device=dev)
        g_arch, g_cell, g_cfg, g_params = setup("gemma3-1b", "decode_32k")
        g_batch = decode_batch_on(dev, g_arch, g_cfg, 64, "decode_32k", 2)
        seen: dict = {}
        sa, ci = ports["this"]["kernels.star_agg.ops"], ports["this"]["kernels.cross_interact.ops"]
        sa_fn, ci_fn = sa.star_agg, ci.cross_interact
        sa.star_agg = lambda *a: seen.setdefault("K4", a) and sa_fn(*a)
        ci.cross_interact = lambda *a: seen.setdefault("K5", a) and ci_fn(*a)
        try:
            ports["this"]["configs"].build_step(d_arch, d_cell, d_cfg)[0](d_params, d_batch)
        finally:
            sa.star_agg, ci.cross_interact = sa_fn, ci_fn
        q = torch.randn(1, 4096, 8, 256, dtype=torch.bfloat16, device=dev)
        k = torch.randn(1, 4096, 1, 256, dtype=torch.bfloat16, device=dev)
        steps = {}
        for name, port in ports.items():
            c = port["configs"]
            serve = c.build_step(c.get_arch("dcn-v2"), d_cell, d_cfg)[0]
            decode = c.build_step(c.get_arch("gemma3-1b"), g_cell, g_cfg)[0]
            steps[name] = {
                "serve_p99_ms": (lambda f=serve: f(d_params, d_batch), 21),
                "decode_32k_ms": (lambda f=decode: f(g_params, g_batch), 5),
                "K4_host_ms": (lambda m=port["kernels.star_agg.ops"]: host_ms(
                    m.star_agg, seen["K4"], reps=20), 1),
                "K5_host_ms": (lambda m=port["kernels.cross_interact.ops"]: host_ms(
                    m.cross_interact, seen["K5"], reps=20), 1),
                "K6_host_ms": (lambda m=port["kernels.flash_attention.ops"]: host_ms(
                    m.flash_attention, (q, k, k), reps=20), 1),
            }
            for fn, _ in steps[name].values():
                fn()  # warm
        steps["this"]["K4_op_host_ms"] = (lambda: host_ms(
            torch.ops.repro_torch.star_agg, seen["K4"], reps=20), 1)

        def turn(name: str, sink: dict) -> None:
            for key, (fn, reps) in steps[name].items():
                if reps == 1:
                    val = fn()
                else:
                    walls = []
                    for _ in range(reps):
                        sync(dev)
                        t = time.perf_counter()
                        fn()
                        sync(dev)
                        walls.append((time.perf_counter() - t) * 1e3)
                    val = float(np.median(walls))
                sink.setdefault(f"{name} {key}", []).append(val)

        order = ["parent", "this", "this", "parent"]
        alone: dict = {}
        for i in range(2 * rounds):
            turn(order[i % 4], alone)
        beside: dict = {}
        with tempfile.TemporaryDirectory() as tmp:
            child = start_dryrun(Path(tmp))
            try:
                time.sleep(10.0)  # the child past its imports, into its cells
                for i in range(2 * rounds):
                    turn(order[i % 4], beside)
                ran = child["proc"].poll() is None
            finally:
                if child["proc"].poll() is None:
                    child["proc"].kill()
                child["proc"].wait()
        require(ran, "--host-ab: the dry-run child ended before the turns beside it did")

    def summary(res: dict) -> dict:
        out = {}
        for k, v in sorted(res.items()):
            q1, med, q3 = (float(x) for x in np.percentile(v, [25, 50, 75]))
            out[k] = {"median": med, "q1": q1, "q3": q3, "min": min(v), "max": max(v), "n": len(v)}
            side, key = k.split(" ", 1)
            if side == "this" and f"parent {key}" in res:  # turn i of each side: one pair
                out[k]["below_parent"] = sum(a < b for a, b in zip(v, res[f"parent {key}"]))
        return out

    print(json.dumps({"card": smi, "parent": str(parent), "alone": summary(alone),
                      "beside_16a_child": summary(beside)}), flush=True)
    return 0


def main(only: str | None = None) -> int:
    """Every phase, or with ``only="8"``, ``"12"``, ``"13"``, ``"14"``, ``"15"`` or
    ``"16"`` the build and that phase alone (a partial run: it prints no result line)."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1

    import tempfile

    from repro_torch.kernels import build as kbuild

    global T0
    T0 = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()
    root16 = Path(tmp.name)
    if only in (None, "16"):
        dry = start_dryrun(root16)  # 16a, beside every phase until phase 16 collects it
    dev = torch.device("cuda")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)  # > the 50 MB L2

    # ---- phase 1: build --------------------------------------------------
    t = time.perf_counter()
    libs = kbuild.build_all()
    for stem, path in libs.items():
        log(f"built {stem}: {path.relative_to(ROOT)}")
        for line in kbuild.BUILD_LOG.get(stem, "").splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  ptxas {line.strip()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"card: {smi}")
    log(f"phase 1 build kernels: {time.perf_counter() - t:.3f} s")
    if only == "8":
        t = time.perf_counter()
        phase8a_updates(dev)
        log(f"phase 8a and 8d: {time.perf_counter() - t:.3f} s; partial run (--only 8): "
            f"no result line")
        return 0
    if only == "12":
        t = time.perf_counter()
        p12 = phase12_training(dev, smi)
        log(f"phase 12 training: {time.perf_counter() - t:.3f} s; train launches K4 {p12['K4']}, "
            f"K5 {p12['K5']}, K6 {p12['K6']}; partial run (--only 12): no result line")
        return 0
    if only == "13":
        t = time.perf_counter()
        log(f"K6 edge shapes, max |err| {k6_edge_checks(dev):.3g}")
        p13 = phase13_lm_family(dev, flush, smi)
        log(f"phase 13 the LM family: {time.perf_counter() - t:.3f} s; prefill launches K6 "
            f"{p13['K6']}; partial run (--only 13): no result line")
        return 0
    if only == "14":
        t = time.perf_counter()
        phase14_gnn(dev, smi)
        log(f"phase 14 the GNN zoo and GNN-PE's cells: {time.perf_counter() - t:.3f} s; partial "
            f"run (--only 14): no result line")
        return 0
    if only == "16":
        try:
            phase16_mesh_tools(dev, smi, dry, root16)
        finally:
            if dry["proc"].poll() is None:
                dry["proc"].kill()
                dry["proc"].wait()
            tmp.cleanup()
        log("partial run (--only 16): no result line")
        return 0
    if only == "15":
        t = time.perf_counter()
        p15 = {**phase15_meshes(smi), **phase15_lists(dev, smi)}
        log(f"phase 15 the meshes: {time.perf_counter() - t:.3f} s; launches K1 {p15['K1']}, K2 "
            f"{p15['K2']}, K6 {p15['K6']}; partial run (--only 15): no result line")
        return 0

    t = time.perf_counter()
    errs = phase2_kernels(dev)
    log(f"phase 2 kernels vs plain versions: {time.perf_counter() - t:.3f} s")

    t = time.perf_counter()
    p3 = phase3_main_path(dev, flush)
    log(f"phase 3 main path, 50K vertices / 80 partitions: {time.perf_counter() - t:.3f} s")

    t = time.perf_counter()
    p3q = phase3q_quantized_dr(dev, p3["ctx"])
    log(f"phase 3q the 50K cell with the int8 sidecar and dr plans: {time.perf_counter() - t:.3f} s")
    log(f"K2 launches: phase 3 device join {p3['K2']}, phase 3 stacked probe's hand-off "
        f"{p3['K2_stacked']}, phase 3q device joins {p3q['K2']}")

    t = time.perf_counter()
    p3g = phase3g_grouped(dev, flush, p3["ctx"])
    log(f"phase 3g the 50K cell with the grouped index: {time.perf_counter() - t:.3f} s")

    t = time.perf_counter()
    p15l = phase15_lists(dev, smi, p3["ctx"])
    log(f"phase 15c-d the part and join device lists on phase 3's engine: "
        f"{time.perf_counter() - t:.3f} s; launches K1 {p15l['K1']}, K2 {p15l['K2']}; card: {smi}")

    t = time.perf_counter()
    gat_eng, gat_queries = phase4_gat(dev)
    log(f"phase 4 gat, 2K vertices / 2 partitions: {time.perf_counter() - t:.3f} s")

    t = time.perf_counter()
    p5 = phase5_join_heavy(dev, flush)
    log(f"phase 5 join-heavy batch, 12K vertices / 8 isomorphic queries: "
        f"{time.perf_counter() - t:.3f} s")

    t = time.perf_counter()
    p6 = phase6_dcn_serving(dev, flush)
    errs["K4"], errs["K5"] = p6["K4_err"], p6["K5_err"]
    log(f"phase 6 dcn-v2 serving, serve_p99 / serve_bulk / retrieval_cand: "
        f"{time.perf_counter() - t:.3f} s")

    t = time.perf_counter()
    p7 = phase7_lm_serving(dev, flush)
    errs["K6"] = p7["K6_err"]
    log(f"phase 7 gemma3-1b serving, prefill_32k / decode_32k / long_500k / DecodeEngine: "
        f"{time.perf_counter() - t:.3f} s")

    t = time.perf_counter()
    p8 = phase8a_updates(dev)
    log(f"phase 8a the 50K cell under 8 update epochs: {time.perf_counter() - t:.3f} s")
    t = time.perf_counter()
    phase8b_bench_updates(dev)
    log(f"phase 8b the bench_updates cell, 10K vertices / 40 partitions: "
        f"{time.perf_counter() - t:.3f} s")
    t = time.perf_counter()
    phase8c_gat_bits(dev, gat_eng, gat_queries)
    log(f"phase 8c GAT bits after an update: {time.perf_counter() - t:.3f} s")

    t = time.perf_counter()
    p9 = phase9_serving(dev, p3["ctx"], p3g.pop("eng"))
    log(f"phase 9 the serving tier on the 50K cell (obs, MatchServer, standing queries, "
        f"MatchService): {time.perf_counter() - t:.3f} s; card: {smi}")

    t = time.perf_counter()
    p10 = phase10_cluster(dev, p3["ctx"], smi)
    log(f"phase 10 the cluster tier (50K cell through ClusterEngine, sharded cache, blue-green, "
        f"ClusterRouter, two processes): {time.perf_counter() - t:.3f} s; card: {smi}")

    t = time.perf_counter()
    p11 = phase11_durability(dev, p3["ctx"], smi)
    log(f"phase 11 durability (the durable 50K cell, the crash sweep, a real SIGKILL, scrub): "
        f"{time.perf_counter() - t:.3f} s; card: {smi}")

    t = time.perf_counter()
    p12 = phase12_training(dev, smi)
    log(f"phase 12 training (dcn-v2 train_batch, gemma3-1b train_4k, the Trainer): "
        f"{time.perf_counter() - t:.3f} s; train launches K4 {p12['K4']}, K5 {p12['K5']}, "
        f"K6 {p12['K6']}; card: {smi}")

    t = time.perf_counter()
    p13 = phase13_lm_family(dev, flush, smi)
    errs["K6"] = max(errs["K6"], p13["K6_err"])
    log(f"phase 13 the LM family (minitron-4b, command-r-plus-104b, deepseek-v2-lite-16b, "
        f"qwen3-moe-235b-a22b): {time.perf_counter() - t:.3f} s; prefill launches K6 {p13['K6']}; "
        f"card: {smi}")

    t = time.perf_counter()
    phase14_gnn(dev, smi)
    log(f"phase 14 the GNN zoo (gin-tu, graphsage-reddit, schnet, mace on every cell, the "
        f"partition-parallel loss) and GNN-PE's offline and online cells: "
        f"{time.perf_counter() - t:.3f} s; no kernel lies on this path; card: {smi}")

    t = time.perf_counter()
    p15 = phase15_meshes(smi)
    log(f"phase 15a-b the meshes (expert parallelism and GPipe over processes): "
        f"{time.perf_counter() - t:.3f} s; launches K6 {p15['K6']} (in their processes); "
        f"card: {smi}")

    try:
        p16 = phase16_mesh_tools(dev, smi, dry, root16)
    finally:
        if dry["proc"].poll() is None:
            dry["proc"].kill()
            dry["proc"].wait()
        tmp.cleanup()

    def record(name, kid, source, replaces, launches, ms, plain_ms, bound, library_ms=None):
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": errs[kid], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound[0], "bound_by": bound[1],
            # None where no single PyTorch call computes the function
            "library_ms": library_ms,
        }

    scan_cu = f"{SRC}/dominance_scan/csrc/dominance_scan.cu"
    scan_py = "src/repro/kernels/dominance_scan/kernel.py"
    k1f, k1g = p3["K1_forms"], p3g["K1g"]
    log("K1 forms (ms by events / by the profiler, bound, beside): "
        + "; ".join(f"{name} {v[0]:.6f} / {fmt_ms(v[1])}, bound {v[2]:.6f}, beside {v[3]:.6f}"
                    for name, v in k1f.items())
        + f"; indexed groups {k1g['ms']:.6f} / {fmt_ms(k1g['prof_ms'])}, bound "
        f"{k1g['bound'][0]:.6f}, beside {k1g['route_ms']:.6f}; packed groups "
        f"{k1g['packed_ms']:.6f} / {fmt_ms(k1g['packed_prof_ms'])}, bound "
        f"{k1g['packed_bound'][0]:.6f}, beside {k1g['packed_plain_ms']:.6f} (beside: the route "
        f"an indexed form replaced, the plain version of a packed one); card: {smi}")
    records = [
        # K1's launches (all four forms; the main path runs the indexed pairs and
        # groups verdicts): the loop and stacked probes' cold batches of phase 3 and
        # its hand-off, phase 3q's and phase 3g's batches, phase 8a's (main probe and
        # delta-buffer scan), phase 9's (traced batches, server ticks, subscription
        # ticks, service ticks) and phase 10's (single-process and cluster batches,
        # host probes, router ticks; the worker process's own are not counted) and
        # phase 11's (the durable server's ticks, the recovered engines' batches, the
        # crash sweep's checks; its child processes' own are not counted) and phase
        # 15c's (the engine's stacked probe over part lists of 2 and 3), each
        # counted from 0 just before it; its times on phase 3's real call as it ran,
        # the indexed pairs form (the other forms' are in the log)
        record("dominance_scan_pairs_indexed", "K1", scan_cu, f"{scan_py}:98",
               p3["K1"] + p3["K1_stacked"] + p3["K1_handoff"] + p3q["K1"] + p3g["K1"] + p8["K1"]
               + p9["K1"] + p10["K1"] + p11["K1"] + p15l["K1"],
               p3["K1_ms"], p3["K1_plain_ms"], p3["K1_bound"]),
        # K2's launches: phase 3's device joins (loop, then the stacked probe's
        # hand-off), phase 3q's, phase 3g's, phase 8a's, phase 9a's and phase
        # 10a's device joins, phase 5's batches (loop, then the hand-off) and
        # phase 15d's device joins over join lists of 2 and 3, each counted from 0
        # just before it
        record("injectivity_mask", "K2", f"{SRC}/merge_join/csrc/injectivity_mask.cu",
               "src/repro/kernels/merge_join/kernel.py:47",
               p3["K2"] + p3["K2_stacked"] + p3q["K2"] + p3g["K2"] + p5["K2"] + p5["K2_stacked"]
               + p8["K2"] + p9["K2"] + p10["K2"] + p15l["K2"],
               p5["K2_ms"], p5["K2_plain_ms"], p5["K2_bound"]),
        record("dominance_scan", "K3-single", scan_cu, f"{scan_py}:129", p3["K3-single"],
               p3["K3s_ms"], p3["K3s_plain_ms"], p3["K3s_bound"]),
        record("dominance_scan_batch", "K3-batch", scan_cu, f"{scan_py}:58", p3["K3-batch"],
               p3["K3b_ms"], p3["K3b_plain_ms"], p3["K3b_bound"]),
        # K4, K5 and K6's launches: phase 6's / 7's serving paths, then phase 12's
        # train steps (12a's first DCN-v2 step, 12b's first gemma3-1b step), then
        # (K6) phase 13's four prefill_32k forwards, phase 15's mesh paths (15a's
        # lm_forward(mesh=) and 15b's pipeline, counted from 0 in each worker process
        # just before it and summed here) and phase 16b's counted prefill step, each
        # counted from 0 just before it
        record("star_agg", "K4", f"{SRC}/star_agg/csrc/star_agg.cu",
               "src/repro/kernels/star_agg/kernel.py:39", p6["K4"] + p12["K4"], p6["K4_ms"],
               p6["K4_plain_ms"], p6["K4_bound"], p6["K4_library_ms"]),
        # library_ms of K5 is torch.addmm: the GEMM and bias only, not the fused layer
        record("cross_interact", "K5", f"{SRC}/cross_interact/csrc/cross_interact.cu",
               "src/repro/kernels/cross_interact/kernel.py:28", p6["K5"] + p12["K5"], p6["K5_ms"],
               p6["K5_plain_ms"], p6["K5_bound"], p6["K5_library_ms"]),
        # K6 at a global layer of prefill_32k; its local-layer times are in the log
        record("flash_attention", "K6", f"{SRC}/flash_attention/csrc/flash_attention.cu",
               "src/repro/kernels/flash_attention/kernel.py:69",
               p7["K6"] + p12["K6"] + p13["K6"] + p15["K6"] + p16["K6"],
               p7["K6_ms"], p7["K6_plain_ms"], p7["K6_bound"], p7["K6_library_ms"]),
    ]
    print(json.dumps({"kernels": records}))
    print(smi)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--cluster-worker":
        sys.exit(cluster_worker(sys.argv[2], sys.argv[3]))
    if len(sys.argv) == 3 and sys.argv[1] == "--train-worker":
        sys.exit(train_worker(sys.argv[2]))
    if len(sys.argv) == 7 and sys.argv[1] == "--partition-worker":
        sys.exit(partition_worker(int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5],
                                  sys.argv[6] == "smoke"))
    if len(sys.argv) == 8 and sys.argv[1] == "--mesh-worker":
        sys.exit(mesh_worker(sys.argv[2], int(sys.argv[3]), sys.argv[4], sys.argv[5],
                             sys.argv[6], sys.argv[7] == "smoke"))
    if len(sys.argv) == 3 and sys.argv[1] == "--dryrun-worker":
        sys.exit(dryrun_worker(sys.argv[2]))
    if len(sys.argv) in (3, 4) and sys.argv[1] == "--host-ab":
        sys.exit(host_ab(Path(sys.argv[2]), *map(int, sys.argv[3:])))
    if len(sys.argv) == 3 and sys.argv[1] == "--only":
        sys.exit(main(only=sys.argv[2]))
    sys.exit(main())
