#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA card and check them.

    python3 chip_smoke.py

Phases, each printing its seconds:

  1. build every CUDA kernel of the port from ``src/`` (one ``nvcc`` per
     source, all at once) and print the card's name and power limit;
  2. hold each kernel against its plain PyTorch version on the card,
     bit for bit: K1 on seeded pairs, K2 on seeded join rows, K3-single
     and K3-batch on seeded dense scans (ties at eps, +inf / NaN rows,
     sentinel and pad ids);
  3. the main path at paper scale: ``GnnPeEngine.build`` then
     ``match_many`` on a 50K-vertex NWS graph in 80 partitions with 16
     queries of 8 vertices; every match set must equal VF2's, K1 must
     have run on that path, and its verdict on the real probe's pairs
     must equal the plain version's; K1 is timed there.  Then the device
     join on the same engine (``join_impl="device"``, K2 must run; its
     match sets equal VF2's and the host join's) and the dense-scan entry
     ``ops.dominance_scan`` (K3) over every partition's real index, which
     must keep exactly the loop probe's rows; K3 is timed over all the
     indexed rows;
  4. the GAT encoder, trained on the card, on a 2,000-vertex graph;
  5. the join-heavy batch: 8 relabeled-isomorphic 8-vertex queries on a
     12K-vertex, 3-label NWS graph (the configuration of
     ``benchmarks/bench_join.py --full``), device join against the host
     join and VF2; K2's verdicts on the real join steps equal the plain
     version's, and K2 is timed at the largest step;
  6. DCN-v2 serving at the published width (26 tables of 1M x 16, cross
     width 429, MLP 1024-1024-512), params from a seeded CUDA generator,
     through ``repro_torch.configs``: K4 (embedding bag) and K5 (cross
     layer) first on seeded edge shapes against their plain versions,
     then the cells ``serve_p99`` (B = 512), ``serve_bulk`` (B = 262,144)
     and ``retrieval_cand`` (1 query x 1M candidates, top-100), each
     driven once through ``build_step``: K4 must launch once and K5 three
     times per forward, K4 on the forward's real operands must equal its
     plain version bit for bit and each K5 call its plain version within
     1e-4, and the logits (all of ``serve_p99``, the first 4,096 rows of
     ``serve_bulk``) and the top-100 must equal the port's CPU run of the
     same params and batch; warm step ms, rows/s and the step's device
     time split into K4, K5 and the rest per cell; K4 and K5 timed at
     ``serve_bulk`` beside their plain versions and library calls.

Prints one JSON line of kernel records, the ``nvidia-smi`` name and power
limit line, and last ``{"ok": true, "device": {...}}``.  Exits non-zero
without a card, outside the repository, or if any check fails.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
SRC = "src/repro_torch/kernels"
SPIN_CYCLES = 2_000_000  # about 1 ms of the card's clock


def log(msg: str) -> None:
    print(msg, flush=True)


def sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def time_ms(fn, args, reps: int, flush) -> float:
    """Mean device ms of ``fn(*args)``, with L2 flushed before each call
    (the main path gathers fresh operands that mostly miss L2) and the
    card held busy by a spin while the host enqueues the call, so the
    host's launch latency stays out of the events."""
    import torch

    for _ in range(3):
        fn(*args)
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """Least time for the work: bytes over the memory rate vs operations
    over the float32 rate (the larger of the two, and which it is)."""
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / FP32_OPS_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def k1_bound_ms(T: int, D: int, D0: int) -> tuple[float, str]:
    """T pairs: inputs once, 1-byte output; add+cmp per D, sub+abs+cmp per D0."""
    return bound_ms(T * 4 * (2 * D + 2 * D0) + T, T * (2 * D + 3 * D0))


def k2_bound_ms(T: int, Co: int, Cn: int) -> tuple[float, str]:
    """T join rows: ids once, 1-byte output; one compare per (new, old) and
    (new, new) pair, counted at the float32 rate (the guide's table has no
    int32 row; the bytes bound is the larger at either rate)."""
    return bound_ms(T * 4 * (Co + Cn) + T, T * (Co * Cn + Cn * (Cn - 1) // 2))


def k3_bound_ms(Q: int, N: int, D: int, D0: int) -> tuple[float, str]:
    """Q query rows × N data rows: every row once, a (Q, N) byte output;
    add+cmp per D, sub+abs+cmp per D0 for every cell."""
    return bound_ms((Q + N) * 4 * (D + D0) + Q * N, Q * N * (2 * D + 3 * D0))


def k4_bound_ms(N: int, K: int, E: int, n_set: int, n_nonempty: int) -> tuple[float, str]:
    """N bags of K slots: ids and mask bytes once, one E-float table row for
    each set slot (what this run's data reads), the (N, E) output once;
    one add per float past each bag's first set slot."""
    return bound_ms(N * K * 5 + n_set * E * 4 + N * E * 4, (n_set - n_nonempty) * E)


def k5_bound_ms(B: int, D: int) -> tuple[float, str]:
    """x0, x and the output (B, D), w (D, D) and b once; a multiply-add (2
    operations) per (row, k, column), bias, multiply and add per output."""
    return bound_ms(4 * (3 * B * D + D * D + D), 2 * B * D * D + 3 * B * D)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def counters():
    """The launch counts of every kernel, by name."""
    from repro_torch.kernels.cross_interact import ops as ci
    from repro_torch.kernels.dominance_scan import ops as ds
    from repro_torch.kernels.merge_join import ops as mj
    from repro_torch.kernels.star_agg import ops as sa

    return {
        "K1": ds.LAUNCHES, "K2": mj.LAUNCHES,
        "K3-single": ds.SINGLE_LAUNCHES, "K3-batch": ds.BATCH_LAUNCHES,
        "K4": sa.LAUNCHES, "K5": ci.LAUNCHES,
    }


def reset_counters() -> None:
    from repro_torch.kernels.cross_interact import ops as ci
    from repro_torch.kernels.dominance_scan import ops as ds
    from repro_torch.kernels.merge_join import ops as mj
    from repro_torch.kernels.star_agg import ops as sa

    ds.LAUNCHES = ds.SINGLE_LAUNCHES = ds.BATCH_LAUNCHES = 0
    mj.LAUNCHES = sa.LAUNCHES = ci.LAUNCHES = 0


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


def fmt(ms: list) -> str:
    return ", ".join(f"{m:.3f}" for m in ms)


def device_join_breakdown(eng, queries, dev, what: str) -> None:
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
            _, st = eng.match_many(queries, join_impl="device", return_stats=True)
            sync(dev)
            wall = (time.perf_counter() - t_p) * 1e3
    finally:
        mt._join_candidates_device_batch, mt._refine_device_batch = join_fn, refine_fn
        mt._joinstep_body = step_fn
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    join_s = sum(s.join_time for s in st)
    log(f"{what}, profiled warm device-join match_many: {wall:.3f} ms wall; filter "
        f"{sum(s.filter_time for s in st) * 1e3:.3f} ms, join + refine {join_s * 1e3:.3f} ms, "
        f"of which join steps {spent['join'] * 1e3:.3f} ms ({spent['steps']} fused steps, one "
        f"read-back each), refine {spent['refine'] * 1e3:.3f} ms and the rest (grouping, "
        f"match tuples on the host) {(join_s - spent['join'] - spent['refine']) * 1e3:.3f} ms; "
        f"device busy {busy:.3f} ms in {sum(e.count for e in kernels)} kernel launches")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]:
        log(f"  device {e.self_device_time_total / 1e3:.3f} ms x{e.count}: {e.key[:90]}")


# ---- phase 2 ----------------------------------------------------------------


def phase2_kernels(dev, big: int = (1 << 20) + 7) -> dict:
    """Each kernel against its plain version, bit for bit → max |err| by kernel."""
    import torch

    from repro_torch.kernels.dominance_scan import ops as ds
    from repro_torch.kernels.dominance_scan.ref import (
        dominance_scan_batch_ref,
        dominance_scan_pairs_ref,
        dominance_scan_ref,
        make_pairs,
        make_scan,
    )
    from repro_torch.kernels.merge_join import ops as mj
    from repro_torch.kernels.merge_join.ref import injectivity_mask_ref, make_join_rows

    def err(got, want, what: str) -> float:
        sync(dev)
        require(got.shape == want.shape and torch.equal(got, want),
                f"{what} differs from its plain version")
        return float((got.int() - want.int()).abs().max()) if got.numel() else 0.0

    errs = {"K1": 0.0, "K2": 0.0, "K3-single": 0.0, "K3-batch": 0.0}
    for T in (1, 1000, big):
        args = [torch.from_numpy(a).to(dev) for a in make_pairs(T, seed=T)]
        got = ds.dominance_scan_pairs(*args)
        errs["K1"] = max(errs["K1"], err(got, dominance_scan_pairs_ref(*args), f"K1 at T={T}"))
        log(f"K1 T={T}: bit-equal to the plain version, kept {int(got.sum())}")
    for T in (1, 1000, big):
        for Co, Cn in ((7, 1), (5, 2), (0, 3), (3, 2), (56, 8)):
            old, new = (torch.from_numpy(a).to(dev) for a in make_join_rows(T, Co, Cn, seed=T + Co))
            got = mj.injectivity_mask(old, new)
            want = injectivity_mask_ref(old, new)
            errs["K2"] = max(errs["K2"], err(got, want, f"K2 at T={T}, Co={Co}, Cn={Cn}"))
        log(f"K2 T={T}: bit-equal to the plain version at (Co, Cn) in "
            "(7, 1), (5, 2), (0, 3), (3, 2), (56, 8)")
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
    return errs


# ---- phase 3 ----------------------------------------------------------------


def dense_scan_check(eng, queries, dev):
    """For every partition and plan path, K3 over the partition's index
    keeps exactly the loop probe's rows (K3-batch for all paths at once,
    K3-single per path) → (query rows, label rows) of partition 0, the
    concatenated index (emb ⊕ emb_multi, emb0) and the count of checks."""
    import torch

    from repro_torch.kernels.dominance_scan import ops as ds

    cat, spans = eng._query_node_embeddings_many(queries)
    plans = [eng._deg_plan_cached(q) for q in queries]
    requests = list(dict.fromkeys((qi, p) for qi, pl in enumerate(plans) for p in pl.paths))
    memo: dict = {}
    eng._probe_batch(requests, (cat, spans), memo)
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

    from repro_torch.core import GnnPeConfig, GnnPeEngine, TrainConfig, sort_matches
    from repro_torch.core import index as index_mod
    from repro_torch.graphs import newman_watts_strogatz, random_connected_query
    from repro_torch.kernels.dominance_scan import ops as ds
    from repro_torch.kernels.dominance_scan.ref import (
        dominance_scan_batch_ref,
        dominance_scan_pairs_ref,
        dominance_scan_ref,
    )

    out: dict = {}
    g = newman_watts_strogatz(n, k=4, p=0.1, n_labels=100, seed=11)
    queries = [random_connected_query(g, 8, seed=42 + s) for s in range(n_queries)]
    cfg = GnnPeConfig(n_partitions=n_parts, encoder="monotone", train=TrainConfig(max_epochs=150))
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
    # the real probe's verdict, recorded and re-run through the plain version
    seen = []
    keep_mask = index_mod._pairs_keep_mask

    def record(*a):
        res = keep_mask(*a)
        seen.append((a, res))
        return res

    index_mod._pairs_keep_mask = record
    try:
        eng.match_many(queries)
    finally:
        index_mod._pairs_keep_mask = keep_mask
    require(len(seen) == 1, f"expected one fused verdict per match_many, saw {len(seen)}")
    (qg, q0g, eg, e0g, eps), keep = seen[0]
    require(torch.equal(keep, dominance_scan_pairs_ref(qg, q0g, eg, e0g, eps)),
            "K1 on the real probe's pairs differs from the plain version")
    # where a warm batch's time goes: host-clock stages and device-busy time
    with torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    ) as prof:
        t_p = time.perf_counter()
        _, qstats = eng.match_many(queries, return_stats=True)
        sync(dev)
        prof_ms = (time.perf_counter() - t_p) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    filter_ms = sum(s.filter_time for s in qstats) * 1e3
    join_ms = sum(s.join_time for s in qstats) * 1e3
    log(f"profiled warm match_many: {prof_ms:.3f} ms wall; filter (embed + plan + probe) "
        f"{filter_ms:.3f} ms, join + refine {join_ms:.3f} ms; device busy {busy_ms:.3f} ms "
        f"in {sum(e.count for e in kernels)} kernel launches")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]:
        log(f"  device {e.self_device_time_total / 1e3:.3f} ms x{e.count}: {e.key[:90]}")
    T, D = qg.shape
    D0 = q0g.shape[1]
    out["K1_ms"] = time_ms(ds.dominance_scan_pairs, (qg, q0g, eg, e0g, eps), 50, flush)
    out["K1_plain_ms"] = time_ms(dominance_scan_pairs_ref, (qg, q0g, eg, e0g, eps), 50, flush)
    out["K1_bound"] = k1_bound_ms(T, D, D0)
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
    log(f"K1 at T={T}: {out['K1_ms']:.6f} ms, bound {out['K1_bound'][0]:.6f} ms "
        f"({out['K1_bound'][1]}), plain version {out['K1_plain_ms']:.6f} ms")

    # ---- the device join on the same engine ------------------------------
    reset_counters()
    t_cold = time.perf_counter()
    dev_matches = eng.match_many(queries, join_impl="device")
    sync(dev)
    cold_dev_s = time.perf_counter() - t_cold
    launched = counters()
    out["K2"] = launched["K2"]
    log(f"K2 LAUNCHES (device join, cold match_many of the 50K cell): {launched['K2']}; "
        f"K1 {launched['K1']}")
    require(launched["K2"] > 0, "the device join never launched the K2 kernel")
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
    out["K3s_ms"] = time_ms(ds.dominance_scan, (q1, q01, e_all, e0_all), 50, flush)
    out["K3s_plain_ms"] = time_ms(dominance_scan_ref, (q1, q01, e_all, e0_all), 50, flush)
    out["K3s_bound"] = k3_bound_ms(1, N, D, D0)
    out["K3b_ms"] = time_ms(ds.dominance_scan, (qm, q0m, e_all, e0_all), 20, flush)
    out["K3b_plain_ms"] = time_ms(dominance_scan_batch_ref, (qm, q0m, e_all, e0_all), 5, flush)
    out["K3b_bound"] = k3_bound_ms(n_req, N, D, D0)
    log(f"K3-single at N={N}, D={D}, D0={D0}: {out['K3s_ms']:.6f} ms, bound "
        f"{out['K3s_bound'][0]:.6f} ms ({out['K3s_bound'][1]}), plain version "
        f"{out['K3s_plain_ms']:.6f} ms")
    log(f"K3-batch at Q={n_req}, N={N}: {out['K3b_ms']:.6f} ms, bound "
        f"{out['K3b_bound'][0]:.6f} ms ({out['K3b_bound'][1]}), plain version "
        f"{out['K3b_plain_ms']:.6f} ms")
    return out


# ---- phase 4 ----------------------------------------------------------------


def phase4_gat(dev) -> None:
    from repro_torch.core import GnnPeConfig, GnnPeEngine, TrainConfig
    from repro_torch.graphs import newman_watts_strogatz, random_connected_query

    g2 = newman_watts_strogatz(2_000, k=4, p=0.1, n_labels=100, seed=11)
    cfg2 = GnnPeConfig(n_partitions=2, encoder="gat", train=TrainConfig(max_epochs=150))
    reset_counters()
    eng2 = GnnPeEngine(cfg2).build(g2)
    queries2 = [random_connected_query(g2, 6, seed=7 + s) for s in range(4)]
    check_against_vf2(g2, queries2, eng2.match_many(queries2), "gat")
    require(counters()["K1"] > 0, "the GAT engine's match_many never launched the K1 kernel")
    log(f"gat: epochs {[m.train_epochs for m in eng2.models]}, "
        f"fallback vertices {[m.n_fallback for m in eng2.models]}, "
        f"train {eng2.offline_stats['train_time']:.3f} s")


# ---- phase 5 ----------------------------------------------------------------


def phase5_join_heavy(dev, flush, n: int = 12_000, n_parts: int = 12) -> dict:
    import torch

    from repro_torch.core import GnnPeConfig, GnnPeEngine, sort_matches
    from repro_torch.graphs import newman_watts_strogatz
    from repro_torch.kernels.merge_join import ops as mj
    from repro_torch.kernels.merge_join.ref import injectivity_mask_ref

    out: dict = {}
    g = newman_watts_strogatz(n, k=6, p=0.1, n_labels=3, seed=7)
    queries = iso_batch(g, 8, 8, seed=0)
    t_build = time.perf_counter()
    eng = GnnPeEngine(GnnPeConfig(n_partitions=n_parts, encoder="monotone")).build(g)
    log(f"join-heavy build: {time.perf_counter() - t_build:.3f} s, "
        f"{eng.offline_stats['n_paths']} paths, {g.n_edges} edges")
    reset_counters()
    t_cold = time.perf_counter()
    dev_matches = eng.match_many(queries, join_impl="device")
    sync(dev)
    cold_s = time.perf_counter() - t_cold
    out["K2"] = counters()["K2"]
    require(out["K2"] > 0, "the join-heavy device join never launched the K2 kernel")
    host_matches = eng.match_many(queries)
    for qi, (a, b) in enumerate(zip(dev_matches, host_matches)):
        require(sort_matches(a) == sort_matches(b), f"join-heavy query {qi}: joins differ")
    t_vf2 = time.perf_counter()
    n_matches = check_against_vf2(g, queries, dev_matches, "join-heavy")
    log(f"join-heavy: {n_matches} matches, device join = host join = VF2 for all "
        f"{len(queries)} queries (VF2 {time.perf_counter() - t_vf2:.3f} s); "
        f"K2 LAUNCHES {out['K2']}, cold device match_many {cold_s * 1e3:.3f} ms")
    # K2's verdicts on the real join steps, recorded and re-run plain
    seen = []
    verdict = mj.injectivity_mask

    def record(old, new):
        res = verdict(old, new)
        seen.append((old, new, res))
        return res

    mj.injectivity_mask = record
    try:
        eng.match_many(queries, join_impl="device")
    finally:
        mj.injectivity_mask = verdict
    for old, new, res in seen:
        require(torch.equal(res, injectivity_mask_ref(old, new)),
                f"K2 on a real join step (T={old.shape[0]}) differs from the plain version")
    old, new, _ = max(seen, key=lambda s: s[0].shape[0])
    T, Co, Cn = old.shape[0], old.shape[1], new.shape[1]
    log(f"K2 on {len(seen)} real join steps: equal to the plain version; steps (T, Co, Cn): "
        + ", ".join(f"({o.shape[0]}, {o.shape[1]}, {w.shape[1]})" for o, w, _ in seen))
    out["K2_ms"] = time_ms(mj.injectivity_mask, (old, new), 50, flush)
    out["K2_plain_ms"] = time_ms(injectivity_mask_ref, (old, new), 20, flush)
    out["K2_bound"] = k2_bound_ms(T, Co, Cn)
    log(f"K2 at the largest step T={T}, Co={Co}, Cn={Cn}: {out['K2_ms']:.6f} ms, bound "
        f"{out['K2_bound'][0]:.6f} ms ({out['K2_bound'][1]}), plain version "
        f"{out['K2_plain_ms']:.6f} ms")
    dev_warm, host_warm = [], []
    for _ in range(3):
        dev_warm += warm_ms(lambda: eng.match_many(queries, join_impl="device"), dev, 1)
        host_warm += warm_ms(lambda: eng.match_many(queries), dev, 1)
    log(f"join-heavy warm match_many: device join {fmt(dev_warm)} ms; host join "
        f"{fmt(host_warm)} ms (interleaved)")
    device_join_breakdown(eng, queries, dev, "join-heavy")
    return out


# ---- phase 6 ----------------------------------------------------------------


def step_breakdown(step, args, what: str, wall_ms: float, reps: int = 5) -> None:
    """Device ms of one warm step, split into K4, K5 and the rest by CUDA
    events around the kernel calls, with the card held busy by a long spin
    while the host enqueues the whole step (so the events see device time
    only); the idle share is that device time against the warm wall ms.
    (``torch.profiler`` listed only some of this step's kernels on the
    card, so events time it.)"""
    import torch

    from repro_torch.kernels.cross_interact import ops as ci
    from repro_torch.kernels.star_agg import ops as sa

    marks: list = []
    star_agg, cross = sa.star_agg, ci.cross_interact

    def timed(key, fn):
        def run(*a):
            s_, e_ = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s_.record()
            res = fn(*a)
            e_.record()
            marks.append((key, s_, e_))
            return res
        return run

    spent = {"step": 0.0, "K4": 0.0, "K5": 0.0}
    sa.star_agg, ci.cross_interact = timed("K4", star_agg), timed("K5", cross)
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
        sa.star_agg, ci.cross_interact = star_agg, cross
    rest = spent["step"] - spent["K4"] - spent["K5"]
    log(f"{what}, device time of a warm step (CUDA events, host enqueue hidden): "
        f"{spent['step']:.3f} ms = K4 embedding bag {spent['K4']:.3f} + K5 cross stack "
        f"{spent['K5']:.3f} + dense features, MLP, head and the rest {rest:.3f}; against the "
        f"warm wall median {wall_ms:.3f} ms the card is {100 * (1 - spent['step'] / wall_ms):.1f} % idle")


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
    for B, D in ((1, 429), (513, 429), (1000, 130), (7, 1)):
        x0, x, w, b = (torch.from_numpy(a).to(dev) for a in make_cross(B, D, seed=B + D))
        got = ci.cross_interact(x0, x, w, b)
        want = cross_interact_ref(x0, x, w, b)
        sync(dev)
        require(torch.allclose(got, want, rtol=1e-4, atol=1e-4),
                f"K5 at B={B}, D={D} differs from its plain version")
        err5 = max(err5, float((got - want).abs().max()))
    log(f"K5 edge shapes (B, D) (1, 429), (513, 429), (1000, 130), (7, 1) within 1e-4: "
        f"max |err| {err5:.3g}")
    return err4, err5


def phase6_dcn_serving(dev, flush) -> dict:
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import build_step, get_arch, init_params, make_batch, resolve_config
    from repro_torch.kernels.cross_interact import ops as ci
    from repro_torch.kernels.cross_interact.ref import cross_interact_ref
    from repro_torch.kernels.star_agg import ops as sa
    from repro_torch.kernels.star_agg.ref import star_agg_ref
    from repro_torch.models import dcn_forward

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
        for k, (a, res5) in enumerate(seen["K5"]):
            want5 = cross_interact_ref(*a)
            require(torch.allclose(res5, want5, rtol=1e-4, atol=1e-4),
                    f"{name}: K5 call {k} differs from its plain version")
            out["K5_err"] = max(out["K5_err"], float((res5 - want5).abs().max()))
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
                f"forward's {idx.shape[0]} bags), K5 x{launched['K5']} (max |err| vs plain "
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
        step_breakdown(step, (params, batch), name, med)
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
            x0, x, w, b = seen["K5"][0][0]
            out["K5_ms"] = time_ms(ci.cross_interact, (x0, x, w, b), 10, flush)
            out["K5_plain_ms"] = time_ms(cross_interact_ref, (x0, x, w, b), 10, flush)
            out["K5_library_ms"] = time_ms(torch.addmm, (b, x, w), 10, flush)
            out["K5_bound"] = k5_bound_ms(*x.shape)
            log(f"K4 at N={N}, K={K}, E={E} (serve_bulk): {out['K4_ms']:.6f} ms, bound "
                f"{out['K4_bound'][0]:.6f} ms ({out['K4_bound'][1]}), plain version "
                f"{out['K4_plain_ms']:.6f} ms, F.embedding_bag {out['K4_library_ms']:.6f} ms")
            log(f"K5 at B={x.shape[0]}, D={x.shape[1]} (serve_bulk): {out['K5_ms']:.6f} ms, "
                f"bound {out['K5_bound'][0]:.6f} ms ({out['K5_bound'][1]}), plain version "
                f"{out['K5_plain_ms']:.6f} ms, torch.addmm (GEMM and bias only) "
                f"{out['K5_library_ms']:.6f} ms")
        del seen, got, want, batch
    log(f"dcn-v2 peak device memory: {torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1

    from repro_torch.kernels import build as kbuild

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

    t = time.perf_counter()
    errs = phase2_kernels(dev)
    log(f"phase 2 kernels vs plain versions: {time.perf_counter() - t:.3f} s")

    t = time.perf_counter()
    p3 = phase3_main_path(dev, flush)
    log(f"phase 3 main path, 50K vertices / 80 partitions: {time.perf_counter() - t:.3f} s")

    t = time.perf_counter()
    phase4_gat(dev)
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
    records = [
        record("dominance_scan_pairs", "K1", scan_cu, f"{scan_py}:98", p3["K1"],
               p3["K1_ms"], p3["K1_plain_ms"], p3["K1_bound"]),
        record("injectivity_mask", "K2", f"{SRC}/merge_join/csrc/injectivity_mask.cu",
               "src/repro/kernels/merge_join/kernel.py:47", p3["K2"] + p5["K2"],
               p5["K2_ms"], p5["K2_plain_ms"], p5["K2_bound"]),
        record("dominance_scan", "K3-single", scan_cu, f"{scan_py}:129", p3["K3-single"],
               p3["K3s_ms"], p3["K3s_plain_ms"], p3["K3s_bound"]),
        record("dominance_scan_batch", "K3-batch", scan_cu, f"{scan_py}:58", p3["K3-batch"],
               p3["K3b_ms"], p3["K3b_plain_ms"], p3["K3b_bound"]),
        record("star_agg", "K4", f"{SRC}/star_agg/csrc/star_agg.cu",
               "src/repro/kernels/star_agg/kernel.py:39", p6["K4"], p6["K4_ms"],
               p6["K4_plain_ms"], p6["K4_bound"], p6["K4_library_ms"]),
        # library_ms of K5 is torch.addmm: the GEMM and bias only, not the fused layer
        record("cross_interact", "K5", f"{SRC}/cross_interact/csrc/cross_interact.cu",
               "src/repro/kernels/cross_interact/kernel.py:28", p6["K5"], p6["K5_ms"],
               p6["K5_plain_ms"], p6["K5_bound"], p6["K5_library_ms"]),
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
    sys.exit(main())
