"""The port's plans on DTensors compute what the single-process port
computes: 4 gloo processes run, on DTensors placed by
``configs.param_pspecs`` / ``input_pspecs`` under ``use_mesh``, the paths
that keep the production mesh's tensors split (the dry-run's,
``launch/dryrun.py``), and every rank holds the full tensors against one
process's plain run of the same params and batch:

  * training on a (data 2 × model 2) mesh: gemma3-1b's smoke loss and
    gradients (a tied table: the vocab-split embedding and loss, K6 on each
    rank's query heads with the KV head they read, the residual stream's
    constraint on the way back, each gradient in its param's placement);
    on a (1 × 4) mesh two LMs whose query heads do not divide the model
    dim, so each rank attends over a block of (heads, sequences): 6 query
    and 2 KV heads (every rank a block) and 3 and 1 (two ranks none);
  * decode on a (2 × 2) mesh: gemma3-1b's ``decode_32k`` (the cache split
    over ``model`` by sequence, each rank's partial softmax combined by
    log-sum-exp, the new rows written in place) at cur_len 5 and past the
    cache end (no row in a local layer's window), ``long_500k`` (the cache
    split over ``data``), and deepseek-v2-lite-16b's MLA cache (the MoE
    capacity is per data shard, so its plain run takes each shard's
    sequences apart);
  * training over the multi-pod mesh's data axes, a (pod 2 × data 2 ×
    model 1) mesh: gemma3-1b's train step with ``grad_accum`` 4 on a batch
    of 4, one row a rank (fewer than the microbatches): its loss, gradients
    and updated params against one process's step over 4 microbatches;
  * the GNN zoo on a (2 × 2) and a (pod 2 × data 2 × model 1) mesh: the
    full-graph loss and gradients of gin, sage, schnet and mace (the edge
    sums: each rank's edges into partial node sums, the nodes gathered and
    the sums reduced over pod × data as one group, the nodes split
    unevenly), mace's molecule loss (the readout's sum by graph) and sage's
    sampled blocks (the rows each rank gathers); and, on the latter mesh,
    edge sums and their gradient where 61 nodes and 201 edges split
    unevenly over the 4 ranks;
  * GNN-PE's online scan on a (2 × 2) mesh: each rank scans its own index
    rows, the counts summed.

Float32 throughout; values, gradients and the caches' new rows within rtol
1e-4 and an absolute 1e-5 + 1e-6 × the tensor's largest |value| (sums over
the ranks, and products over a rank's block of a weight, add in another
order, so the error scales with the largest terms: mace's cubic
invariants give gradients in the thousands); the scan's counts exact.
"""
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

SRC = Path(__file__).resolve().parents[1] / "src"

WORKER = r"""
import dataclasses
import sys

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs import (build_step, get_arch, init_params, input_pspecs, make_batch,
                                 param_pspecs, resolve_config)
from repro_torch.dist.context import use_mesh
from repro_torch.dist.sharding import map_specs, to_placements
from repro_torch.launch.mesh import make_local_mesh, make_mesh
from repro_torch.models import gnn_blocks_loss, gnn_energy_loss, gnn_node_loss, lm_loss
from repro_torch.models.gnn import _edge_sums, _gin_messages
from repro_torch.train.functional import tree_leaves, value_and_grad
from repro_torch.train.optimizer import OptConfig, adamw_init
from repro_torch.train.step import train_wrap

rank, port = int(sys.argv[1]), sys.argv[2]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=4, rank=rank)
meshes = {(2, 2): make_local_mesh(2, 2, device="cpu"), (1, 4): make_local_mesh(1, 4, device="cpu"),
          (2, 2, 1): make_mesh((2, 2, 1), ("pod", "data", "model"), device="cpu")}
report = []


def placed(tree, specs, mesh):
    return map_specs(lambda t, s: distribute_tensor(t, mesh, to_placements(mesh, s)), tree, specs)


def full(t):
    return t.full_tensor() if isinstance(t, DTensor) else t


def close(got, want, what, exact=False):
    got, want = full(got).detach().float().numpy(), want.detach().float().numpy()
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if exact:
        assert np.array_equal(got, want), (what, float(np.abs(got - want).max()))
    else:
        err, top = float(np.abs(got - want).max()), float(np.abs(want).max(initial=0.0))
        assert np.allclose(got, want, rtol=1e-4, atol=1e-5 + 1e-6 * top), (what, err, top)


def setup(name, shape, seed=0, cfg=None, batch=None):
    arch = get_arch(name)
    cell = arch.cell(shape)
    cfg = cfg or resolve_config(arch, cell, smoke=True)
    train = cell.kind not in ("prefill", "decode") and arch.family != "gnnpe_online"
    params = init_params(arch, cfg, seed=seed, device="cpu", train=train)
    batch = batch or make_batch(arch, cell, cfg, seed=seed + 1, smoke=True, device="cpu")
    return arch, cell, cfg, params, batch


def grads_case(what, mesh_shape, arch, cell, cfg, params, batch, loss_fn):
    mesh = meshes[mesh_shape]
    (want_loss, _), want = value_and_grad(loss_fn, params, batch)
    with use_mesh(mesh), implicit_replication():
        p = placed(params, param_pspecs(arch, cfg, params), mesh)
        b = placed(batch, input_pspecs(arch, cell, cfg), mesh)
        (loss, _), got = value_and_grad(loss_fn, p, b)
        close(loss, want_loss, (what, "loss"))
        for i, (g, w) in enumerate(zip(tree_leaves(got), tree_leaves(want))):
            close(g, w, (what, "gradient", i))
        assert all(g.placements == q.placements for g, q in zip(tree_leaves(got), tree_leaves(p)))
    report.append(what)


# --- training ---
arch, cell, cfg, params, batch = setup("gemma3-1b", "train_4k")
grads_case("gemma3 train (2, 2)", (2, 2), arch, cell, cfg, params, batch,
           lambda p, b: lm_loss(p, b, cfg))
for hq, hkv in ((6, 2), (3, 1)):
    arch = get_arch("minitron-4b")
    cell = arch.cell("train_4k")
    cfgh = dataclasses.replace(resolve_config(arch, cell, smoke=True), n_heads=hq, n_kv_heads=hkv)
    _, _, _, params, batch = setup("minitron-4b", "train_4k", cfg=cfgh)
    grads_case(f"{hq} query heads over 4 ranks", (1, 4), arch, cell, cfgh, params, batch,
               lambda p, b, cfgh=cfgh: lm_loss(p, b, cfgh))

# the multi-pod mesh's data axes, pod × data: a batch of 4 over 4 ranks, one row a rank, in 4
# microbatches (the plain step's, one row each; the mesh's, one of every rank's rows)
arch, cell, cfg, params, _ = setup("gemma3-1b", "train_4k")
rows = {k: torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab, (4, 64)))
        for k in ("tokens", "labels")}
cfg4 = dataclasses.replace(cfg, grad_accum=4, n_layers=2)
params = init_params(arch, cfg4, seed=0, device="cpu", train=True)
seen = {}


def accum_step(p, b, key):
    step = train_wrap(lambda p, b: lm_loss(p, b, cfg4), OptConfig(), cfg4.grad_accum,
                      grads_fn=lambda g: seen.setdefault(key, g))
    return step(p, adamw_init(p), b)


p_want, _, m_want = accum_step(params, rows, "want")
mesh = meshes[(2, 2, 1)]
with use_mesh(mesh), implicit_replication():
    p, _, m = accum_step(placed(params, param_pspecs(arch, cfg4, params), mesh),
                         placed(rows, input_pspecs(arch, cell, cfg4), mesh), "got")
    close(m["loss"], m_want["loss"], "grad_accum 4 over pod x data: loss")
    for i, (g, w) in enumerate(zip(tree_leaves(seen["got"]), tree_leaves(seen["want"]))):
        close(g, w, ("grad_accum 4 over pod x data: gradient", i))
    for i, (g, w) in enumerate(zip(tree_leaves(p), tree_leaves(p_want))):
        close(g, w, ("grad_accum 4 over pod x data: params", i))
report.append("grad_accum 4, one row a rank")

# --- decode ---
for name, shape, cur in (("gemma3-1b", "decode_32k", 5), ("gemma3-1b", "decode_32k", 70),
                         ("gemma3-1b", "long_500k", 5), ("deepseek-v2-lite-16b", "decode_32k", 5)):
    arch, cell, cfg, params, batch = setup(name, shape)
    batch["cur_len"] = torch.tensor(cur, dtype=torch.int32)
    step, _ = build_step(arch, cell, cfg)
    plain = {"cache": {k: v.clone() for k, v in batch["cache"].items()},
             "tokens": batch["tokens"], "cur_len": batch["cur_len"]}
    if cfg.moe is not None:  # the capacity is per data shard: each shard's sequences apart
        h = batch["tokens"].shape[0] // 2
        parts = [step(params, {"cache": {k: v[:, s] for k, v in plain["cache"].items()},
                               "tokens": plain["tokens"][s], "cur_len": plain["cur_len"]})
                 for s in (slice(0, h), slice(h, None))]
        want = torch.cat([p[0] for p in parts])
        want_cache = {k: torch.cat([p[1][k] for p in parts], 1) for k in plain["cache"]}
    else:
        want, want_cache = step(params, plain)
    mesh = meshes[(2, 2)]
    with torch.no_grad(), use_mesh(mesh), implicit_replication():
        p = placed(params, param_pspecs(arch, cfg, params), mesh)
        specs = input_pspecs(arch, cell, cfg)
        b = {"cache": placed(batch["cache"], specs["cache"], mesh),
             "tokens": placed(batch["tokens"], specs["tokens"], mesh), "cur_len": batch["cur_len"]}
        got, cache = step(p, b)
        close(got, want, (name, shape, cur, "logits"))
        for k in want_cache:
            close(cache[k], want_cache[k], (name, shape, cur, "cache", k))
    report.append(f"{name} {shape} at {cur}")

# --- the GNN zoo ---
for name, shape, loss in (("gin-tu", "full_graph_sm", gnn_node_loss),
                          ("graphsage-reddit", "full_graph_sm", gnn_node_loss),
                          ("schnet", "full_graph_sm", gnn_node_loss),
                          ("mace", "full_graph_sm", gnn_node_loss),
                          ("mace", "molecule", gnn_energy_loss),
                          ("graphsage-reddit", "minibatch_lg", gnn_blocks_loss)):
    arch, cell, cfg, params, batch = setup(name, shape)
    for mesh_shape in ((2, 2), (2, 2, 1)):  # one data axis; pod x data, gathered and reduced as one
        grads_case(f"{name} {shape} {mesh_shape}", mesh_shape, arch, cell, cfg, params, batch,
                   lambda p, b, cfg=cfg, loss=loss: loss(p, cfg, b))

# uneven splits over pod x data: 61 nodes and 201 edges over 4 ranks, the edge sums and their
# gradient against the plain sum, 64 edges a chunk
mesh = meshes[(2, 2, 1)]
rows_pl = [Shard(0), Shard(0), Replicate()]
g = torch.Generator().manual_seed(0)
h, w = torch.randn(61, 8, generator=g), torch.randn(61, 8, generator=g)
ei = torch.randint(0, 61, (201, 2), generator=g, dtype=torch.int32)
hp = h.clone().requires_grad_(True)
want = (torch.zeros(61, 8).index_add(0, ei[:, 1].long(), hp[ei[:, 0].long()]) * w).sum()
want.backward()
with implicit_replication():
    hd = distribute_tensor(h, mesh, rows_pl).requires_grad_(True)
    sums = _edge_sums(_gin_messages, 1, None, hd, None, distribute_tensor(ei, mesh, rows_pl),
                      None, 64)[0]
    assert sums.placements == hd.placements
    got = (sums * distribute_tensor(w, mesh, rows_pl)).sum()
    got.backward()
    close(got, want, "uneven edge sums")
    close(hd.grad, hp.grad, "uneven edge sums: gradient")
report.append("uneven edge sums over pod x data")

# --- GNN-PE's online scan ---
arch, cell, cfg, params, batch = setup("gnn-pe-online", "online_scan")
step, _ = build_step(arch, cell, cfg)
want = step(params, batch)
mesh = meshes[(2, 2)]
with use_mesh(mesh), implicit_replication():
    got = step(placed(params, param_pspecs(arch, cfg, params), mesh),
               placed(batch, input_pspecs(arch, cell, cfg), mesh))
    close(got, want, "online scan", exact=True)
report.append("online scan")

dist.barrier()
dist.destroy_process_group()
print("; ".join(report))
print("ok")
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_the_plans_on_dtensors_compute_the_plain_port_in_4_gloo_processes():
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    env.pop("REPRO_OVERRIDES", None)
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), str(port)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(4)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, (so, se)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and so.strip().endswith("ok"), f"rank {r}: {se[-3000:]}"
    assert outs[0][0].count(";") == 21, outs[0][0]
