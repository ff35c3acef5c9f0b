"""The LM's mesh steps in 4 gloo processes: ``build_step(..., mesh=)``'s
train step and ``decode_step(mesh=)`` against the same work in one process.

The smoke deepseek config (MLA, 8 experts, shared experts) trains one batch
of 4 sequences over a (data 2 × model 2) and a (data 4 × model 1) mesh,
with ``fsdp`` off and on.  Each rank holds its blocks of the float32 master
params (``expert_parallel_specs``) and its data shard's sequences.  The
single-process counterpart runs on the whole params the loss those ranks
share: the mean over the data shards of ``lm_loss`` on each shard's
sequences (the capacity and the aux loss are per data shard, as the
reference's mesh branch has them).  Held, on every rank:

  * each gradient leaf after ``lm_grad_sync`` against the rank's block of
    the single-process gradients, and ``lm_grad_norm`` against their
    ``global_norm``;
  * two train steps of ``build_step(..., mesh=)`` (the clip engaged, so the
    second update depends on the first step's norm): the rank's updated
    blocks, ``grad_norm`` and the loss against the single-process steps';
  * with ``grad_accum`` 2 on the (4 × 1) mesh, each rank holding one row,
    fewer than ``grad_accum``: the mesh step's gradients, updated blocks,
    norm and loss against one process's train step over 2 microbatches
    (the mean of the microbatch means, each the mean over its rows); and
    with ``grad_accum`` 3, which a batch of 4 does not divide, the mesh
    step raises on every rank, as the single-process step does.

Then two ``decode_step(mesh=)`` steps over the (2, 2) mesh give each data
shard's logits and cache of the local decode of its sequences, and
``lm_forward(mesh=)`` refuses params split as ``lm_param_specs`` splits them
(attention over ``model``, which the port does not run)."""
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
from repro_torch.configs import build_step, get_arch, init_params, resolve_config
from repro_torch.dist.sharding import DP, P, lm_param_specs, local_shard, shard_tree
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import (decode_step, expert_parallel_specs, init_cache, lm_forward,
                                lm_grad_norm, lm_grad_sync, lm_loss)
from repro_torch.train.functional import tree_leaves, value_and_grad
from repro_torch.train.optimizer import OptConfig, adamw_init, global_norm
from repro_torch.train.step import train_wrap

rank, port = int(sys.argv[1]), sys.argv[2]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=4, rank=rank)
meshes = {(2, 2): make_local_mesh(2, 2, device="cpu"), (4, 1): make_local_mesh(4, 1, device="cpu")}
arch = get_arch("deepseek-v2-lite-16b")
cell = arch.cell("train_4k")
base = resolve_config(arch, cell, smoke=True)
rng = np.random.default_rng(0)
B, S = 4, 32
batch = {k: torch.from_numpy(rng.integers(0, base.vocab, size=(B, S))) for k in ("tokens", "labels")}
# warmup 1: a full learning rate from the first step; clip 0.05: under the norm, so it scales
# the gradients; eps 1e-4, near the clipped gradients' size, so that the update follows their
# scale (a smaller eps makes a first Adam step sign(g), blind to the scale, and turns float32
# rounding in gradients near 0 into whole steps)
opt = OptConfig(lr=1e-3, warmup_steps=1, clip_norm=0.05, eps=1e-4)
report = []


def close(got, want, what, rtol=1e-4, atol=1e-6):
    err = float((got - want).abs().max()) if got.numel() else 0.0
    assert torch.allclose(got, want, rtol=rtol, atol=atol), (what, err)
    return err


for (nd, nm), fsdp in [((2, 2), False), ((2, 2), True), ((4, 1), True), ((4, 1), False)]:
    mesh = meshes[(nd, nm)]
    cfg = dataclasses.replace(base, moe=dataclasses.replace(base.moe, fsdp=fsdp))
    what = f"mesh ({nd}, {nm}) fsdp {fsdp}"
    params = init_params(arch, cfg, seed=0, device="cpu", train=True)

    def shards_loss(p, b):  # the loss the ranks share: the mean over the data shards'
        parts = [lm_loss(p, {k: v[i * B // nd:(i + 1) * B // nd] for k, v in b.items()}, cfg)
                 for i in range(nd)]
        return (sum(x[0] for x in parts) / nd,
                {"loss": sum(x[1]["loss"] for x in parts) / nd})

    specs = expert_parallel_specs(params, fsdp=fsdp)
    mine = {k: local_shard(v, P(DP, None), mesh) for k, v in batch.items()}
    assert mine["tokens"].shape[0] == B // nd
    (_, _), want = value_and_grad(shards_loss, params, batch)
    local = shard_tree(params, specs, mesh)
    (_, _), got = value_and_grad(lambda p, b: lm_loss(p, b, cfg, mesh), local, mine)
    got = lm_grad_sync(got, cfg, mesh)
    worst = max(close(g, w, (what, "grad")) for g, w in
                zip(tree_leaves(got), tree_leaves(shard_tree(want, specs, mesh))))
    gn, gn_want = lm_grad_norm(got, cfg, mesh), global_norm(want)
    close(gn, gn_want, (what, "grad norm"), rtol=1e-5, atol=0)
    assert float(gn_want) > opt.clip_norm, (what, "the clip does not engage", float(gn_want))

    step, _ = build_step(arch, cell, cfg, opt, mesh=mesh)
    step_want = train_wrap(shards_loss, opt)
    state, state_want = (local, adamw_init(local)), (params, adamw_init(params))
    for i in range(2):
        p, o, m = step(*state, mine)
        p_want, o_want, m_want = step_want(*state_want, batch)
        state, state_want = (p, o), (p_want, o_want)
        for g, w in zip(tree_leaves(p), tree_leaves(shard_tree(p_want, specs, mesh))):
            close(g, w, (what, "step", i, "params"), rtol=0, atol=1e-6)
        close(m["grad_norm"], m_want["grad_norm"], (what, "step", i, "grad norm"), 1e-5, 0)
        close(m["loss"], m_want["loss"], (what, "step", i, "loss"), 1e-5, 0)
    report.append(f"{what}: grads {worst:.2e}")

# microbatches where a rank holds fewer rows than grad_accum: one row a rank for grad_accum 2
mesh = meshes[(4, 1)]
cfg = dataclasses.replace(base, grad_accum=2, moe=dataclasses.replace(base.moe, fsdp=True))
params = init_params(arch, cfg, seed=0, device="cpu", train=True)
specs = expert_parallel_specs(params, fsdp=True)
local = shard_tree(params, specs, mesh)
mine = {k: local_shard(v, P(DP, None), mesh) for k, v in batch.items()}
assert mine["tokens"].shape[0] == 1 < cfg.grad_accum


def rows_loss(p, b):  # a microbatch's mean over its rows, each row a data shard of its own
    parts = [lm_loss(p, {k: v[i:i + 1] for k, v in b.items()}, cfg)
             for i in range(b["tokens"].shape[0])]
    n = len(parts)
    return sum(x[0] for x in parts) / n, {"loss": sum(x[1]["loss"] for x in parts) / n}


grads = {}
step_want = train_wrap(rows_loss, opt, cfg.grad_accum,
                       grads_fn=lambda g: grads.setdefault("want", g))
# build_step's mesh step, its gradients seen on their way to the update
step_got = train_wrap(lambda p, b: lm_loss(p, b, cfg, mesh), opt, cfg.grad_accum,
                      grads_fn=lambda g: grads.setdefault("got", lm_grad_sync(g, cfg, mesh)),
                      norm_fn=lambda g: lm_grad_norm(g, cfg, mesh), data_ranks=4)
p_want, _, m_want = step_want(params, adamw_init(params), batch)
p_got, _, m_got = step_got(local, adamw_init(local), mine)
for g, w in zip(tree_leaves(grads["got"]), tree_leaves(shard_tree(grads["want"], specs, mesh))):
    close(g, w, ("fewer rows than grad_accum", "grad"))
step, _ = build_step(arch, cell, cfg, opt, mesh=mesh)
p, _, m = step(local, adamw_init(local), mine)
for got in (p, p_got):
    for g, w in zip(tree_leaves(got), tree_leaves(shard_tree(p_want, specs, mesh))):
        close(g, w, ("fewer rows than grad_accum", "params"), rtol=0, atol=1e-6)
close(m["grad_norm"], m_want["grad_norm"], ("fewer rows than grad_accum", "grad norm"), 1e-5, 0)
close(m["loss"], m_want["loss"], ("fewer rows than grad_accum", "loss"), 1e-5, 0)
report.append("fewer rows than grad_accum ok")
# a global batch of 4 does not split into 3 microbatches: every rank raises, as one process does
cfg3 = dataclasses.replace(cfg, grad_accum=3)
step, _ = build_step(arch, cell, cfg3, opt, mesh=mesh)
for fn, args in ((step, (local, adamw_init(local), mine)),
                 (train_wrap(rows_loss, opt, 3), (params, adamw_init(params), batch))):
    try:
        fn(*args)
    except ValueError as e:
        assert "does not split into 3 microbatches" in str(e), e
    else:
        raise AssertionError("a batch of 4 split into 3 microbatches")
report.append("uneven microbatches raise")

mesh = meshes[(2, 2)]
cfg = resolve_config(arch, arch.cell("decode_32k"), smoke=True)
params = init_params(arch, cfg, seed=0, device="cpu")
local = shard_tree(params, expert_parallel_specs(params), mesh)
d = mesh.get_local_rank("data")
cache, cache_want = init_cache(cfg, 2, 8, device="cpu"), init_cache(cfg, 2, 8, device="cpu")
with torch.no_grad():
    for t in range(2):
        tokens = batch["tokens"][2 * d:2 * d + 2, t]
        got, cache = decode_step(local, cache, tokens, t, cfg, mesh)
        want, cache_want = decode_step(params, cache_want, tokens, t, cfg)
        close(got, want, ("decode", t, "logits"), rtol=1e-5, atol=1e-5)
for k in cache:
    assert torch.equal(cache[k], cache_want[k]), ("decode cache", k)
report.append("decode ok")
# the full placement specs split attention over 'model' too, which the port does not run
try:
    lm_forward(shard_tree(params, lm_param_specs(params), mesh), tokens[:, None], cfg, mesh)
except ValueError as e:
    assert "expert_parallel_specs" in str(e), e
else:
    raise AssertionError("lm_forward(mesh=) ran on attention blocks split over 'model'")
dist.barrier()
dist.destroy_process_group()
print("; ".join(report))
print("ok")
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_mesh_train_step_and_decode_in_4_gloo_processes_equal_one_process():
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
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
