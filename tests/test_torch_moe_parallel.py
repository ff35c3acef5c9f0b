"""MoE expert parallelism in 8 gloo processes, a (data 2 × model 4) mesh, as
the JAX package's ``tests/test_moe_parallel.py`` runs its ``shard_map``
branch on 8 host devices, and a data-only (data 8 × model 1) mesh with
``fsdp``, where the reference's GSPMD gathers the experts' hidden dim and
the port's ranks all-gather it.

The reference's mesh branch runs in one subprocess (8 host devices) and
writes its params, outputs, gradients and kept and dropped (token, expert)
sets; the port's ranks take their blocks of the same params
(``dist.sharding.shard_tree``) and tokens (``moe_token_spec``) and hold,
with ``fsdp`` off and on and at capacity factors 8 (nothing drops) and 1.0
(entries drop per data shard) on the (2, 4) mesh, and with ``fsdp`` at
capacity factor 8 on the (8, 1) mesh (there the reference routes the whole
batch at once, so only a case where nothing drops is the same work), and
with ``fsdp`` and drops on a (pod 2 × data 2 × model 2) mesh (the tokens
split over pod × data, the experts gathered over data alone): the
output within 2e-5 and every gradient leaf (after ``moe_grad_sync``) within 5e-4 of the reference's block, the
kept and dropped sets identical, the output equal to the port's local
``moe_block`` on the rank's tokens, and ``aux`` the local block's.  Then
the smoke deepseek config's ``lm_forward(mesh=)`` logits equal the local
forward of each data shard's sequence."""
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

SRC = Path(__file__).resolve().parents[1] / "src"
T, D = 64, 32  # tokens and model width
# (mesh (data, model), fsdp, capacity factor), spliced into both scripts
# a 3-dim mesh is (pod, data, model): the tokens split over pod × data, fsdp over data alone
CASES = [((2, 4), False, 8.0), ((2, 4), False, 1.0), ((2, 4), True, 8.0), ((2, 4), True, 1.0),
         ((8, 1), True, 8.0), ((2, 2, 2), True, 1.0)]
PRELUDE = (f"CASES = {CASES!r}\nCASES_MESHES = sorted({{c[0] for c in CASES}})\n"
           "NAMES = {2: ('data', 'model'), 3: ('pod', 'data', 'model')}\n")

REFERENCE = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.models.moe import MoEConfig, _route, init_moe_params, moe_block

out_dir, T, D = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
x = np.random.default_rng(0).normal(size=(T, D)).astype(np.float32)
meshes = {s: jax.make_mesh(s, NAMES[len(s)], axis_types=(jax.sharding.AxisType.Auto,) * len(s))
          for s in CASES_MESHES}
for i, (shape, fsdp, cf) in enumerate(CASES):
    mesh = meshes[shape]
    mcfg = MoEConfig(n_experts=8, top_k=2, d_ff_expert=64, n_shared=1, capacity_factor=cf,
                     fsdp=fsdp)
    params = init_moe_params(jax.random.PRNGKey(1), D, mcfg)
    wspec = P("model", "data", None) if fsdp else P("model")
    shard_p = {k: NamedSharding(mesh, wspec if k in ("w1", "w3", "w2") else P()) for k in params}
    f = jax.jit(lambda p, x: moe_block(x, p, mcfg, mesh=mesh),
                in_shardings=(shard_p, NamedSharding(mesh, P(NAMES[len(shape)][:-1], None))))
    out, _ = f(params, jnp.asarray(x))
    grads = jax.jit(jax.grad(
        lambda p: jnp.sum(moe_block(jnp.asarray(x), p, mcfg, mesh=mesh)[0] ** 2)))(params)
    sets = {}
    nd = int(np.prod(shape[:-1]))
    for d in range(nd):  # each data shard routes its own tokens at its own capacity
        topi = np.asarray(_route(jnp.asarray(x[d * T // nd:(d + 1) * T // nd]), params["router"],
                                 mcfg)[0])
        t_loc = topi.shape[0]
        cap = max(int(t_loc * mcfg.top_k / mcfg.n_experts * cf), 4)
        flat_e = topi.reshape(-1)
        order = np.argsort(flat_e, kind="stable")
        se, st = flat_e[order], np.repeat(np.arange(t_loc), mcfg.top_k)[order]
        rank = np.arange(se.size) - np.searchsorted(se, se, side="left")
        sets[f"kept{d}"] = np.stack([st, se], 1)[rank < cap]
        sets[f"dropped{d}"] = np.stack([st, se], 1)[rank >= cap]
    np.savez(f"{out_dir}/case{i}.npz", x=x, out=np.asarray(out),
             **{f"p_{k}": np.asarray(v) for k, v in params.items()},
             **{f"g_{k}": np.asarray(v) for k, v in grads.items()}, **sets)
print("REF_OK")
"""

WORKER = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.configs import get_arch, init_params, make_batch, resolve_config
from repro_torch.dist.sharding import DP, P, lm_param_specs, local_shard, shard_tree
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import (MoEConfig, expert_parallel_specs, lm_forward,
                                moe_block, moe_grad_sync, moe_token_spec)
from repro_torch.models import moe as moe_mod

rank, port, out_dir = int(sys.argv[1]), sys.argv[2], sys.argv[3]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=8, rank=rank)
meshes = {s: make_mesh(s, NAMES[len(s)], device="cpu") for s in CASES_MESHES}
report = []
for i, (shape, fsdp, cf) in enumerate(CASES):
    mesh = meshes[shape]
    data_axes = NAMES[len(shape)][:-1]
    d = 0  # this rank's token shard: its (pod, data) coordinate, pod major
    for a in data_axes:
        d = d * mesh.size(data_axes.index(a)) + mesh.get_local_rank(a)
    ref = np.load(f"{out_dir}/case{i}.npz")
    mcfg = MoEConfig(n_experts=8, top_k=2, d_ff_expert=64, n_shared=1, capacity_factor=cf,
                     fsdp=fsdp)
    full = {k[2:]: torch.from_numpy(ref[k]) for k in ref.files if k.startswith("p_")}
    specs = lm_param_specs({"layers": [{"moe": full}]}, fsdp=fsdp)["layers"][0]["moe"]
    local = {k: v.clone().requires_grad_() for k, v in shard_tree(full, specs, mesh).items()}
    x = torch.from_numpy(ref["x"])
    xspec = moe_token_spec(x.shape[0], mesh)
    assert xspec == P(data_axes, None), xspec  # the tokens split over the data axes
    xl = local_shard(x, xspec, mesh)
    routes = []
    route = moe_mod._route
    moe_mod._route = lambda *a: routes.append(route(*a)) or routes[-1]
    try:
        out, aux = moe_block(xl, local, mcfg, mesh)
    finally:
        moe_mod._route = route
    want = local_shard(torch.from_numpy(ref["out"]), xspec, mesh)
    err = float((out - want).abs().max())
    assert err < 2e-5, (i, "output", err)
    plan = moe_mod.dispatch_plan(*routes[0][:2], mcfg)
    pairs = torch.stack([plan["token"], plan["expert"]], 1)
    for name, sel in (("kept", plan["keep"]), ("dropped", ~plan["keep"])):
        got = {tuple(r) for r in pairs[sel].tolist()}
        assert got == {tuple(r) for r in ref[f"{name}{d}"].tolist()}, (i, name)
    assert (len(ref[f"dropped{d}"]) > 0) == (cf == 1.0), (i, "drops")
    with torch.no_grad():
        solo, solo_aux = moe_block(xl, full, mcfg)
    assert torch.allclose(out, solo, rtol=0, atol=1e-5), (i, "local", float((out - solo).abs().max()))
    assert abs(float(aux) - float(solo_aux)) <= 1e-6 * abs(float(solo_aux)), (i, "aux")
    (out ** 2).sum().backward()
    grads = moe_grad_sync({k: v.grad for k, v in local.items()}, mcfg, mesh)
    worst = 0.0
    for k, g in grads.items():
        g_want = local_shard(torch.from_numpy(ref[f"g_{k}"]), specs[k], mesh)
        e = float((g - g_want).abs().max())
        assert e < 5e-4, (i, "grad", k, e)
        worst = max(worst, e)
    report.append(f"case {i}: out {err:.2e} grad {worst:.2e}")

mesh = meshes[(2, 4)]
arch = get_arch("deepseek-v2-lite-16b")
cell = arch.cell("prefill_32k")
cfg = resolve_config(arch, cell, smoke=True)
params = init_params(arch, cfg, seed=0, device="cpu")
tokens = make_batch(arch, cell, cfg, seed=0, device="cpu")["tokens"]
mine = local_shard(tokens, P(DP, None), mesh)
with torch.no_grad():
    got = lm_forward(shard_tree(params, expert_parallel_specs(params), mesh), mine, cfg, mesh)[0]
    want = lm_forward(params, mine, cfg)[0]
assert tokens.shape[0] == 2 and mine.shape[0] == 1
assert torch.allclose(got, want, rtol=1e-5, atol=1e-5), float((got - want).abs().max())
report.append(f"deepseek logits {float((got - want).abs().max()):.2e}")
dist.barrier()
dist.destroy_process_group()
print("; ".join(report))
print("ok")
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_expert_parallel_in_8_gloo_processes_equals_the_reference_mesh_branch(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    ref = subprocess.run([sys.executable, "-c", PRELUDE + REFERENCE, str(tmp_path), str(T), str(D)],
                         env={**env, "JAX_PLATFORMS": "cpu"}, capture_output=True, text=True,
                         timeout=300)
    assert "REF_OK" in ref.stdout, ref.stdout + ref.stderr[-3000:]
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, "-c", PRELUDE + WORKER, str(r), str(port),
                               str(tmp_path)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(8)]
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
