"""The models' sharding hints on DTensors compute what the plain model
computes: 4 gloo processes as a (data 2 × model 2) mesh run the smoke
gemma3-1b and deepseek-v2-lite-16b (MLA, MoE) ``prefill_32k`` steps and
DCN-v2's ``serve_bulk`` step on DTensors, the params placed by
``configs.param_pspecs`` (tensor parallelism over ``model``) and the batch
by ``input_pspecs``, under ``use_mesh`` (the ``maybe_shard`` hints place
the activations; K6, K5 and K4 run per shard, the MoE block through its
rank-local expert-parallel path under ``local_map``).

The full tensors (``full_tensor``) are held, on every rank, against the
single-process port on the same params and against the JAX package's
outputs from the params ``convert.*_from_reference`` carried: float32
within rtol 1e-4 / atol 1e-5 (``test_torch_transformer.py``,
``test_torch_recsys.py``; GEMM partial sums added over the model ranks in
another order).  The MoE capacity is per data shard, as the reference's
mesh branch has it, so the MoE model's single-process and JAX outputs are
each data shard's sequences run apart and concatenated.  On plain tensors
the hints are no-ops: the other test files run the same models unchanged.
"""
import os
import pickle
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jcfg  # noqa: E402
from repro.models import recsys as jrec  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
CELLS = [("gemma3-1b", "prefill_32k"), ("deepseek-v2-lite-16b", "prefill_32k"),
         ("dcn-v2", "serve_bulk")]

WORKER = r"""
import pickle
import sys
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.configs import build_step, get_arch, input_pspecs, param_pspecs, resolve_config
from repro_torch.convert import dcn_params_from_reference, lm_params_from_reference
from repro_torch.dist.context import use_mesh
from repro_torch.dist.sharding import map_specs, to_placements
from repro_torch.launch.mesh import make_local_mesh

rank, port, path = int(sys.argv[1]), sys.argv[2], sys.argv[3]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=4, rank=rank)
mesh = make_local_mesh(2, 2, device="cpu")
with open(path, "rb") as f:
    cases = pickle.load(f)


def placed(tree, specs):
    return map_specs(lambda t, s: distribute_tensor(t, mesh, to_placements(mesh, s)), tree, specs)


def close(got, want, what):
    err = float(np.abs(got - want).max())
    assert np.allclose(got, want, rtol=1e-4, atol=1e-5), (what, err)
    return err


report = []
for name, cell_name, jparams, batch, jax_out in cases:
    arch = get_arch(name)
    cell = arch.cell(cell_name)
    cfg = resolve_config(arch, cell, smoke=True)
    carry = lm_params_from_reference if arch.family == "lm" else dcn_params_from_reference
    params = carry(jparams, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    step, _ = build_step(arch, cell, cfg)
    if arch.family == "lm" and cfg.moe is not None:
        half = batch["tokens"].shape[0] // 2  # the capacity is per data shard
        want = torch.cat([step(params, {"tokens": batch["tokens"][:half]}),
                          step(params, {"tokens": batch["tokens"][half:]})])
    else:
        want = step(params, batch)
    with use_mesh(mesh), implicit_replication():
        got = step(placed(params, param_pspecs(arch, cfg, params)),
                   placed(batch, input_pspecs(arch, cell, cfg)))
        full = got.full_tensor()
    e1 = close(full.numpy(), want.numpy(), (name, "against the single-process port"))
    e2 = close(full.numpy(), jax_out, (name, "against the JAX package"))
    report.append(f"{name} {tuple(full.shape)} {got.placements}: {e1:.1e} / {e2:.1e}")
dist.barrier()
dist.destroy_process_group()
print("; ".join(report))
print("ok")
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _case(name: str, cell_name: str, seed: int):
    """(name, cell, the JAX params as NumPy, the batch as NumPy, JAX's output)."""
    arch = jcfg.get_arch(name)
    cell = arch.cell(cell_name)
    cfg = jcfg.resolve_config(arch, cell, smoke=True)
    params = jcfg.init_params(arch, cfg, jax.random.PRNGKey(seed))
    batch = jax.tree.map(np.asarray, jcfg.make_batch(arch, cell, cfg, seed=seed))
    if arch.family == "lm":
        toks = batch["tokens"]
        half = toks.shape[0] // 2
        if cfg.moe is not None:  # each data shard's sequences apart, as the mesh runs them
            out = np.concatenate([np.asarray(jtr.lm_forward(params, jnp.asarray(t), cfg)[0])
                                  for t in (toks[:half], toks[half:])])
        else:
            out = np.asarray(jtr.lm_forward(params, jnp.asarray(toks), cfg)[0])
    else:
        out = np.asarray(jrec.dcn_forward(params, jnp.asarray(batch["dense"]),
                                          jnp.asarray(batch["sparse"]), cfg))
    return name, cell_name, jax.tree.map(np.asarray, params), batch, out


def test_sharding_hints_on_dtensors_compute_the_plain_models_in_4_gloo_processes(tmp_path):
    cases = [_case(name, cell, seed) for seed, (name, cell) in enumerate(CELLS)]
    path = tmp_path / "cases.pkl"
    path.write_bytes(pickle.dumps(cases))
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), str(port), str(path)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
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
    assert all(name in outs[0][0] for name, _ in CELLS), outs[0][0]
