"""GPipe over a ``pipe`` mesh of 4 gloo processes (``dist/pipeline.py``), as
the JAX package's ``tests/test_pipeline_parallel.py`` runs its schedule on 4
host devices: P = 4 stages of two linear + ReLU layers, M = 6 microbatches
of (8, 16).  Every rank returns the last stage's outputs, bit-equal to the
port applying the 4 stages in sequence and within 1e-5 of the reference's
``pipeline_apply`` from the same weights."""
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

SRC = Path(__file__).resolve().parents[1] / "src"

REFERENCE = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import sys
import jax, jax.numpy as jnp, numpy as np
from repro.dist.pipeline import pipeline_apply

P_STAGES, M, B, D = 4, 6, 8, 16
rng = np.random.default_rng(0)
w = rng.normal(size=(P_STAGES, 2, D, D)).astype(np.float32) / np.sqrt(D)
xs = rng.normal(size=(M, B, D)).astype(np.float32)


def stage_fn(params, x):
    for i in range(2):
        x = jax.nn.relu(x @ params[i])
    return x


mesh = jax.make_mesh((4,), ("pipe",), axis_types=(jax.sharding.AxisType.Auto,))
out = pipeline_apply(stage_fn, jnp.asarray(w), jnp.asarray(xs), mesh, axis="pipe")
np.savez(sys.argv[1], w=np.asarray(jnp.asarray(w)), xs=xs, out=np.asarray(out))
print("REF_OK")
"""

WORKER = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.dist.pipeline import pipeline_apply
from repro_torch.launch.mesh import make_mesh

rank, port, path = int(sys.argv[1]), sys.argv[2], sys.argv[3]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=4, rank=rank)
mesh = make_mesh((4,), ("pipe",), device="cpu")
ref = np.load(path)
w, xs = torch.from_numpy(ref["w"]), torch.from_numpy(ref["xs"])


def stage_fn(params, x):
    for i in range(2):
        x = torch.relu(x @ params[i])
    return x


k = mesh.get_local_rank("pipe")
out = pipeline_apply(stage_fn, w[k].clone(), xs, mesh, axis="pipe")
seq = xs
for s in range(4):
    seq = torch.stack([stage_fn(w[s], mb) for mb in seq])
assert out.shape == xs.shape and torch.equal(out, seq), float((out - seq).abs().max())
err = float((out - torch.from_numpy(ref["out"])).abs().max())
assert err < 1e-5, err
dist.barrier()
dist.destroy_process_group()
print(f"reference max |err| {err:.2e}")
print("ok")
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_gpipe_in_4_gloo_processes_equals_the_sequential_stages_and_the_reference(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    path = str(tmp_path / "pipe.npz")
    ref = subprocess.run([sys.executable, "-c", REFERENCE, path],
                         env={**env, "JAX_PLATFORMS": "cpu"}, capture_output=True, text=True,
                         timeout=300)
    assert "REF_OK" in ref.stdout, ref.stdout + ref.stderr[-3000:]
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), str(port), path], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(4)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=150))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, (so, se)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and so.strip().endswith("ok"), f"rank {r}: {se[-3000:]}"
