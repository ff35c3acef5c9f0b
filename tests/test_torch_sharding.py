"""The placement specs and the mesh context (``dist/sharding.py``,
``dist/context.py``, ``configs.param_pspecs`` / ``input_pspecs``) against
the JAX package's.

``param_pspecs`` equals the reference's leaf by leaf for every architecture
of the registry at its smoke config (a port layer's spec is the reference's
stacked spec without its leading scan dim), also with FSDP; ``input_pspecs``
equals it for every cell; ``filter_spec`` on ``(data,)``, ``(data,
model)`` and ``(pod, data, model)`` meshes.  ``local_shard`` gives, for
every coordinate of a (2, 4) and a (2, 2, 2) mesh, the block the
reference's ``NamedSharding`` puts on the device there (one subprocess with
8 host devices writes them); 8 gloo processes then hold ``local_shard`` at
their own ``DeviceMesh`` coordinate to the same blocks, ``to_placements``'
DTensor to them too, and ``maybe_shard``: a no-op without a mesh, a
``redistribute`` under one."""
import itertools
import json
import os
import socket
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

import repro.configs as rc  # noqa: E402
from repro.dist import sharding as rs  # noqa: E402
import repro_torch.configs as pc  # noqa: E402
from repro_torch.dist import sharding as ps  # noqa: E402
from repro_torch.dist.context import maybe_shard, use_mesh  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
MESHES = [((2, 4), ("data", "model")), ((2, 2, 2), ("pod", "data", "model"))]
SPECS = [  # entries as JSON lists (a list entry: several axes, the first major)
    ["data", "model"], ["model", None, "data"], [["pod", "data"], "model"],
    [None, ["data", "model"]], ["model"], [], [["data", "model"], None, None],
    [["pod", "data", "model"]], [None, None, ["pod", "model"]],
]
SHAPE = (8, 16, 8)


def _spec(entries, cls):
    return cls(*(tuple(e) if isinstance(e, list) else e for e in entries))


def _plain(tree):
    """A spec tree (dicts, lists; JAX's or the port's specs) → nested
    Python lists and dicts with each spec a tuple of its entries."""
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, (JP, tuple)):  # a spec: the port's is a tuple
        return tuple(tree)
    return [_plain(v) for v in tree]


def _ref_lm_layout(specs: dict, n_stacked: int) -> dict:
    """The reference's LM spec tree laid out as the port's: ``prefix_layers``
    then ``n_stacked`` copies of the stacked ``layers`` specs, each without
    its leading scan dim."""
    out = {k: v for k, v in specs.items() if k not in ("layers", "prefix_layers")}

    def unstack(tree):
        if isinstance(tree, dict):
            return {k: unstack(v) for k, v in tree.items()}
        assert tree[0] is None, tree  # the scan dim is never sharded
        return tuple(tree)[1:]

    out["layers"] = list(specs.get("prefix_layers", [])) + [unstack(specs["layers"])] * n_stacked
    return out


def _smoke(name: str):
    rarch, parch = rc.get_arch(name), pc.get_arch(name)
    cell = parch.shapes[0]
    return (rarch, rc.resolve_config(rarch, rarch.cell(cell.name), smoke=True),
            parch, pc.resolve_config(parch, cell, smoke=True))


@pytest.mark.parametrize("name", pc.list_archs(include_extra=True))
def test_param_pspecs_equal_the_reference_for_every_arch(name):
    rarch, rcfg, parch, pcfg = _smoke(name)
    rparams = jax.eval_shape(lambda k: rc.init_params(rarch, rcfg, k), jax.random.PRNGKey(0))
    pparams = pc.init_params(parch, pcfg, seed=0, device="cpu")
    want = rc.param_pspecs(rarch, rcfg, rparams)
    got = pc.param_pspecs(parch, pcfg, pparams)
    if parch.family == "lm":
        n_stacked = pcfg.n_layers - pcfg.first_dense
        want = _ref_lm_layout(want, n_stacked)
        for fsdp in (False, True):  # the FSDP rules too, at the smoke shapes
            assert _plain(ps.lm_param_specs(pparams, fsdp=fsdp)) == _plain(_ref_lm_layout(
                rs.lm_param_specs(rparams, fsdp=fsdp), n_stacked)), fsdp
    assert _plain(got) == _plain(want)


@pytest.mark.parametrize("arch,cell", [(a.name, c.name) for a, c in pc.all_cells(
    include_skipped=True, include_extra=True)])
def test_input_pspecs_equal_the_reference_for_every_cell(arch, cell):
    rarch, parch = rc.get_arch(arch), pc.get_arch(arch)
    rcfg = rc.resolve_config(rarch, rarch.cell(cell), smoke=True)
    pcfg = pc.resolve_config(parch, parch.cell(cell), smoke=True)
    want = rc.input_pspecs(rarch, rarch.cell(cell), rcfg)
    got = pc.input_pspecs(parch, parch.cell(cell), pcfg)
    assert _plain(got) == _plain(want)


def test_filter_spec_equals_the_reference_on_three_meshes():
    for names in (("data",), ("data", "model"), ("pod", "data", "model")):
        mesh = types.SimpleNamespace(axis_names=names)
        for entries in SPECS + [[ps.DP, None], [None, ps.DP, "model"]]:
            want = rs.filter_spec(_spec(entries, JP), mesh)
            got = ps.filter_spec(_spec(entries, ps.P), mesh)
            assert tuple(got) == tuple(want), (names, entries)
            assert ps.filter_spec(_spec(entries, ps.P), names) == got


def test_maybe_shard_without_a_mesh_is_the_tensor_itself():
    x = torch.arange(6.0).view(2, 3)
    assert maybe_shard(x, "data", None) is x
    with use_mesh(types.SimpleNamespace(mesh_dim_names=("data",), shape=(1,))):
        assert maybe_shard(x, "data", None) is x  # a plain tensor takes no hint


REFERENCE = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json, sys
import jax, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.dist.sharding import filter_spec

meshes, specs, shape, out = json.loads(sys.argv[1]), json.loads(sys.argv[2]), sys.argv[3], sys.argv[4]
x = np.arange(np.prod(json.loads(shape))).reshape(json.loads(shape)).astype(np.float32)
blocks = {}
for mi, (mshape, names) in enumerate(meshes):
    mesh = jax.make_mesh(tuple(mshape), tuple(names),
                         axis_types=(jax.sharding.AxisType.Auto,) * len(names))
    for si, entries in enumerate(specs):
        spec = filter_spec(P(*(tuple(e) if isinstance(e, list) else e for e in entries)), mesh)
        arr = jax.device_put(x, NamedSharding(mesh, spec))
        for sh in arr.addressable_shards:
            coord = tuple(int(c) for c in np.argwhere(mesh.devices == sh.device)[0])
            blocks["m%d_s%d_%s" % (mi, si, "-".join(map(str, coord)))] = np.asarray(sh.data)
np.savez(out, **blocks)
print("REF_OK")
"""

WORKER = r"""
import json, sys
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, distribute_tensor
from repro_torch.dist.context import maybe_shard, use_mesh
from repro_torch.dist.sharding import P, local_shard, to_placements
from repro_torch.launch.mesh import make_mesh

rank, port, path, meshes, specs, shape = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                                          json.loads(sys.argv[4]), json.loads(sys.argv[5]),
                                          json.loads(sys.argv[6]))
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=8, rank=rank)
blocks = np.load(path)
x = torch.arange(int(np.prod(shape)), dtype=torch.float32).view(shape)
for mi, (mshape, names) in enumerate(meshes):
    mesh = make_mesh(mshape, names, device="cpu")
    coord = "-".join(map(str, mesh.get_coordinate()))
    for si, entries in enumerate(specs):
        spec = P(*(tuple(e) if isinstance(e, list) else e for e in entries))
        want = torch.from_numpy(blocks[f"m{mi}_s{si}_{coord}"])
        got = local_shard(x, spec, mesh)
        assert torch.equal(got, want), (mi, si, coord)
        dt = distribute_tensor(x, mesh, to_placements(mesh, spec))
        assert torch.equal(dt.to_local(), want), (mi, si, "to_placements")
    rep = distribute_tensor(x, mesh, [Replicate()] * len(names))
    with use_mesh(mesh):
        moved = maybe_shard(rep, ("pod", "data"), "model", None)
    assert torch.equal(moved.to_local(), local_shard(x, P(("pod", "data"), "model"), mesh))
    assert maybe_shard(rep, "data") is rep  # no mesh active out here
dist.barrier()
dist.destroy_process_group()
print("ok")
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_local_shard_gives_the_reference_blocks_on_every_device(tmp_path):
    path = str(tmp_path / "blocks.npz")
    args = [json.dumps(MESHES), json.dumps(SPECS), json.dumps(SHAPE)]
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    ref = subprocess.run([sys.executable, "-c", REFERENCE, *args, path],
                         env={**env, "JAX_PLATFORMS": "cpu"}, capture_output=True, text=True,
                         timeout=300)
    assert "REF_OK" in ref.stdout, ref.stdout + ref.stderr[-3000:]
    blocks = np.load(path)
    x = torch.arange(int(np.prod(SHAPE)), dtype=torch.float32).view(SHAPE)
    for mi, (mshape, names) in enumerate(MESHES):
        mesh = types.SimpleNamespace(mesh_dim_names=names, shape=mshape)
        for si, entries in enumerate(SPECS):
            for coord in itertools.product(*map(range, mshape)):
                want = blocks[f"m{mi}_s{si}_{'-'.join(map(str, coord))}"]
                got = ps.local_shard(x, _spec(entries, ps.P), mesh, coord)
                np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{names} {entries}")
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), str(port), path, *args],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(8)]
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
