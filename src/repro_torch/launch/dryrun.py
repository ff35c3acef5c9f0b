"""Production-mesh dry-run: one step of every (arch × shape × mesh) cell on
DTensors over a fake process group, counted per rank (the JAX package's
``launch/dryrun.py``, which lowers and compiles each cell for 512 host
devices).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-1b --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh both] [--out experiments/dryrun_torch]

Per cell (``run_cell``): a fake process group of the mesh's ranks, in this
one process as rank 0 (``torch.distributed``'s ``fake`` backend: its
collectives move nothing); the production mesh (``launch/mesh.py``) of
the card's device type on any host, so that DTensor plans the collectives
NCCL runs (on a CPU mesh it plans gloo's, an all-gather for an
all-to-all) and the record does not depend on the host; the params'
shapes from ``init_params`` under ``FakeTensorMode``, made meta tensors
(nothing allocated or computed), with the AdamW state where the step takes
one, placed by ``configs.param_pspecs`` as DTensors, and the batch by
``input_specs`` / ``input_pspecs``; one step on them under
``launch/op_cost.py`` inside ``use_mesh`` (so the models' ``maybe_shard``
hints place the activations).  Meta tensors and not fake ones: DTensor's
own bookkeeping of a strided split builds index tensors that a fake mode
would turn abstract and then reads them.  Under ``device.abstract_card``
the kernels' wrappers take a meta tensor as the card's (their custom ops'
fake kernels give the shapes), so the counts are those of the program the
card runs.  It records the JAX record's keys:
``trace_s`` in place of ``lower_s`` / ``compile_s``; ``memory`` with rank
0's ``argument_size_in_bytes`` and ``peak_memory_in_bytes`` (its live
local bytes); the per-rank flops, bytes, ``bytes_fused``, collective bytes
by kind and count; ``model_params`` / ``model_params_active``.  XLA's
own numbers (``xla_flops_raw``, ``xla_bytes_raw``, ``hlo_bytes``) have no
counterpart.  A cell the registry skips records ``skipped`` with its
reason; a step that raises records ``error``.

The orchestrator (``--all``) runs one subprocess per cell (a fake group is
process-global) and skips the cells already recorded ok or skipped
(resumable).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from ..configs import (
    build_step,
    get_arch,
    init_params,
    input_pspecs,
    input_specs,
    param_pspecs,
    resolve_config,
)
from ..device import abstract_card
from ..dist.context import use_mesh
from ..dist.sharding import map_specs, to_placements
from ..train.optimizer import OptConfig
from .mesh import make_mesh, make_production_mesh
from .op_cost import analyze_step

__all__ = ["run_cell", "orchestrate", "main", "fake_group", "OUT_DEFAULT"]

OUT_DEFAULT = Path("experiments/dryrun_torch")
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}
_DTYPES = {np.dtype(np.int32): torch.int32, np.dtype(np.int64): torch.int64,
           np.dtype(np.float32): torch.float32, np.dtype(np.bool_): torch.bool,
           np.dtype(np.int8): torch.int8}


def fake_group(world: int) -> None:
    """A fake process group of ``world`` ranks in this process, as rank 0
    (the one there was replaced if it was fake, with DTensor's sharding
    caches; a real one raises)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("the dry-run needs a fake process group, a real one is initialised")
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
        # DTensor caches op shardings with the meshes they name: a mesh of the group just
        # destroyed, equal to a later cell's, would hand that cell groups that no longer exist
        from torch.distributed.tensor.debug import _clear_sharding_prop_cache

        _clear_sharding_prop_cache()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


@contextlib.contextmanager
def _abstract_init():
    """``init_params`` on fake tensors for the params' shapes and dtypes:
    ``trunc_normal_`` reads a value back (a data-dependent step) that a fake
    tensor does not have, and abstract params are never read, so their draw
    is skipped."""
    orig = torch.nn.init.trunc_normal_
    torch.nn.init.trunc_normal_ = lambda t, *args, **kwargs: t
    try:
        yield
    finally:
        torch.nn.init.trunc_normal_ = orig


def _distribute(t, spec, mesh):
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(t, mesh, to_placements(mesh, spec))


def _walk(tree, fn):
    if isinstance(tree, dict):
        return {k: _walk(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_walk(v, fn) for v in tree]
    return fn(tree)


def _batch(specs, pspecs, mesh, seq_len):
    """The cell's batch as DTensors of meta tensors placed by ``pspecs``; a
    decode step's ``cur_len`` a real host scalar (``make_batch``'s
    min(5, S − 1))."""
    out = {}
    for name, spec in specs.items():
        if name == "cur_len":
            out[name] = torch.tensor(min(5, seq_len - 1), dtype=torch.int32)
        elif isinstance(spec, dict):
            out[name] = _batch(spec, pspecs[name], mesh, seq_len)
        elif isinstance(spec, list):
            out[name] = [_batch(s, p, mesh, seq_len) for s, p in zip(spec, pspecs[name])]
        else:
            shape, dtype = spec
            dtype = dtype if isinstance(dtype, torch.dtype) else _DTYPES[np.dtype(dtype)]
            out[name] = _distribute(torch.empty(shape, dtype=dtype, device="meta"),
                                    pspecs[name], mesh)
    return out


def _params_counts(cfg, arch, params) -> tuple:
    """(model_params, model_params_active): the LM's analytic counts, else
    the params' elements, as the JAX module's helpers count them."""
    if arch.family == "lm":
        return int(cfg.n_params()), int(cfg.n_active_params())
    leaves = []
    _walk(params, leaves.append)
    n = sum(math.prod(t.shape) for t in leaves)
    return n, n


def _trace(arch, cell, mesh_kind, smoke: bool, mesh_shape, batch: int | None) -> dict:
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor.experimental import implicit_replication

    if batch is not None:
        key = "global_batch" if "global_batch" in cell.meta else "batch"
        cell = dataclasses.replace(cell, meta={**cell.meta, key: batch})
    shape, names = mesh_shape or MESHES[mesh_kind]
    fake_group(math.prod(shape))
    if mesh_shape is None:
        mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"), device="cuda")
    else:
        mesh = make_mesh(shape, names, device="cuda")
    cfg = resolve_config(arch, cell, smoke=smoke)
    specs = input_specs(arch, cell, cfg, smoke=smoke)
    pspecs = input_pspecs(arch, cell, cfg)
    step, takes_opt = build_step(arch, cell, cfg, opt_cfg=OptConfig())
    t0 = time.perf_counter()
    with FakeTensorMode(), _abstract_init():
        shapes = init_params(arch, cfg, seed=0, device="cpu", train=takes_opt)
    params = _walk(shapes, lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"))
    n_params, n_active = _params_counts(cfg, arch, params)
    with use_mesh(mesh), implicit_replication(), abstract_card():
        params = map_specs(lambda t, s: _distribute(t, s, mesh), params,
                           param_pspecs(arch, cfg, params))
        data = _batch(specs, pspecs, mesh, cell.meta.get("seq_len", 1))
        if takes_opt:
            def moments(p):
                return DTensor.from_local(
                    torch.empty(p.to_local().shape, dtype=torch.float32, device="meta"), mesh,
                    p.placements, run_check=False, shape=p.shape, stride=p.stride())

            opt = {"m": _walk(params, moments), "v": _walk(params, moments),
                   "step": DTensor.from_local(torch.empty((), dtype=torch.int32, device="meta"),
                                              mesh, [Replicate()] * mesh.ndim, run_check=False)}
            stats = analyze_step(step, params, opt, data)
        else:
            stats = analyze_step(step, params, data)
    return {
        "status": "ok",
        "trace_s": round(time.perf_counter() - t0, 2),
        "n_devices": int(mesh.size()),
        "mesh_device": mesh.device_type,
        "memory": stats.pop("memory"),
        **{k: stats[k] for k in ("flops", "bytes", "bytes_fused", "collective_bytes",
                                 "collective_bytes_total", "collective_count")},
        "model_params": n_params,
        "model_params_active": n_active,
        "n_ops": stats["n_ops"],
    }


def run_cell(arch_name: str, shape_name: str, mesh_kind: str, out_dir: Path | None,
             smoke: bool = False, mesh_shape=None, batch: int | None = None) -> dict:
    """Dry-run one cell → its record (also written to ``out_dir`` where one is
    given).  ``mesh_kind`` "single" (16 × 16, data × model) or "multi" (2 ×
    16 × 16, pod × data × model); ``mesh_shape`` ((shape), (names)) puts
    another mesh in its place (the tests' and the card's small ones),
    ``batch`` another global batch."""
    arch = get_arch(arch_name)
    cell = arch.cell(shape_name)
    rec = {"arch": arch_name, "shape": shape_name, "mesh": mesh_kind}
    if cell.skip:
        rec.update(status="skipped", reason=cell.skip)
    else:
        try:
            rec.update(_trace(arch, cell, mesh_kind, smoke, mesh_shape, batch))
        except Exception as e:  # a cell's failure is its record; the sweep goes on
            notes = "".join(f"; {n}" for n in getattr(e, "__notes__", ()))
            rec.update(status="error", error=f"{type(e).__name__}: {e}{notes}"[:2000],
                       traceback=traceback.format_exc()[-4000:])
    if out_dir is not None:
        _save(Path(out_dir), rec)
    return rec


def _save(out_dir: Path, rec: dict) -> None:
    out_dir.mkdir(parents=True, exist_ok=True)
    p = out_dir / f"{rec['arch']}__{rec['shape']}__{rec['mesh']}.json"
    p.write_text(json.dumps(rec, indent=1))
    print(f"[dryrun] {rec['arch']}/{rec['shape']}/{rec['mesh']}: {rec['status']}", flush=True)


def orchestrate(mesh_kinds: list[str], out_dir: Path, only_arch: str | None = None,
                timeout: int = 3600) -> list:
    """Every cell of ``configs.all_cells`` (skipped and extra ones too) on
    each mesh kind, one subprocess a cell; a cell already recorded ok or
    skipped is read back, not run again."""
    from ..configs import all_cells

    results = []
    for arch, cell in all_cells(include_skipped=True, include_extra=True):
        if only_arch and arch.name != only_arch:
            continue
        for mk in mesh_kinds:
            p = out_dir / f"{arch.name}__{cell.name}__{mk}.json"
            if p.exists():
                rec = json.loads(p.read_text())
                if rec.get("status") in ("ok", "skipped"):
                    print(f"[dryrun] cached {p.name}: {rec['status']}")
                    results.append(rec)
                    continue
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch.name,
                   "--shape", cell.name, "--mesh", mk, "--out", str(out_dir)]
            t0 = time.time()
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout)
                if proc.returncode != 0 or not p.exists():
                    rec = {"arch": arch.name, "shape": cell.name, "mesh": mk, "status": "error",
                           "stderr": proc.stderr[-4000:], "elapsed_s": round(time.time() - t0, 1)}
                    _save(out_dir, rec)
                else:
                    rec = json.loads(p.read_text())
            except subprocess.TimeoutExpired:
                rec = {"arch": arch.name, "shape": cell.name, "mesh": mk, "status": "timeout"}
                _save(out_dir, rec)
            results.append(rec)
    ok = sum(1 for r in results if r.get("status") == "ok")
    sk = sum(1 for r in results if r.get("status") == "skipped")
    bad = [r for r in results if r.get("status") not in ("ok", "skipped")]
    print(f"[dryrun] done: {ok} ok, {sk} skipped, {len(bad)} failed")
    for r in bad:
        print("  FAILED:", r["arch"], r["shape"], r["mesh"], r.get("status"))
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=str(OUT_DEFAULT))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--timeout", type=int, default=3600)
    args = ap.parse_args(argv)
    out_dir = Path(args.out)
    mesh_kinds = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        orchestrate(mesh_kinds, out_dir, only_arch=args.arch, timeout=args.timeout)
        return 0
    if not (args.arch and args.shape):
        ap.error("--arch and --shape are required without --all")
    for mk in mesh_kinds:
        run_cell(args.arch, args.shape, mk, out_dir, smoke=args.smoke)
    return 0


if __name__ == "__main__":
    sys.exit(main())
