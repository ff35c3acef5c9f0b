"""Invariant auditor for a live engine: an offline CLI or a server admin call.

Three families of checks, per (sampled) partition, on the engine's own
tensors where they live:

* **index reconstruction**: the packed forest's levels, the int8 and
  label-hash sidecar and the GNN-PGE group bounds must equal a from-scratch
  ``build_index`` / ``attach_groups`` over the partition's own leaf
  payload (bit rot in an MBR, a group bound or a sidecar can silently
  widen or narrow pruning, and narrowing breaks no-false-dismissal);
* **delta bookkeeping**: the tombstone count kept on the host must match
  the mask, and the buffer's tensors must agree on their row count;
* **tombstone / delta consistency**: the live rows (``main ∪ delta −
  tombstones``) must equal a fresh ``enumerate_paths`` of the current
  graph over the partition's members, the two sides disjoint: the exact
  soundness invariant of the delta decomposition.

``scrub_engine`` returns the JAX package's report dict.

    python -m repro_torch.durability.scrub --dir D [--sample N] [--seed S] [--device cpu]

recovers an engine from a durability directory (its config rides in the
snapshot) on the card, or on the CPU with ``--device cpu``, audits it,
prints the report and exits 0 when it is clean, 1 otherwise.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..core.grouping import attach_groups
from ..core.index import build_index
from ..core.paths import enumerate_paths
from ..obs.metrics import REGISTRY

__all__ = ["scrub_engine", "main"]

_M_RUNS = REGISTRY.counter("gnnpe_scrub_runs_total", "scrub passes", labels=("outcome",))
_M_VIOLATIONS = REGISTRY.counter("gnnpe_scrub_violations_total", "scrub violations found")


def _same(a, b) -> bool:
    return (a is None) == (b is None) and (a is None or torch.equal(a, b))


def _check_index(mi: int, index, labels: torch.Tensor, out: list) -> None:
    quantized = index.emb_q is not None
    rebuilt = build_index(
        index.paths,
        index.emb,
        index.emb0,
        index.emb_multi,
        block_size=index.block_size,
        fanout=index.fanout,
        quantize=quantized,
        path_labels=labels[index.paths] if quantized and index.n_paths else None,
    )
    if len(rebuilt.levels) != len(index.levels):
        out.append({"partition": mi, "check": "levels", "detail": "level count differs"})
        return
    for li, (a, b) in enumerate(zip(index.levels, rebuilt.levels)):
        for k in ("mbr", "mbr0", "mbr_multi"):
            if not torch.equal(a[k], b[k]):
                out.append(
                    {"partition": mi, "check": "mbr",
                     "detail": f"level {li} {k} differs from recomputation"}
                )
    for k in ("emb_q", "label_hash"):
        if not _same(getattr(index, k), getattr(rebuilt, k)):
            out.append({"partition": mi, "check": "sidecar", "detail": f"{k} differs"})
    if index.groups is not None:
        attach_groups(rebuilt, index.groups.group_size)
        for k in ("group_start", "mbr_hi", "mbr0", "block_group_start"):
            if not torch.equal(getattr(index.groups, k), getattr(rebuilt.groups, k)):
                out.append(
                    {"partition": mi, "check": "groups", "detail": f"groups.{k} differs"}
                )


def _check_delta(mi: int, dp, out: list) -> None:
    n_mask = int(dp.tombstone.sum())
    if n_mask != dp.n_tomb:
        out.append(
            {"partition": mi, "check": "tombstone",
             "detail": f"n_tomb {dp.n_tomb} != mask sum {n_mask}"}
        )
    B = dp.n_rows
    for k in ("emb", "emb0"):
        if getattr(dp, k).shape[0] != B:
            out.append(
                {"partition": mi, "check": "delta", "detail": f"buffer {k} rows != paths rows"}
            )
    if dp.emb_multi.shape[1] != B:
        out.append({"partition": mi, "check": "delta", "detail": "emb_multi rows != paths rows"})


def _rows(paths: torch.Tensor) -> set:
    return {tuple(r) for r in paths.cpu().numpy().tolist()}


def _check_enumeration(mi: int, engine, model, dp, out: list) -> None:
    paths = model.index.paths
    live = paths[~dp.tombstone] if model.index.n_paths else paths
    main_set = _rows(live)
    delta_set = _rows(dp.paths)
    if main_set & delta_set:
        out.append(
            {"partition": mi, "check": "enumerate",
             "detail": f"{len(main_set & delta_set)} paths in both main and delta"}
        )
    expect_set = _rows(
        enumerate_paths(engine.dgraph, model.members.astype(np.int32), engine.cfg.path_length)
    )
    got = main_set | delta_set
    if got != expect_set:
        out.append(
            {"partition": mi, "check": "enumerate",
             "detail": f"live view has {len(got - expect_set)} phantom / "
                       f"{len(expect_set - got)} missing paths vs fresh enumerate"}
        )


def scrub_engine(engine, sample: int | None = None, seed: int = 0) -> dict:
    """Audit ``engine`` → report dict.

    ``sample``: audit only that many randomly chosen partitions (the
    enumerate check re-enumerates a partition's paths, so full scrubs of
    big graphs are an offline affair); ``None`` audits all of them.
    """
    t0 = time.perf_counter()
    n = len(engine.models)
    picks = list(range(n))
    if sample is not None and sample < n:
        picks = sorted(np.random.default_rng(seed).choice(n, size=sample, replace=False))
    violations: list = []
    for mi in picks:
        model = engine.models[mi]
        dp = engine.delta.parts[mi]
        _check_index(mi, model.index, engine.dgraph.labels, violations)
        _check_delta(mi, dp, violations)
        _check_enumeration(mi, engine, model, dp, violations)
    report = {
        "ok": not violations,
        "violations": violations,
        "partitions_checked": [int(i) for i in picks],
        "epoch": int(engine.epoch),
        "scrub_s": time.perf_counter() - t0,
    }
    _M_RUNS.labels(outcome="ok" if report["ok"] else "violations").inc()
    if violations:
        _M_VIOLATIONS.inc(len(violations))
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="offline scrub of a durability directory")
    ap.add_argument("--dir", required=True, help="DurabilityConfig.directory")
    ap.add_argument("--sample", type=int, default=None, help="partitions to sample")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="where to recover: the card (default) or cpu")
    args = ap.parse_args(argv)
    from .recovery import recover_engine_from_dir

    engine, info = recover_engine_from_dir(args.dir, device=args.device)
    report = scrub_engine(engine, sample=args.sample, seed=args.seed)
    report["recovered_epoch"] = info["epoch"]
    print(json.dumps(report, indent=2))
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
