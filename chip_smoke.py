#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, each printing its seconds:

  1. build every CUDA kernel of the port from ``src/`` (one ``nvcc`` per
     source, all at once) and print the card's name and power limit;
  2. hold each kernel against its plain PyTorch version on the card,
     bit for bit, on seeded pairs with ties at eps and +inf / NaN rows;
  3. the main path at paper scale: ``GnnPeEngine.build`` then
     ``match_many`` on a 50K-vertex NWS graph in 80 partitions with 16
     queries of 8 vertices; every match set must equal VF2's, the kernel
     must have run on that path, and its verdict on the real probe's pairs
     must equal the plain version's; the kernel is timed there;
  4. the GAT encoder, trained on the card, on a 2,000-vertex graph.

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

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, args, reps: int, flush) -> float:
    """Mean device ms of ``fn(*args)``, with L2 flushed before each call
    (the main path gathers fresh operands that mostly miss L2)."""
    import torch

    for _ in range(3):
        fn(*args)
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def k1_bound_ms(T: int, D: int, D0: int) -> tuple[float, str]:
    """Least time for T pairs: bytes (inputs once, 1-byte output) vs fp32 ops."""
    bytes_ms = (T * 4 * (2 * D + 2 * D0) + T) / HBM_BYTES_PER_S * 1e3
    ops_ms = T * (2 * D + 3 * D0) / FP32_OPS_PER_S * 1e3  # add+cmp, sub+abs+cmp
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1

    from repro_torch.core import GnnPeConfig, GnnPeEngine, TrainConfig, vf2_match
    from repro_torch.core import index as index_mod
    from repro_torch.graphs import newman_watts_strogatz, random_connected_query
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels.dominance_scan import ops as k1
    from repro_torch.kernels.dominance_scan.ref import dominance_scan_pairs_ref, make_pairs

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

    # ---- phase 2: each kernel against its plain version ------------------
    t = time.perf_counter()
    max_err = 0.0
    for T in (1, 1000, (1 << 20) + 7):
        args = [torch.from_numpy(a).to(dev) for a in make_pairs(T, seed=T)]
        got = k1.dominance_scan_pairs(*args)
        want = dominance_scan_pairs_ref(*args)
        torch.cuda.synchronize()
        err = float((got.int() - want.int()).abs().max())
        max_err = max(max_err, err)
        if not torch.equal(got, want):
            raise AssertionError(f"K1 differs from its plain version at T={T}")
        log(f"K1 T={T}: bit-equal to the plain version, kept {int(got.sum())}")
    log(f"phase 2 kernels vs plain versions: {time.perf_counter() - t:.3f} s")

    # ---- phase 3: the main path at paper scale ---------------------------
    t = time.perf_counter()
    g = newman_watts_strogatz(50_000, k=4, p=0.1, n_labels=100, seed=11)
    queries = [random_connected_query(g, 8, seed=42 + s) for s in range(16)]
    cfg = GnnPeConfig(n_partitions=80, encoder="monotone", train=TrainConfig(max_epochs=150))
    k1.LAUNCHES = 0  # counts from here to the end of the cold match_many
    pairs_before = index_mod.PAIR_METRIC.get(kind="leaf_pairs")
    t_build = time.perf_counter()
    eng = GnnPeEngine(cfg).build(g)
    build_s = time.perf_counter() - t_build
    t_cold = time.perf_counter()
    matches = eng.match_many(queries)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t_cold
    launches = k1.LAUNCHES
    leaf_pairs = int(index_mod.PAIR_METRIC.get(kind="leaf_pairs") - pairs_before)
    if launches == 0:
        raise AssertionError("match_many never launched the K1 kernel")
    warm_ms = []
    for _ in range(3):
        t_w = time.perf_counter()
        again = eng.match_many(queries)
        torch.cuda.synchronize()
        warm_ms.append((time.perf_counter() - t_w) * 1e3)
        if again != matches:
            raise AssertionError("warm match_many differs from the cold run")
    # the real probe's verdict, recorded and re-run through the plain version
    seen = []
    keep_mask = index_mod._pairs_keep_mask

    def record(*a):
        out = keep_mask(*a)
        seen.append((a, out))
        return out

    index_mod._pairs_keep_mask = record
    try:
        eng.match_many(queries)
    finally:
        index_mod._pairs_keep_mask = keep_mask
    if len(seen) != 1:
        raise AssertionError(f"expected one fused verdict per match_many, saw {len(seen)}")
    (qg, q0g, eg, e0g, eps), keep = seen[0]
    plain = dominance_scan_pairs_ref(qg, q0g, eg, e0g, eps)
    if not torch.equal(keep, plain):
        raise AssertionError("K1 on the real probe's pairs differs from the plain version")
    # where a warm batch's time goes: host-clock stages and device-busy time
    with torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    ) as prof:
        t_p = time.perf_counter()
        _, qstats = eng.match_many(queries, return_stats=True)
        torch.cuda.synchronize()
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
    k1_ms = time_ms(k1.dominance_scan_pairs, (qg, q0g, eg, e0g, eps), 50, flush)
    plain_ms = time_ms(dominance_scan_pairs_ref, (qg, q0g, eg, e0g, eps), 50, flush)
    bound_ms, bound_by = k1_bound_ms(T, D, D0)
    t_vf2 = time.perf_counter()
    n_matches = 0
    for qi, (q, got) in enumerate(zip(queries, matches)):
        want = vf2_match(g, q)
        if set(got) != set(want) or len(got) != len(want):
            raise AssertionError(f"query {qi}: {len(got)} matches, VF2 finds {len(want)}")
        n_matches += len(got)
    log(f"VF2 check of 16 queries: {time.perf_counter() - t_vf2:.3f} s, {n_matches} matches")
    log(f"paths indexed: {eng.offline_stats['n_paths']}")
    log(f"leaf pairs (cold match_many): {leaf_pairs}; fused verdict T = {T}, D = {D}, D0 = {D0}")
    log(f"build: {build_s:.3f} s (train {eng.offline_stats['train_time']:.3f}, "
        f"embed {eng.offline_stats['embed_time']:.3f}, index {eng.offline_stats['index_time']:.3f})")
    log(f"match_many cold: {cold_s * 1e3:.3f} ms; warm: {', '.join(f'{m:.3f}' for m in warm_ms)} ms")
    log(f"K1 launches on the main path (build + cold match_many): {launches}")
    log(f"K1 at T={T}: {k1_ms:.6f} ms, bound {bound_ms:.6f} ms ({bound_by}), "
        f"plain version {plain_ms:.6f} ms")
    log(f"phase 3 main path, 50K vertices / 80 partitions: {time.perf_counter() - t:.3f} s")

    # ---- phase 4: the GAT encoder, trained on the card -------------------
    t = time.perf_counter()
    g2 = newman_watts_strogatz(2_000, k=4, p=0.1, n_labels=100, seed=11)
    cfg2 = GnnPeConfig(n_partitions=2, encoder="gat", train=TrainConfig(max_epochs=150))
    k1.LAUNCHES = 0
    eng2 = GnnPeEngine(cfg2).build(g2)
    queries2 = [random_connected_query(g2, 6, seed=7 + s) for s in range(4)]
    for qi, (q, got) in enumerate(zip(queries2, eng2.match_many(queries2))):
        want = vf2_match(g2, q)
        if set(got) != set(want) or len(got) != len(want):
            raise AssertionError(f"gat query {qi}: {len(got)} matches, VF2 finds {len(want)}")
    if k1.LAUNCHES == 0:
        raise AssertionError("the GAT engine's match_many never launched the K1 kernel")
    log(f"gat: epochs {[m.train_epochs for m in eng2.models]}, "
        f"fallback vertices {[m.n_fallback for m in eng2.models]}, "
        f"train {eng2.offline_stats['train_time']:.3f} s")
    log(f"phase 4 gat, 2K vertices / 2 partitions: {time.perf_counter() - t:.3f} s")

    record_k1 = {
        "name": "dominance_scan_pairs",
        "route": "cuda",
        "source": "src/repro_torch/kernels/dominance_scan/csrc/dominance_scan.cu",
        "replaces": "src/repro/kernels/dominance_scan/kernel.py:98",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": k1_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,  # no single PyTorch call computes this verdict
    }
    print(json.dumps({"kernels": [record_k1]}))
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
