#!/usr/bin/env python3
"""Time variants of K2 (``kernels/merge_join/csrc/injectivity_mask.cu``) on
one NVIDIA card, to show what each step of its design buys.

    python3 tools/k2_variants.py [--against OTHER.cu]

Each variant is the committed source with a few lines edited as text (or
called with another layout flag), built by ``nvcc`` with the port's flags
and timed at two real join steps, rebuilt as ``chip_smoke.py`` rebuilds
them (the column slices of one contiguous table): the join-heavy batch's
largest step (``chip_smoke.py`` phase 5) and the 50K cell's median step
(phase 3).  Every variant computes the same verdict and is held to the
plain version bit for bit:

  * as built (16-byte ``cp.async`` granules, a ring of 3 tiles, at most
    two persistent blocks an SM, 4-byte stores);
  * the strided path forced on the contiguous table (4-byte words from
    each operand's rows);
  * 4-byte staging: the contiguous table staged in 4-byte words;
  * one stage instead of the ring;
  * byte stores: a thread stores its 4 verdicts byte by byte;
  * a non-persistent grid: one block a tile.

``--against`` adds another source with the C entry point of the parent
commit or this one, timed in turns with the others.  Each is timed in
``chip_smoke.py``'s three readings (L2 flushed by a write, by a read, and
with the operands just rewritten after the flush, as the join leaves
them), in two rounds that alternate the order, and once under
``torch.profiler`` (the kernel's own duration, read flush).  The events'
floor (no kernel, one trivial kernel) and the built kernel's marginal rate
(the largest step against the same rows twice over) put the readings in
scale.  Takes about 40 s with the builds.  Exits non-zero without a card or if a
variant fails to build or differs from the plain version.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

SOURCE = ROOT / "src/repro_torch/kernels/merge_join/csrc/injectivity_mask.cu"

# name → (text edits, the layout flag passed for the contiguous table)
VARIANTS = {
    "as built": ([], True),
    "strided path forced": ([], False),
    "4-byte staging": ([("const bool aligned = (reinterpret_cast<uintptr_t>(table) & 15) == 0;",
                         "const bool aligned = false;")], True),
    "one stage": ([("constexpr int kStages = 3;", "constexpr int kStages = 1;")], True),
    "byte stores": ([("  if (nvalid == 4 && (reinterpret_cast<uintptr_t>(p) & 3) == 0) {",
                      "  if (false) {")], True),
    "non-persistent grid": ([("const int64_t grid = n_tiles < most ? n_tiles : most;",
                              "const int64_t grid = n_tiles;")], True),
}


def variant_source(edits) -> str:
    text = SOURCE.read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"the source no longer holds {old[:60]!r} once: update the variant")
        text = text.replace(old, new)
    return text


def build(tmp: Path, sources: dict) -> dict:
    """Every source built in parallel → {name: (ctypes function, takes the layout flag)}."""
    from repro_torch.kernels import build as kbuild

    jobs = {}
    for i, (name, text) in enumerate(sources.items()):
        src, lib = tmp / f"k2_{i}.cu", tmp / f"libk2_{i}.so"
        src.write_text(text)
        cmd = [kbuild._nvcc(), *kbuild.NVCC_FLAGS, "-o", str(lib), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        # the parent commit's entry point takes neither the layout flag nor the device
        jobs[name] = (lib, proc, "int contiguous" in text)
    fns = {}
    for name, (path, proc, flagged) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name!r} did not build:\n{log}")
        fn = ctypes.CDLL(str(path)).injectivity_mask
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
                       ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int]
        fn.argtypes += [ctypes.c_int, ctypes.c_int] * flagged + [ctypes.c_void_p]
        fns[name] = (fn, flagged)
    return fns


def caller(fn, flagged: bool, contiguous: bool):
    """(old, new) → the variant's verdict, launched on the current stream."""
    import torch

    def run(old, new):
        out = torch.empty(old.shape[0], dtype=torch.bool, device=old.device)
        args = [old.data_ptr(), old.stride(0), new.data_ptr(), new.stride(0), out.data_ptr(),
                old.shape[0], old.shape[1], new.shape[1]]
        args += [int(contiguous), old.device.index] * flagged
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"launch failed: CUDA error {rc}")
        return out

    return run


def real_steps() -> dict:
    """The join-heavy batch's largest K2 step and the 50K cell's median one,
    from the engines ``chip_smoke.py`` phases 3 and 5 build → {cell: (old, new)}."""
    from chip_smoke import cell_50k_inputs, join_heavy_inputs, k2_steps
    from repro_torch.core import GnnPeEngine

    def rows(step):
        return step[0].shape[0]

    out = {}
    g, queries, cfg = join_heavy_inputs()
    old, new, _ = max(k2_steps(GnnPeEngine(cfg).build(g), queries), key=rows)
    out["join-heavy largest step"] = (old, new)
    g, queries, cfg = cell_50k_inputs()
    seen = sorted(k2_steps(GnnPeEngine(cfg).build(g), queries), key=rows)
    old, new, _ = seen[len(seen) // 2]
    out["50K cell median step"] = (old, new)
    return out


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", type=Path, help="another K2 source to time in turns")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k2_variants: no CUDA device is available", file=sys.stderr)
        return 1
    from chip_smoke import fmt_readings, k2_bound_ms, k2_readings, k2_table, profiled_ms, time_ms
    from repro_torch.kernels.merge_join.ref import injectivity_mask_ref

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    sources = {name: variant_source(edits) for name, (edits, _) in VARIANTS.items()}
    layout = {name: contiguous for name, (_, contiguous) in VARIANTS.items()}
    if args.against is not None:
        name = f"against {args.against.name}"
        sources[name], layout[name] = args.against.read_text(), True
    with tempfile.TemporaryDirectory() as tmp:
        fns = build(Path(tmp), sources)
        runs = {name: caller(fn, flagged, layout[name]) for name, (fn, flagged) in fns.items()}
        flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
        tiny = torch.zeros(4, dtype=torch.uint8, device=dev)
        floor = {
            "no kernel": time_ms(lambda: None, (), 50, flush, clean=True),
            "one 4-byte zero_ kernel": time_ms(tiny.zero_, (), 50, flush, clean=True),
        }
        print("the events' floor, L2 flushed by a read: "
              + "; ".join(f"{k} {v:.6f} ms" for k, v in floor.items()), flush=True)
        for cell, (old, new) in real_steps().items():
            table, ops = k2_table(old, new)
            T, Co, Cn = old.shape[0], old.shape[1], new.shape[1]
            want = injectivity_mask_ref(*ops)
            for name, run in runs.items():
                if not torch.equal(run(*ops), want):
                    raise AssertionError(f"variant {name!r} differs from the plain version: {cell}")
            bound = k2_bound_ms(T, Co, Cn)
            print(f"{cell}, T = {T}, Co = {Co}, Cn = {Cn} (bound {bound[0]:.3g} ms, {bound[1]}): "
                  "every variant bit-equal to the plain version; ms over two rounds (the second "
                  "in reverse order)", flush=True)
            readings = {name: [] for name in runs}
            for order in (list(runs), list(runs)[::-1]):
                for name in order:
                    readings[name].append(k2_readings(runs[name], table, ops, 30, flush))
            for name, (r1, r2) in readings.items():
                profiled, listed = profiled_ms(runs[name], ops, "injectivity_mask", flush)
                print(f"  {name}: {fmt_readings(r1, bound[0])} | {fmt_readings(r2, bound[0])} | "
                      f"torch.profiler {profiled:.6f} ms ({bound[0] / profiled * 100:.1f} %, "
                      f"{listed} of 20 launches listed)", flush=True)
            if cell != "join-heavy largest step":
                continue
            _, ops2 = k2_table(torch.cat([old, old]), torch.cat([new, new]))
            one = time_ms(runs["as built"], ops, 30, flush, clean=True)
            two = time_ms(runs["as built"], ops2, 30, flush, clean=True)
            rate = T * 4 * (Co + Cn) / ((two - one) * 1e-3) / 1e12
            print(f"  as built, marginal rate (read flush): {one:.6f} ms at T = {T}, {two:.6f} ms "
                  f"at 2T: {rate:.3f} TB/s over the extra rows' reads", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
