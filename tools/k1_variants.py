#!/usr/bin/env python3
"""Time variants of K1 (``kernels/dominance_scan/csrc/dominance_scan.cu``) on
one NVIDIA card, to show what each step of its design buys.

    python3 tools/k1_variants.py [--against OTHER.cu]

Each variant is the committed source with a few lines edited as text, built
by ``nvcc`` with the port's flags and timed as ``chip_smoke.py`` times K1 (L2
flushed, the card held busy while the call is enqueued; the indexed forms'
descriptors already on the card, so that only the kernel is timed) and under
``torch.profiler`` (the kernel's duration alone), on the real calls of the
50K cell (``chip_smoke.py`` phase 3's graph and queries): the loop probe's
indexed pairs (80 segments), the stacked probe's (one segment), the grouped
index's indexed groups (``group_size=16``, phase 3g), and the packed forms
on the same pairs gathered.  Every variant computes the same verdict and is
held to the plain version bit for bit:

  * as built (labels first; 8 warps a block; 8-byte loads; 1 packed stage);
  * labels not first: every pair reads its dominance rows;
  * 4 and 16 warps a block in the indexed kernel;
  * 4-byte loads: the paper's widths without the 8-byte vectors;
  * 2 and 3 stages a warp in the packed kernel (fewer warps).

``--against`` adds another source, timed in turns with the others: one
with these C entry points, or the first K1 design's (``dominance_scan_pairs``
with an int T and no device argument, no groups or indexed entry), which
then joins the packed pairs cell alone.  Exits non-zero without a card or if
a variant fails to build or differs from the plain version.
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

SOURCE = ROOT / "src/repro_torch/kernels/dominance_scan/csrc/dominance_scan.cu"

_VEC = "    if (vec) {\n      return launch_indexed<6, 3, 6, kGroups, true>"

# name → text edits
VARIANTS = {
    "as built": [],
    "labels not first": [("constexpr bool kLabelsFirst = true;",
                          "constexpr bool kLabelsFirst = false;")],
    "4 warps a block": [("constexpr int kIndexedWarps = 8;", "constexpr int kIndexedWarps = 4;")],
    "16 warps a block": [("constexpr int kIndexedWarps = 8;",
                          "constexpr int kIndexedWarps = 16;")],
    "4-byte loads": [(_VEC, _VEC.replace("if (vec)", "if (false)"))],
    "2 packed stages": [("constexpr int kPackedStages = 1;", "constexpr int kPackedStages = 2;")],
    "3 packed stages": [("constexpr int kPackedStages = 1;", "constexpr int kPackedStages = 3;")],
}


def variant_source(edits) -> str:
    text = SOURCE.read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"the source no longer holds {old[:60]!r} once: update the variant")
        text = text.replace(old, new)
    return text


def _bind(lib) -> None:
    """Bind the K1 entries; a library without the indexed entry has the first
    design's packed pairs entry (``lib.first_design``)."""
    i, i64, p, fl = ctypes.c_int, ctypes.c_int64, ctypes.c_void_p, ctypes.c_float
    lib.first_design = not hasattr(lib, "dominance_scan_indexed")
    entries = [("dominance_scan_pairs", [p] * 5 + [i, i, i, fl, p])]
    if not lib.first_design:
        entries = [("dominance_scan_pairs", [p] * 5 + [i64, i, i, fl, i, p]),
                   ("dominance_scan_groups", [p] * 6 + [i64, i, i, fl, i, p]),
                   ("dominance_scan_indexed", [p, i, p, i64] + [i] * 5 + [fl, i, p])]
    for name, args in entries:
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = ctypes.c_int, args


def build(tmp: Path, sources: dict) -> dict:
    """Every source built in parallel → {name: ctypes library}."""
    from repro_torch.kernels import build as kbuild

    jobs = {}
    for i, (name, text) in enumerate(sources.items()):
        src, lib = tmp / f"k1_{i}.cu", tmp / f"libk1_{i}.so"
        src.write_text(text)
        cmd = [kbuild._nvcc(), *kbuild.NVCC_FLAGS, "-o", str(lib), str(src)]
        jobs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                            text=True))
    libs = {}
    for name, (path, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name!r} did not build:\n{log}")
        libs[name] = ctypes.CDLL(str(path))
        _bind(libs[name])
    return libs


def real_calls(dev) -> dict:
    """The 50K cell's K1 calls, recorded as ``chip_smoke.py`` records them:
    {name: (segments, groups)}."""
    import dataclasses

    from chip_smoke import cell_50k_inputs, recorded_level_verdicts, recorded_verdicts
    from repro_torch.core import GnnPeEngine

    g, queries, cfg = cell_50k_inputs()
    eng = GnnPeEngine(cfg).build(g)
    loop = recorded_verdicts(lambda: eng.match_many(queries))
    eng.stacked_probe()
    stacked = recorded_verdicts(lambda: eng.match_many(queries, probe_impl="stacked"))
    eng_g = GnnPeEngine(dataclasses.replace(cfg, index_kind="grouped", group_size=16)).build(g)
    grouped = recorded_level_verdicts(lambda: eng_g.match_many(queries))
    return {
        "indexed pairs, loop probe": (loop[0][0][0], False),
        "indexed pairs, stacked probe": (max((a for a, _ in stacked),
                                             key=lambda a: sum(s.rows.numel() for s in a[0]))[0],
                                         False),
        "indexed groups, grouped loop probe": (grouped[0][1][0], True),
    }


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", type=Path, help="another K1 source to time in turns")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k1_variants: no CUDA device is available", file=sys.stderr)
        return 1
    from chip_smoke import (
        k1_bound_ms,
        k1_groups_bound_ms,
        k1_indexed_bound_ms,
        profiled_ms,
        time_ms,
    )
    from repro_torch.kernels.dominance_scan.ops import segment_layout
    from repro_torch.kernels.dominance_scan.ref import (
        dominance_scan_groups_indexed_ref,
        dominance_scan_pairs_indexed_ref,
        gather_group_operands,
        gather_pair_operands,
    )

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    sources = {name: variant_source(edits) for name, edits in VARIANTS.items()}
    if args.against is not None:
        sources[f"against {args.against.name}"] = args.against.read_text()
    eps = 1e-6
    stream = torch.cuda.current_stream().cuda_stream
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(Path(tmp), sources)
        cells = {}
        for name, (segs, groups) in real_calls(dev).items():
            lay = segment_layout(segs, groups)
            desc = torch.tensor(lay.words, dtype=torch.int64, device=dev)

            def indexed(lib, desc=desc, lay=lay, groups=groups, segs=segs):  # segs: alive
                out = torch.empty(lay.T, dtype=torch.bool, device=dev)
                rc = lib.dominance_scan_indexed(
                    desc.data_ptr(), lay.n_seg, out.data_ptr(), lay.T, lay.width, lay.tables,
                    lay.labels, int(groups), int(lay.vec), eps, dev.index or 0, stream)
                if rc != 0:
                    raise RuntimeError(f"launch failed: {rc}")
                return out

            plain = (dominance_scan_groups_indexed_ref if groups
                     else dominance_scan_pairs_indexed_ref)(segs, eps)
            cells[name] = (indexed, plain, k1_indexed_bound_ms(segs, groups), "indexed")
            if "stacked" in name:
                continue
            parts = [(gather_group_operands if groups else gather_pair_operands)(s) for s in segs]
            ops = [torch.cat([p[k] for p in parts]) for k in range(len(parts[0]))]
            T, D, D0 = ops[0].shape[0], ops[0].shape[1], ops[1].shape[1]

            def packed(lib, ops=ops, groups=groups, T=T, D=D, D0=D0):
                out = torch.empty(T, dtype=torch.bool, device=dev)
                fn = lib.dominance_scan_groups if groups else lib.dominance_scan_pairs
                where = (stream,) if lib.first_design else (dev.index or 0, stream)
                rc = fn(*[t.data_ptr() for t in ops], out.data_ptr(), T, D, D0, eps, *where)
                if rc != 0:
                    raise RuntimeError(f"launch failed: {rc}")
                return out

            bound = k1_groups_bound_ms(T, D, D0) if groups else k1_bound_ms(T, D, D0)
            kind = "packed groups" if groups else "packed pairs"
            cells[f"{kind}, the same pairs gathered"] = (packed, plain, bound, kind)
        flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)

        def takes(lib, kind: str) -> bool:
            return kind == "packed pairs" or not lib.first_design

        for cell, (fn, plain, _, kind) in cells.items():
            for name, lib in libs.items():
                if takes(lib, kind) and not torch.equal(fn(lib), plain):
                    raise AssertionError(f"variant {name!r} differs from the plain version: {cell}")
        print("K1 variants on the 50K cell's real calls: each bit-equal to the plain version; ms "
              "by events over two rounds (the second in reverse order), then by the profiler",
              flush=True)
        for cell, (fn, _, bound, kind) in cells.items():
            live = {n: lib for n, lib in libs.items() if takes(lib, kind)}
            times = {name: [] for name in live}
            for order in (list(live), list(live)[::-1]):
                for name in order:
                    times[name].append(time_ms(lambda: fn(live[name]), (), 20, flush))
            print(f"  {cell} (bound {bound[0]:.6f} ms, {bound[1]}):", flush=True)
            for name, ms in times.items():
                key = ("dominance_scan_pairs_kernel" if live[name].first_design
                       else f"dominance_scan_{kind.split()[0]}_kernel")
                prof = profiled_ms(lambda: fn(live[name]), (), key, flush)[0]
                note = "not measured" if prof != prof else \
                    f"{prof:.6f} ms ({bound[0] / prof * 100:.1f} % of the bound)"
                print(f"    {name}: {', '.join(f'{m:.6f}' for m in ms)} ms; profiler {note}",
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
