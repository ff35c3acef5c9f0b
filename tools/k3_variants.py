#!/usr/bin/env python3
"""Time variants of K3 (``kernels/dominance_scan/csrc/dominance_scan.cu``) on
one NVIDIA card, to show what each step of its design buys.

    python3 tools/k3_variants.py [--against OTHER.cu]

Each variant is the committed source with a few lines edited as text, built
by ``nvcc`` with the port's flags and timed as ``chip_smoke.py`` times K3 (L2
flushed, the card held busy while the call is enqueued) over the 50K cell's
real index (``chip_smoke.py`` phase 3's graph, engine and plan paths:
N = 766,664 rows, D = 18, D0 = 6, Q = 70 queries of partition 0).  Every
variant but the last two computes the same verdict and is held to the plain
version bit for bit:

  * as built (12 warps, one tile in flight a warp);
  * 8 warps with 2 stages, 4 warps with 4 (deeper rings, fewer warps);
  * one vote: no warp vote after the first label column, only after all;
  * no votes: every cell pays its dominance compares;
  * byte stores: a lane stores its 4 verdicts of a query byte by byte;
  * copy after deciding: the next tile's copy starts once this tile is
    decided, so nothing overlaps inside a warp;
  * e + eps per cell: the add is not hoisted out of the query loop;
  * a warp vote after dominance column 6, or after columns 4 and 10;
  * the parts alone: decided but not stored, and copies with zero stores.

``--against`` adds another source with the same C entry points (for
instance the parent commit's), timed in turns with the others.  Each
variant is timed on K3-batch over the real index, on the same operands with
every label equal (no vote skips), and on K3-single, in two rounds that
alternate the variants; those that compute the verdict also with L2
flushed by a read (clean lines) instead of ``chip_smoke.py``'s write (dirty
lines that the kernel's reads must write back first).  Exits non-zero
without a card or if a variant fails to build or differs from the plain
version.
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

_FIRST_VOTE = """    for (int i = 0; i < 4; ++i) keep[i] &= label_match(a[0], e0v[i * CD0], eps);
    if (!__any_sync(kAll, keep[0] | keep[1] | keep[2] | keep[3])) return 0;
"""
_LAST_VOTE = (
    "      for (int i = 0; i < 4; ++i) keep[i] &= label_match(a[j], e0v[i * CD0 + j], eps);\n"
    "    }\n"
    "    if (!__any_sync(kAll, keep[0] | keep[1] | keep[2] | keep[3])) return 0;\n"
)
_VOTE_OFF = ("    if (!__any_sync", "    if (false && !__any_sync")
_DOM = """    for (int i = 0; i < 4; ++i) keep[i] &= b[j] <= ev[i * CD + j];
  }
"""
_HOIST = "ev[f] = f % CD < w ? __fadd_rn(ev[f], eps) : inf();"
_CELL = "keep[i] &= b[j] <= ev[i * CD + j];"
_NEXT = "          stage_job(job + kStages);\n"
_AFTER_DECIDE = """            put<true>(o, decide<CD, CD0>(qc, ev, e0v, w0, eps), nvalid);
          }
        }
"""
_PUT = "put<false>(o, decide<CD, CD0>(qc, ev, e0v, w0, eps), nvalid);"
_REGS = "  float ev[4 * CD], e0v[4 * CD0];\n"
_END = "      }\n    }\n  }\n}\n\nconstexpr int kDefaultSmem"
_WORD = "  if (nvalid == 4 && (reinterpret_cast<uintptr_t>(p) & 3) == 0) {"


def _shape(warps: int, stages: int):
    return [("constexpr int kWarps = 12;", f"constexpr int kWarps = {warps};"),
            ("constexpr int kStages = 1;", f"constexpr int kStages = {stages};")]


def _dom_vote(*cols):
    when = " || ".join(f"j == {c - 1}" for c in cols)
    vote = (f"    if (({when}) && !__any_sync(kAll, keep[0] | keep[1] | keep[2] | keep[3])) "
            "return 0;\n")
    return [(_DOM, _DOM.replace("  }\n", vote + "  }\n"))]


# name → (text edits, computes the verdict)
VARIANTS = {
    "as built": ([], True),
    "8 warps, 2 stages": (_shape(8, 2), True),
    "4 warps, 4 stages": (_shape(4, 4), True),
    "one vote": ([(_FIRST_VOTE, _FIRST_VOTE.replace(*_VOTE_OFF))], True),
    "no votes": ([(_FIRST_VOTE, _FIRST_VOTE.replace(*_VOTE_OFF)),
                  (_LAST_VOTE, _LAST_VOTE.replace(*_VOTE_OFF))], True),
    "byte stores": ([(_WORD, "  if (false) {")], True),
    "copy after deciding": ([
        (_NEXT, ""),
        (_AFTER_DECIDE,
         _AFTER_DECIDE + "        if (nc > 1 || qt == 0) stage_job(job - 1 + kStages);\n"),
    ], True),
    "e + eps per cell": ([
        (_HOIST, "ev[f] = f % CD < w ? ev[f] : inf();"),
        (_CELL, "keep[i] &= dominated(b[j], ev[i * CD + j], eps);"),
    ], True),
    "dominance vote after column 6": (_dom_vote(6), True),
    "dominance votes after columns 4, 10": (_dom_vote(4, 10), True),
    "decided, not stored": ([
        (_PUT, "sink |= decide<CD, CD0>(qc, ev, e0v, w0, eps);"),
        (_REGS, _REGS + "  uint32_t sink = 0;\n"),
        (_END, _END.replace("  }\n}\n", "  }\n  if (sink == 0x12345678u) out[0] = 1;\n}\n", 1)),
    ], False),
    "copies and zero stores": ([(_PUT, "put<false>(o, 0u, nvalid);")], False),
}


def variant_source(edits) -> str:
    text = SOURCE.read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"the source no longer holds {old[:60]!r} once: update the variant")
        text = text.replace(old, new)
    return text


def build(tmp: Path, sources: dict) -> dict:
    """Every source built in parallel → {name: ctypes library}."""
    from repro_torch.kernels import build as kbuild

    jobs = {}
    for i, (name, text) in enumerate(sources.items()):
        src, lib = tmp / f"k3_{i}.cu", tmp / f"libk3_{i}.so"
        src.write_text(text)
        cmd = [kbuild._nvcc(), *kbuild.NVCC_FLAGS, "-o", str(lib), str(src)]
        jobs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                            text=True))
    libs = {}
    for name, (path, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name!r} did not build:\n{log}")
        lib = ctypes.CDLL(str(path))
        lib.dominance_scan.restype = lib.dominance_scan_batch.restype = ctypes.c_int
        lib.dominance_scan.argtypes = [ctypes.c_void_p] * 5 + [
            ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
        lib.dominance_scan_batch.argtypes = [ctypes.c_void_p] * 5 + [
            ctypes.c_int, ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.c_void_p]
        libs[name] = lib
    return libs


def real_index(dev):
    """The 50K cell's index and partition 0's plan-path query rows, as
    ``chip_smoke.py`` phase 3 builds them."""
    from chip_smoke import cell_50k_inputs, dense_scan_check
    from repro_torch.core import GnnPeEngine

    g, queries, cfg = cell_50k_inputs()
    eng = GnnPeEngine(cfg).build(g)
    qm, q0m, e_all, e0_all, _, _ = dense_scan_check(eng, queries, dev)
    return qm, q0m, e_all, e0_all


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", type=Path, help="another K3 source to time in turns")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k3_variants: no CUDA device is available", file=sys.stderr)
        return 1
    from chip_smoke import k3_bound_ms, time_ms
    from repro_torch.kernels.dominance_scan.ref import dominance_scan_batch_ref, dominance_scan_ref

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    sources = {name: variant_source(edits) for name, (edits, _) in VARIANTS.items()}
    exact = {name: ok for name, (_, ok) in VARIANTS.items()}
    if args.against is not None:
        sources[f"against {args.against.name}"] = args.against.read_text()
        exact[f"against {args.against.name}"] = True
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(Path(tmp), sources)
        qm, q0m, e_all, e0_all = real_index(dev)
        N, D = e_all.shape
        Q, D0 = q0m.shape
        flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
        stream = torch.cuda.current_stream().cuda_stream

        def batch(lib, q, q0, e, e0):
            out = torch.empty((q.shape[0], N), dtype=torch.bool, device=dev)
            rc = lib.dominance_scan_batch(q.data_ptr(), q0.data_ptr(), e.data_ptr(), e0.data_ptr(),
                                          out.data_ptr(), q.shape[0], N, D, D0, 1e-6, stream)
            if rc != 0:
                raise RuntimeError(f"launch failed: {rc}")
            return out

        def single(lib, q, q0, e, e0):
            out = torch.empty(N, dtype=torch.bool, device=dev)
            rc = lib.dominance_scan(q.data_ptr(), q0.data_ptr(), e.data_ptr(), e0.data_ptr(),
                                    out.data_ptr(), N, D, D0, 1e-6, stream)
            if rc != 0:
                raise RuntimeError(f"launch failed: {rc}")
            return out

        q1, q01 = qm[0].contiguous(), q0m[0].contiguous()
        cells = {
            f"K3-batch, Q = {Q}, real index": (
                batch, (qm, q0m, e_all, e0_all), k3_bound_ms(Q, N, D, D0)),
            f"K3-batch, Q = {Q}, all labels matching": (
                batch, (qm, torch.zeros_like(q0m), e_all, torch.zeros_like(e0_all)),
                k3_bound_ms(Q, N, D, D0)),
            "K3-single, real index": (single, (q1, q01, e_all, e0_all), k3_bound_ms(1, N, D, D0)),
        }
        for cell, (fn, ops, _) in cells.items():
            plain = (dominance_scan_batch_ref if fn is batch else dominance_scan_ref)(*ops)
            for name, lib in libs.items():
                if exact[name] and not torch.equal(fn(lib, *ops), plain):
                    raise AssertionError(f"variant {name!r} differs from the plain version: {cell}")
        print(f"K3 variants at N = {N}, D = {D}, D0 = {D0}: each bit-equal to the plain version; "
              "ms over two rounds (the second in reverse order)", flush=True)
        for cell, (fn, ops, bound) in cells.items():
            times = {name: [] for name in libs}
            for order in (list(libs), list(libs)[::-1]):
                for name in order:
                    times[name].append(time_ms(lambda *a: fn(libs[name], *a), ops, 20, flush))
            print(f"  {cell} (bound {bound[0]:.6f} ms, {bound[1]}):", flush=True)
            for name, ms in times.items():
                print(f"    {name}: {', '.join(f'{m:.6f}' for m in ms)} ms "
                      f"({bound[0] / min(ms) * 100:.1f} % of the bound)", flush=True)
            for name in [n for n in libs if exact[n]]:
                ms = [time_ms(lambda *a: fn(libs[name], *a), ops, 20, flush, clean=True)
                      for _ in range(2)]
                print(f"    {name}, L2 flushed by a read: {', '.join(f'{m:.6f}' for m in ms)} ms "
                      f"({bound[0] / min(ms) * 100:.1f} % of the bound)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
