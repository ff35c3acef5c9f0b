#!/usr/bin/env python3
"""Time variants of K5 (``kernels/cross_interact/csrc/cross_interact.cu``) on
one NVIDIA card, to show where its time goes and why its tiles are what
they are.

    python3 tools/k5_variants.py

Each variant is the committed source with a few lines edited as text, built
by ``nvcc`` with the port's flags and timed as ``chip_smoke.py`` times K5
(L2 flushed, the card held busy while the call is enqueued) on the first
cross layer of ``serve_bulk`` (B = 262,144, D = 429; params and batch as
``chip_smoke.py`` draws them).  The variants that still compute the layer
are held to the plain version within rtol = atol = 1e-4; the others drop a
part of the work and say which:

  * as built;
  * BN = 144 (three column tiles at D = 429, four stages);
  * no stagger (odd blocks start with the others);
  * no epilogue (its loads and stores): the products fed by x and W;
  * no x loads and no epilogue: the tensor cores fed by W alone.

The variants that compute the layer are also timed at B = 512 and B = 1.
Exits non-zero without a card or if a variant fails to build.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

SOURCE = ROOT / "src/repro_torch/kernels/cross_interact/csrc/cross_interact.cu"

# the m64n144k8 instruction that the BN = 144 variant needs
_WGMMA_144 = '''
__device__ __forceinline__ void wgmma_tf32(float (&d)[72], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\\n.reg .pred p;\\nsetp.ne.b32 p, %77, 0;\\n"
      "wgmma.mma_async.sync.aligned.m64n144k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71"
      "}, {%72, %73, %74, %75}, %76, p, 1, 1;\\n}\\n"
      : F8(0), F8(8), F8(16), F8(24), F8(32), F8(40), F8(48), F8(56), F8(64)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
'''
_NO_X = ("    if (t < a.n_tiles) {\n      const int col", "    if (false) {\n      const int col")
# the accumulator stays live (ptxas would drop products nobody reads), nothing is written
_NO_EPILOGUE = ("    float* const sa = xw + st_last * (kXStage / 4);", """    {
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) sum += acc[i];
      if (sum == 1234.5f) a.out[0] = sum;
      continue;
    }
    float* const sa = xw + st_last * (kXStage / 4);""")

# name → (text edits, computes the layer)
VARIANTS = {
    "as built": ([], True),
    "BN = 144, 4 stages": ([
        ("constexpr int BN = 216;", "constexpr int BN = 144;"),
        ("constexpr int kStages = 3;", "constexpr int kStages = 4;"),
        ('static_assert(BN == 216, "wgmma_tf32 is written out for n = 216");', _WGMMA_144),
    ], True),
    "no stagger": ([("if ((blockIdx.x & 1) && a.n_col_tiles", "if (false && a.n_col_tiles")], True),
    "no epilogue": ([_NO_EPILOGUE], False),
    "no x loads, no epilogue": ([_NO_X, _NO_EPILOGUE], False),
}


def variant_source(edits) -> str:
    text = SOURCE.read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"the source no longer holds {old[:60]!r} once: update the variant")
        text = text.replace(old, new)
    return text


def build(tmp: Path) -> dict:
    """Every variant built in parallel → {name: ctypes library}."""
    from repro_torch.kernels import build as kbuild

    jobs = {}
    for i, (name, (edits, _)) in enumerate(VARIANTS.items()):
        src, lib = tmp / f"k5_{i}.cu", tmp / f"libk5_{i}.so"
        src.write_text(variant_source(edits))
        cmd = [kbuild._nvcc(), *kbuild.NVCC_FLAGS, "-o", str(lib), str(src)]
        jobs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                            text=True))
    libs = {}
    for name, (path, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name!r} did not build:\n{log}")
        lib = ctypes.CDLL(str(path))
        lib.cross_interact_prep.restype = lib.cross_interact.restype = ctypes.c_int
        lib.cross_interact_prep.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p]
        lib.cross_interact.argtypes = [ctypes.c_void_p] * 5 + [
            ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
        libs[name] = lib
    return libs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("k5_variants: no CUDA device is available", file=sys.stderr)
        return 1
    from chip_smoke import k5_bound_ms, time_ms
    from repro_torch.configs import get_arch, init_params, make_batch, resolve_config
    from repro_torch.kernels.cross_interact.kernel import kpad
    from repro_torch.kernels.cross_interact.ref import cross_interact_ref

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(Path(tmp))
        # serve_bulk's first cross layer: x0 = [log1p|dense|, the 26 fields' embeddings]
        arch = get_arch("dcn-v2")
        cell = arch.cell("serve_bulk")
        cfg = resolve_config(arch, cell, smoke=False)
        params = init_params(arch, cfg, seed=0, device=dev)
        batch = make_batch(arch, cell, cfg, seed=2, smoke=False, device=dev)
        fields = torch.arange(cfg.n_sparse, device=dev)[None, :]
        emb = params["tables"][fields, batch["sparse"].long()].reshape(batch["sparse"].shape[0], -1)
        x0 = torch.cat([torch.log1p(batch["dense"].abs()), emb], 1).contiguous()
        w, b = params["cross"][0]["w"], params["cross"][0]["b"]
        del params, batch, emb
        B, D = x0.shape
        wt = torch.empty((2, D, kpad(D)), dtype=torch.float32, device=dev)
        flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)

        def run(lib, x):
            stream = torch.cuda.current_stream().cuda_stream
            out = torch.empty_like(x)
            rc = lib.cross_interact_prep(w.data_ptr(), wt.data_ptr(), D, stream) or \
                lib.cross_interact(x.data_ptr(), x.data_ptr(), wt.data_ptr(), b.data_ptr(),
                                   out.data_ptr(), x.shape[0], D, stream)
            if rc != 0:
                raise RuntimeError(f"launch failed: {rc}")
            return out

        want = cross_interact_ref(x0, x0, w, b)
        bound = k5_bound_ms(B, D)[0]
        print(f"K5 variants at B = {B}, D = {D} (serve_bulk's first cross layer); bound "
              f"{bound:.6f} ms; ms over two rounds", flush=True)
        for name, (_, exact) in VARIANTS.items():
            if exact:
                got = run(libs[name], x0)
                ok = torch.allclose(got, want, rtol=1e-4, atol=1e-4)
                if not ok:
                    raise AssertionError(f"variant {name!r} differs from the plain version")
        times = {name: [] for name in VARIANTS}
        for _ in range(2):
            for name, lib in libs.items():
                times[name].append(time_ms(lambda x: run(lib, x), (x0,), 10, flush))
        for name, ms in times.items():
            print(f"  {name}: {', '.join(f'{m:.4f}' for m in ms)} ms "
                  f"({min(ms) / bound:.2f}x the bound)", flush=True)
        for rows in (512, 1):
            x = x0[:rows].contiguous()
            for name, (_, exact) in VARIANTS.items():
                if exact:
                    ms = time_ms(lambda x: run(libs[name], x), (x,), 50, flush)
                    print(f"  B = {rows}, {name}: {ms:.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
