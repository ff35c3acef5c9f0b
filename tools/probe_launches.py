#!/usr/bin/env python3
"""Count the kernel launches and the card's busy time of one warm
``match_many`` on the 50K cell, for the probe forms that run K1: the loop
probe, the grouped loop probe and the stacked probe (host join).

    python3 tools/probe_launches.py [--repo DIR]

``--repo`` runs another checkout's engine (its ``src/`` and its
``chip_smoke.py``, which must hold ``cell_50k_inputs`` and
``profile_counts``), for instance the parent commit's unpacked by ``git
archive``, so that two commits can be compared in turns on one card.  Each
form: a cold and a warm batch, three warm batches on the host clock, then
one under ``torch.profiler`` (launches, device-to-host copies, busy ms).
Exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import dataclasses
import subprocess
import sys
import time
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo", type=Path, default=Path(__file__).resolve().parents[1])
    args = ap.parse_args()
    root = args.repo.resolve()
    sys.path[:0] = [str(root / "src"), str(root)]
    import torch

    if not torch.cuda.is_available():
        print("probe_launches: no CUDA device is available", file=sys.stderr)
        return 1
    from chip_smoke import cell_50k_inputs, profile_counts
    from repro_torch.core import GnnPeEngine

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    g, queries, cfg = cell_50k_inputs()
    eng = GnnPeEngine(cfg).build(g)
    eng_g = GnnPeEngine(dataclasses.replace(cfg, index_kind="grouped", group_size=16)).build(g)
    forms = {
        "loop probe": lambda: eng.match_many(queries),
        "grouped loop probe": lambda: eng_g.match_many(queries),
        "stacked probe": lambda: eng.match_many(queries, probe_impl="stacked"),
    }
    print(f"{root.name}: {smi}", flush=True)
    for name, fn in forms.items():
        want = fn()
        fn()
        warm = []
        for _ in range(3):
            t = time.perf_counter()
            got = fn()
            torch.cuda.synchronize()
            warm.append((time.perf_counter() - t) * 1e3)
            if got != want:
                raise AssertionError(f"{name}: a warm batch's lists differ from the cold batch's")
        prof = profile_counts(fn, dev)
        print(f"  {name}: warm {', '.join(f'{w:.3f}' for w in warm)} ms; profiled "
              f"{prof['wall']:.3f} ms wall, device busy {prof['busy']:.3f} ms in "
              f"{prof['launches']} kernel launches, {prof['dtoh']} device-to-host copies",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
