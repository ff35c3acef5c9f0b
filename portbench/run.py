#!/usr/bin/env python3
"""Run one cell of the port's benchmark on this machine's card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  The cell, its configuration and its
traffic mix are found by name through ``BENCHMARK.json``; the program is
``repro_torch`` from ``src/``.  Progress and the numbers compared go to
standard error, the numbers compared last; the last line of standard
output is the result, one JSON object.  Exits non-zero, printing no
result, without enough CUDA cards, or if a module of JAX or of the JAX
package ``repro`` was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent / "src")]
# One host thread: the program's host side is serial Python, and the
# worker threads of OpenMP and BLAS only spin beside it, taking cores of
# a shared host (set before numpy or torch is imported).
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import pb_harness
    import pb_manifest

    cell = pb_manifest.cell(args.workload)
    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {cell.chips} CUDA card(s), found {n}",
              file=sys.stderr)
        return 3
    torch.cuda.init()
    result, _ = pb_harness.run(cell, args.seed, args.seconds, bool(args.trace), T_START)
    found = pb_harness.forbidden_modules()
    if found:
        print(f"portbench: modules of {', '.join(found)} were loaded in the run", file=sys.stderr)
        return 4
    for name, v in result["compared"].items():
        bound = f"limit {v['limit']}" if "limit" in v else f"at least {v['at_least']}"
        print(f"compared {name} {v['value']} ({bound})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
