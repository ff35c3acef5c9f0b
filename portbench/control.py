#!/usr/bin/env python3
"""Read the control of a cell's comparison at the cell's own size.

    python3 portbench/control.py --workload <cell> --seconds <s> --seeds <n> [<n> ...]

The control is the plain reference put in the program's place with one
guarantee broken: it holds only a spanning tree of each query's edges,
as a matcher that skips the refine of the non-tree edges would
(``pb_harness.ControlProgram``).  Each seed makes the cell's own graph
and pool, drives the closed loop for ``--seconds`` and compares as a
run does; a sound comparison reads the control as not correct.  The
benchmark's runs never run this; it needs no card.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)

    import pb_harness
    import pb_manifest

    cell = pb_manifest.cell(args.workload)
    for seed in args.seeds:
        result, rec = pb_harness.run(cell, seed, args.seconds, False, time.perf_counter(),
                                     program=pb_harness.ControlProgram())
        print(json.dumps({"workload": args.workload, "seed": seed, "answered": rec.queries,
                          "correct": result["correct"], "compared": result["compared"]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
