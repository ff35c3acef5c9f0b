#!/usr/bin/env python3
"""Audit the host waits of one benchmark batch: every synchronizing CUDA
call PyTorch reports inside ``match_many``, against the program's own
count of them (``QueryTrace.counts["host_syncs"]``).

    python3 tools/sync_audit.py --workload pe50k.q8 [--seed N] [--batches 1] \
        [--engine probe_impl=loop ...]

On the card only.  The cell is built as ``portbench/run.py`` builds it
(its graph, pool, engine settings, less any ``--engine`` override, and
warm-up batches); then each audited
batch runs under an obs trace with ``torch.cuda.set_sync_debug_mode("warn")``.
Each warning is put down to the program's ``obs_trace.host_sync`` block
that encloses it on the Python stack (found by parsing the sources), or
to the innermost program frame where no block encloses it.  Prints the
batch's ``host_syncs`` against the warnings, and one line per site where
the two disagree; the whole table goes to ``chiprun_out/``.
"""
from __future__ import annotations

import argparse
import ast
import collections
import json
import sys
import traceback
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "portbench"), str(ROOT / "src")]
PKG = str(ROOT / "src" / "repro_torch")


def sync_blocks() -> dict:
    """{file: [(first line, last line)]} of every ``with ...host_sync(...)``
    block in the program's sources."""
    out: dict = {}
    for path in Path(PKG).rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if not isinstance(node, ast.With):
                continue
            for item in node.items:
                call = item.context_expr
                if isinstance(call, ast.Call) and getattr(call.func, "attr", getattr(
                        call.func, "id", "")) == "host_sync":
                    out.setdefault(str(path), []).append((node.lineno, node.end_lineno))
    return out


def site_of(stack, blocks: dict) -> str:
    """The innermost ``host_sync`` block on the warning's stack, else the
    innermost program frame, marked as not counted."""
    inner = []
    for fr in reversed(stack):
        if not fr.filename.startswith(PKG):
            continue
        inner.append(f"{Path(fr.filename).relative_to(ROOT)}:{fr.lineno} {fr.name}")
        for lo, hi in blocks.get(fr.filename, ()):
            if lo <= fr.lineno <= hi:
                return f"{Path(fr.filename).relative_to(ROOT)}:{lo} {fr.name}"
    if not inner:
        return "outside the program"
    return "NOT COUNTED " + " < ".join(inner[:3])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=2**31 + 17)
    ap.add_argument("--batches", type=int, default=1)
    ap.add_argument("--engine", nargs="*", default=[], metavar="KEY=VALUE",
                    help="override a setting of the cell's engine (a JSON value or a string)")
    args = ap.parse_args(argv)

    import torch

    import pb_harness
    import pb_manifest
    from repro_torch.obs import trace as obs_trace

    if not torch.cuda.is_available():
        print("sync_audit: needs a CUDA card", file=sys.stderr)
        return 3
    cell = pb_manifest.cell(args.workload)
    engine = dict(cell.config["engine"])
    for kv in args.engine:
        key, value = kv.split("=", 1)
        try:
            engine[key] = json.loads(value)
        except json.JSONDecodeError:
            engine[key] = value
    inputs = pb_harness.make_inputs(cell.config, cell.traffic, args.seed)
    program = pb_harness.PortProgram(engine, "cuda")
    pool, warm = program.items(inputs.pool), program.items(inputs.warm)
    program.build(inputs.graph)
    B = cell.traffic["batch"]
    for i in range(0, len(warm), B):
        program.match(warm[i: i + B])
    torch.cuda.synchronize()
    blocks = sync_blocks()
    counted: collections.Counter = collections.Counter()  # site -> syncs the program counted
    entered = getattr(obs_trace, "host_sync", None)

    def host_sync(n: int = 1):
        fr = sys._getframe(1)
        lines = blocks.get(fr.f_code.co_filename, ())
        lo = max((a for a, b in lines if a <= fr.f_lineno <= b), default=fr.f_lineno)
        counted[f"{Path(fr.f_code.co_filename).relative_to(ROOT)}:{lo} "
                f"{fr.f_code.co_name}"] += n
        return entered(n)

    warned: collections.Counter = collections.Counter()

    def show(message, category, filename, lineno, file=None, line=None):
        if "synchronizing CUDA operation" in str(message):
            warned[site_of(traceback.extract_stack()[:-1], blocks)] += 1

    if entered is not None:
        obs_trace.host_sync = host_sync
    old_show = warnings.showwarning
    report = []
    try:
        for b in range(args.batches):
            batch = [pool[(b * B + i) % len(pool)] for i in range(B)]
            before = sum(warned.values())
            with warnings.catch_warnings():
                warnings.simplefilter("always")
                warnings.showwarning = show
                with obs_trace.TRACER.trace_query(("audit", b)) as tr:
                    torch.cuda.set_sync_debug_mode("warn")
                    try:
                        program.match(batch)
                    finally:
                        torch.cuda.set_sync_debug_mode(0)
                torch.cuda.synchronize()
            counts = dict(getattr(tr, "counts", {}))
            n_warned = sum(warned.values()) - before
            report.append({"batch": b, "counts": counts, "warnings": n_warned})
            print(f"batch {b}: host_syncs {counts.get('host_syncs')} ({counts.get('queries')} "
                  f"queries), warnings {n_warned}")
    finally:
        if entered is not None:
            obs_trace.host_sync = entered
        warnings.showwarning = old_show
    sites = sorted(set(counted) | set(warned))
    table = [{"site": s, "counted": counted.get(s, 0), "warned": warned.get(s, 0)} for s in sites]
    diff = [r for r in table if r["counted"] != r["warned"]]
    print(f"sites: {len(table)}, differing: {len(diff)} (all audited batches)")
    for r in table:
        mark = "  " if r["counted"] == r["warned"] else "!!"
        print(f"{mark} counted {r['counted']:6d} warned {r['warned']:6d}  {r['site']}")
    tag = "".join(f"_{kv.replace('=', '-')}" for kv in args.engine)
    out = ROOT / "chiprun_out" / f"sync_audit_{args.workload}{tag}.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps({"workload": args.workload, "seed": args.seed, "engine": engine,
                               "device": torch.cuda.get_device_name(), "batches": report,
                               "sites": table}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
