#!/usr/bin/env python3
"""Read the port's dry-run records beside the JAX package's, cell by cell,
and hold each to the reference's plan: the three bounds of
``tests/test_torch_dryrun_reference.py``, applied to records of any depth.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh single --out PORT
    PYTHONPATH=src JAX_PLATFORMS=cpu python -m repro.launch.dryrun --all --mesh single --out REF
    python3 tools/dryrun_vs_reference.py PORT REF [--mesh single] [--markdown]
    python3 tools/dryrun_vs_reference.py PORT REF --mesh multi \
        [--port-single PORT1 --ref-single REF1]

Per cell, per device: flops (the port's ``op_cost`` against the reference's
``hlo_cost``), the port's peak against the reference's memory figure
(argument + output - alias + temp), collective bytes in all, and
all-gather (the reference's with its collective-permutes); then whether
the port's flops are at most 1.5x the reference's, its peak at most 2x
that figure + 256 MB, and, for decode and the online scan, its all-gather
at most the reference's all-gather and collective-permute + 64 MB.  With
``--mesh multi`` and a cell's (16, 16) records of both packages (in
``--port-single`` and ``--ref-single``, by default beside the multi
records), also each side's multi/single ratio of collective bytes, and
the scaling bound: the port's bytes on (2, 16, 16) at most its own on
(16, 16) × max(1.05, the reference's ratio) + 64 MB.  ``--markdown``
prints a table.  Exits 1 if a cell the reference lowers is not ``ok`` in
the port or breaks a bound.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

NO_GATHER = ("decode_32k", "long_500k", "online_scan")
GB = 1e9


def ref_memory(rec: dict) -> int:
    m = rec["memory"]
    return (m["argument_size_in_bytes"] + m["output_size_in_bytes"] - m["alias_size_in_bytes"]
            + m["temp_size_in_bytes"])


def compare(port: dict, ref: dict, singles=None) -> dict:
    """One cell's figures and the bounds it breaks (``bad``); ``singles``,
    where given, the (port, reference) records of the cell on (16, 16),
    against which the (2, 16, 16) ones scale."""
    pc, rc = port.get("collective_bytes", {}), ref.get("collective_bytes", {})
    row = {"flops": port["flops"], "ref_flops": ref["flops"],
           "peak": port["memory"]["peak_memory_in_bytes"], "ref_memory": ref_memory(ref),
           "coll": port["collective_bytes_total"], "ref_coll": ref["collective_bytes_total"],
           "ag": pc.get("all-gather", 0.0),
           "ref_ag": rc.get("all-gather", 0.0) + rc.get("collective-permute", 0.0),
           "trace_s": port.get("trace_s")}
    bad = []
    if row["flops"] > 1.5 * row["ref_flops"]:
        bad.append("flops")
    if row["peak"] > 2 * row["ref_memory"] + 256e6:
        bad.append("peak")
    if port["shape"] in NO_GATHER and row["ag"] > row["ref_ag"] + 64e6:
        bad.append("all-gather")
    row["ratio"] = row["ref_ratio"] = None
    if singles is not None:
        one, ref_one = (r["collective_bytes_total"] for r in singles)
        row["ratio"] = row["coll"] / one if one else None
        row["ref_ratio"] = row["ref_coll"] / ref_one if ref_one else None
        if row["coll"] > one * max(1.05, row["ref_ratio"] or 0.0) + 64e6:
            bad.append("scaling")
    row["bad"] = bad
    return row


def _single(dirs, name: str):
    """A cell's (port, reference) records on (16, 16), where both are ok."""
    recs = []
    for d in dirs:
        p = d / name.replace("__multi.json", "__single.json")
        rec = json.loads(p.read_text()) if p.exists() else {}
        if rec.get("status") != "ok":
            return None
        recs.append(rec)
    return recs


def _ratio(x) -> str:
    return "–" if x is None else f"{x:.2f}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("port", type=Path)
    ap.add_argument("ref", type=Path)
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--port-single", type=Path, help="the port's (16, 16) records (default PORT)")
    ap.add_argument("--ref-single", type=Path, help="the reference's (default REF)")
    ap.add_argument("--markdown", action="store_true")
    args = ap.parse_args(argv)
    singles = (args.port_single or args.port, args.ref_single or args.ref)
    failed = 0
    if args.markdown:
        print("| cell | flops port / ref | peak GB port / ref | collectives GB port / ref "
              "| multi/single port / ref | all-gather GB port / ref (+ permute) | trace s "
              "| bounds |")
        print("|---|---|---|---|---|---|---|---|")
    for p in sorted(args.port.glob(f"*__{args.mesh}.json")):
        port = json.loads(p.read_text())
        rp = args.ref / p.name
        ref = json.loads(rp.read_text()) if rp.exists() else {"status": "absent"}
        cell = f"{port['arch']} `{port['shape']}`"
        if port["status"] == "skipped" or ref.get("status") != "ok":
            note = port["status"] if port["status"] != "ok" else f"port ok, reference {ref.get('status')}"
            if port["status"] not in ("ok", "skipped"):
                failed += 1
            print(f"| {cell} | {note} | | | | | {port.get('trace_s', '')} | |" if args.markdown
                  else f"{cell}: {note}")
            continue
        if port["status"] != "ok":
            failed += 1
            print(f"| {cell} | port {port['status']} | | | | | | fails |" if args.markdown
                  else f"{cell}: port {port['status']}: {port.get('error', '')[:200]}")
            continue
        r = compare(port, ref, _single(singles, p.name) if args.mesh == "multi" else None)
        failed += bool(r["bad"])
        verdict = "fails " + ", ".join(r["bad"]) if r["bad"] else "within"
        ratios = f"{_ratio(r['ratio'])} / {_ratio(r['ref_ratio'])}"
        if args.markdown:
            print(f"| {cell} | {r['flops']:.3e} / {r['ref_flops']:.3e} | {r['peak'] / GB:.2f} / "
                  f"{r['ref_memory'] / GB:.2f} | {r['coll'] / GB:.2f} / {r['ref_coll'] / GB:.2f} | "
                  f"{ratios} | {r['ag'] / GB:.2f} / {r['ref_ag'] / GB:.2f} | {r['trace_s']} "
                  f"| {verdict} |")
        else:
            print(f"{cell}: flops {r['flops'] / max(r['ref_flops'], 1):.2f}x, peak "
                  f"{r['peak'] / GB:.2f} / {r['ref_memory'] / GB:.2f} GB, collectives "
                  f"{r['coll'] / GB:.2f} / {r['ref_coll'] / GB:.2f} GB (multi/single {ratios}), "
                  f"all-gather {r['ag'] / GB:.2f} / {r['ref_ag'] / GB:.2f} GB: {verdict}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
