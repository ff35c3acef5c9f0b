"""Roofline of the dry-run records on the card (the JAX package's
``launch/roofline.py``, with an NVIDIA H100's constants).

Per (arch × shape) on the single-pod mesh, per device:
    compute term    = flops / 989 TFLOP/s (bf16 dense tensor cores)
    memory term     = bytes / 3.35 TB/s (HBM): eager PyTorch fuses nothing
                      beyond the hand-written kernels, so every op's operands
                      and outputs cross HBM; ``bytes_fused`` / 3.35 TB/s, the
                      program with its elementwise chains fused, is shown as
                      the lower bound
    collective term = Σ_kind collective_bytes · ring_factor / 50 GB/s
and a cell whose ``peak_memory_in_bytes`` passes the card's 80 GB is
flagged "does not fit".  The peaks are NVIDIA's published H100 SXM rates
at its 700 W limit.  The link rate is one 400 Gb/s NIC a card, as NVIDIA's
DGX H100 has: every dim of both production meshes spans 16 cards, more
than a host's 8, so each collective over one of them crosses hosts;
NVLink's 450 GB/s each way holds only within a host.

MODEL_FLOPS = 6·N·D (dense) / 6·N_active·D (MoE) for LM training; the
analytic per-family conventions of the JAX module for the others.  The
ratio MODEL_FLOPS / flops exposes recomputation and redundancy.

Every number the table and the JSON hold stands beside the card's name
and power limit as ``nvidia-smi`` gives them (or a note that no card was
visible, where the constants are the published ones).

Usage: PYTHONPATH=src python -m repro_torch.launch.roofline [--dir experiments/dryrun_torch]
writes experiments/roofline_torch.md + roofline_torch.json.
"""
from __future__ import annotations

import argparse
import json
import subprocess
from pathlib import Path

__all__ = ["PEAK_FLOPS", "HBM_BW", "HBM_BYTES", "LINK_BW", "RING_FACTOR", "model_flops",
           "terms", "card", "load", "main"]

PEAK_FLOPS = 989e12  # bf16 dense, one H100 SXM
HBM_BW = 3.35e12  # B/s
HBM_BYTES = 80e9  # a card's memory
LINK_BW = 50e9  # B/s a card across hosts: one 400 Gb/s NIC

# effective wire multiplier per collective kind (ring algorithms)
RING_FACTOR = {
    "all-reduce": 2.0,  # reduce-scatter + all-gather passes
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
    "broadcast": 1.0,
}


def model_flops(rec: dict) -> float:
    """Analytic useful FLOPs for the whole program, GLOBAL (all devices): the
    JAX module's conventions, unchanged."""
    arch, shape = rec["arch"], rec["shape"]
    n_act = rec.get("model_params_active", rec.get("model_params", 0))
    fam_lm = arch in (
        "minitron-4b",
        "gemma3-1b",
        "command-r-plus-104b",
        "deepseek-v2-lite-16b",
        "qwen3-moe-235b-a22b",
    )
    if fam_lm:
        S, B = {
            "train_4k": (4096, 256),
            "prefill_32k": (32768, 32),
            "decode_32k": (32768, 128),
            "long_500k": (524288, 1),
        }[shape]
        if shape == "train_4k":
            return 6.0 * n_act * S * B  # fwd+bwd
        if shape == "prefill_32k":
            return 2.0 * n_act * S * B
        return 2.0 * n_act * B  # decode: one token a sequence
    if arch == "dcn-v2":
        # dense compute = cross+MLP params × batch (tables are lookups)
        p_dense = 429 * 429 * 3 + 429 * 1024 + 1024 * 1024 + 1024 * 512
        batch = {"train_batch": 65536, "serve_p99": 512, "serve_bulk": 262144,
                 "retrieval_cand": 1}[shape]
        f = (6.0 if shape == "train_batch" else 2.0) * p_dense * batch
        if shape == "retrieval_cand":
            f += 2.0 * 1_000_000 * 64  # candidate dot products
        return f
    # GNN: params × nodes-evaluated convention
    p = rec.get("model_params", 0)
    nodes = {
        "full_graph_sm": 2708,
        "minibatch_lg": 1024 * 16 * 11,  # layered vertex sets
        "ogb_products": 2_449_029,
        "molecule": 128 * 30,
    }.get(shape, 1)
    return 6.0 * p * nodes


def load(dir_: Path, mesh: str) -> list:
    return [json.loads(p.read_text()) for p in sorted(dir_.glob(f"*__{mesh}.json"))]


def terms(rec: dict) -> dict:
    t_comp = rec["flops"] / PEAK_FLOPS
    t_mem = rec["bytes"] / HBM_BW
    t_mem_lb = rec["bytes_fused"] / HBM_BW
    t_coll = sum(
        v * RING_FACTOR.get(k, 1.0) for k, v in rec.get("collective_bytes", {}).items()
    ) / LINK_BW
    dominant = max(
        [("compute", t_comp), ("memory", t_mem), ("collective", t_coll)], key=lambda kv: kv[1]
    )[0]
    mf = model_flops(rec)
    mf_dev = mf / max(rec.get("n_devices", 1), 1)
    useful = mf_dev / rec["flops"] if rec["flops"] else 0.0
    # useful work's time over the bound the dominant term implies
    t_bound = max(t_comp, t_mem, t_coll)
    frac = (mf_dev / PEAK_FLOPS) / t_bound if t_bound > 0 else 0.0
    peak = rec.get("memory", {}).get("peak_memory_in_bytes", 0)
    return {
        "compute_s": t_comp,
        "memory_s": t_mem,
        "memory_lb_s": t_mem_lb,
        "collective_s": t_coll,
        "dominant": dominant,
        "model_flops_global": mf,
        "useful_ratio": useful,
        "roofline_frac": frac,
        "peak_gb": peak / 1e9,
        "fits": peak <= HBM_BYTES,
    }


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.TimeoutExpired):
        out = None
    if out is None or out.returncode != 0 or not out.stdout.strip():
        return "no card visible (the constants are NVIDIA's published H100 SXM peaks, 700 W)"
    return out.stdout.strip().splitlines()[0]


def fmt(x: float) -> str:
    if x == 0:
        return "0"
    if x < 1e-3:
        return f"{x*1e6:.1f}µs"
    if x < 1:
        return f"{x*1e3:.2f}ms"
    return f"{x:.2f}s"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Roofline of the dry-run records on an H100")
    ap.add_argument("--dir", default="experiments/dryrun_torch")
    ap.add_argument("--out", default="experiments/roofline_torch.md")
    args = ap.parse_args(argv)
    where = card()
    rows = []
    for rec in load(Path(args.dir), "single"):
        if rec.get("status") == "skipped":
            rows.append({"arch": rec["arch"], "shape": rec["shape"], "skip": rec["reason"]})
        elif rec.get("status") != "ok":
            rows.append({"arch": rec["arch"], "shape": rec["shape"],
                         "skip": f"STATUS={rec['status']}"})
        else:
            rows.append({"arch": rec["arch"], "shape": rec["shape"], **terms(rec)})
    lines = [
        f"Per device on the single-pod (16 × 16) mesh; card: {where}",
        "",
        "| arch | shape | compute | memory (fused lb) | collective | dominant | MODEL_FLOPS | useful "
        "| roofline | peak GB of 80 |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        if "skip" in r:
            lines.append(f"| {r['arch']} | {r['shape']} | — | — | — | {r['skip'][:40]} | — | — | — "
                         "| — |")
            continue
        lines.append(
            "| {arch} | {shape} | {c} | {m} ({lb}) | {k} | **{dom}** | {mf:.2e} | {ur:.2f} | "
            "{rf:.1%} | {pg:.1f}{fit} |".format(
                arch=r["arch"], shape=r["shape"], c=fmt(r["compute_s"]), m=fmt(r["memory_s"]),
                lb=fmt(r["memory_lb_s"]), k=fmt(r["collective_s"]), dom=r["dominant"],
                mf=r["model_flops_global"], ur=r["useful_ratio"], rf=r["roofline_frac"],
                pg=r["peak_gb"], fit="" if r["fits"] else " (does not fit)",
            )
        )
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text("\n".join(lines) + "\n")
    Path(str(out).replace(".md", ".json")).write_text(
        json.dumps({"card": where, "rows": rows}, indent=1, default=str))
    print("\n".join(lines))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
