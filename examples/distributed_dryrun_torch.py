"""Walk one architecture through the production-mesh dry-run of the PyTorch
port: one step of gemma3-1b train_4k on the 512-card multi-pod mesh as
DTensors over a fake process group, and print the memory, cost and
collective counts one rank runs (what ``repro_torch.launch.dryrun``
records; the port's counterpart of ``examples/distributed_dryrun.py``).

    PYTHONPATH=src python examples/distributed_dryrun_torch.py [--arch gemma3-1b] [--shape train_4k]
    PYTHONPATH=src python examples/distributed_dryrun_torch.py --arch dcn-v2 --shape serve_bulk --smoke
"""
import argparse


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--mesh", default="multi", choices=["single", "multi"])
    ap.add_argument("--smoke", action="store_true", help="the arch's smoke config")
    args = ap.parse_args()

    from repro_torch.launch.dryrun import run_cell

    rec = run_cell(args.arch, args.shape, args.mesh, None, smoke=args.smoke)
    if rec["status"] != "ok":
        raise SystemExit(f"{args.arch}/{args.shape}: {rec['status']}: "
                         f"{rec.get('reason') or rec.get('error')}")
    print(f"\n=== {args.arch} / {args.shape} on the {rec['n_devices']}-card mesh ===")
    print(f"trace: {rec['trace_s']:.1f}s")
    mem = rec["memory"]
    print(f"per-device memory: peak {mem.get('peak_memory_in_bytes', 0)/1e9:.2f} GB "
          f"(args {mem.get('argument_size_in_bytes', 0)/1e9:.2f} GB)")
    print(f"per-device FLOPs {rec['flops']:.3e}, bytes {rec['bytes']:.3e} "
          f"(fused {rec['bytes_fused']:.3e})")
    print("collectives:", {k: f"{v/1e9:.2f} GB" for k, v in rec["collective_bytes"].items()})


if __name__ == "__main__":
    main()
