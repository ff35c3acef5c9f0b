"""Training launcher: ``--arch <id>`` end to end on the card (or the CPU).

    PYTHONPATH=src python -m repro_torch.launch.train --arch dcn-v2 --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b --smoke --steps 50
    PYTHONPATH=src python -m repro_torch.launch.train --arch gin-tu --steps 100

``--smoke`` (the default) runs the reduced config (an LM's in bf16 on the
card, where K6 takes bf16 only), ``--full`` the published one at the
cell's batch; the default cell is the arch's first, as the reference's
launcher takes it.  Both go through the same path: the cell's
``build_step`` train step, the (seed, step)-addressed synthetic data,
AdamW with warm-up and cosine decay, async checkpoints and resume.  It runs
on the card unless ``--device cpu`` is given; without a card it raises.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

from ..configs import build_step, get_arch, init_params, make_batch, opt_init, resolve_config
from ..data.pipeline import LMSyntheticData, RecsysSyntheticData
from ..device import default_device
from ..dist.checkpoint import CheckpointManager
from ..train.functional import tree_leaves, tree_to_device
from ..train.optimizer import OptConfig


def _lm_dims(cell, smoke: bool) -> tuple:
    if smoke:
        return 2, 64
    return cell.meta["global_batch"], cell.meta["seq_len"]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default=None, help="defaults to the arch's training shape")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = default_device(args.device)
    arch = get_arch(args.arch)
    cell = arch.cell(args.shape) if args.shape else arch.shapes[0]
    cfg = resolve_config(arch, cell, smoke=args.smoke)
    if arch.family == "lm" and dev.type == "cuda" and cfg.dtype != "bfloat16":
        cfg = dataclasses.replace(cfg, dtype="bfloat16")  # K6 takes bf16 on the card
    params = init_params(arch, cfg, seed=0, device=dev, train=True)
    n = sum(p.numel() for p in tree_leaves(params))
    print(f"[train] {arch.name}/{cell.name} on {dev}: {n / 1e6:.2f}M params, {args.steps} steps")
    opt_cfg = OptConfig(lr=args.lr, warmup_steps=min(30, args.steps // 5), total_steps=args.steps)
    step_fn, takes_opt = build_step(arch, cell, cfg, opt_cfg=opt_cfg)
    if not takes_opt:
        raise SystemExit(f"{cell.name} is not a training shape")
    opt = opt_init(params)
    if arch.family == "lm":
        data = LMSyntheticData(cfg.vocab, *_lm_dims(cell, args.smoke), seed=0)
        batch_at = data.batch_at
    elif arch.family == "recsys":
        data = RecsysSyntheticData(cfg, batch=256 if args.smoke else cell.meta["batch"], seed=0)
        batch_at = data.batch_at
    else:
        fixed = make_batch(arch, cell, cfg, smoke=args.smoke, device=dev)
        batch_at = lambda s: fixed  # noqa: E731

    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    start = 0
    if ckpt and ckpt.latest_step() is not None:
        state, start = ckpt.restore({"params": params, "opt": opt}, device=dev)
        params, opt = state["params"], state["opt"]
        print(f"[train] resumed from step {start}")
    t0 = time.perf_counter()
    first_loss = loss = None
    for s in range(start, args.steps):
        params, opt, metrics = step_fn(params, opt, tree_to_device(batch_at(s), dev))
        loss = float(metrics["loss"])
        if first_loss is None:
            first_loss = loss
        if s % args.log_every == 0:
            print(f"[train] step {s}: loss {loss:.4f} lr {float(metrics['lr']):.2e}")
        if ckpt and (s + 1) % args.ckpt_every == 0:
            ckpt.save_async(s + 1, {"params": params, "opt": opt})
    if ckpt:
        ckpt.wait()
    dt = time.perf_counter() - t0
    if first_loss is not None:
        print(f"[train] done: loss {first_loss:.4f} -> {loss:.4f} in {dt:.1f}s "
              f"({(args.steps - start) / dt:.2f} steps/s)")
    return {"first_loss": first_loss, "final_loss": loss, "steps": args.steps - start,
            "seconds": dt}


if __name__ == "__main__":
    main()
