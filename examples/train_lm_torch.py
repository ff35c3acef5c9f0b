"""Train a small LM with the port's full training substrate: the
deterministic data pipeline, AdamW with a cosine schedule, async
checkpoints, the straggler watchdog and resume; a few hundred steps, and
the loss must drop.  On the card unless ``--device cpu`` is given.

    PYTHONPATH=src python examples/train_lm_torch.py [--steps 300] [--device cpu]
"""
import argparse
import os
import tempfile

import torch

from repro_torch.data.pipeline import LMSyntheticData
from repro_torch.device import default_device
from repro_torch.models import TransformerConfig, init_lm_params, lm_loss
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.trainer import Trainer, TrainerConfig


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_lm_ckpt"))
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()

    dev = default_device(args.device)
    # four local layers with a window past the sequence (full causal attention), a tied head
    cfg = TransformerConfig(
        n_layers=4, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32, d_ff=512, vocab=512,
        attention="local_global", window=1024, global_period=6, tie_embeddings=True,
        dtype="float32" if dev.type == "cpu" else "bfloat16", kv_chunk=64, remat=False,
    )
    params = init_lm_params(torch.Generator(device=dev).manual_seed(0), cfg)
    n_params = sum(t.numel() for t in [params["embed"], params["final_norm"]]
                   + [t for layer in params["layers"] for t in layer.values()])
    print(f"model: {n_params / 1e6:.2f}M params on {dev}")

    data = LMSyntheticData(vocab=cfg.vocab, batch=8, seq_len=128, seed=0)
    tcfg = TrainerConfig(
        total_steps=args.steps,
        ckpt_every=100,
        ckpt_dir=args.ckpt_dir,
        opt=OptConfig(lr=3e-3, warmup_steps=30, total_steps=args.steps),
    )
    tr = Trainer(lambda p, b: lm_loss(p, b, cfg), params, data.batch_at, tcfg)
    tr.install_preemption_handler()
    if tr.try_resume():
        print(f"resumed from step {tr.step}")
    out = tr.run()
    first = tr.history[0]["loss"]
    print(
        f"steps {out['final_step']}: loss {first:.3f} -> {out['final_loss']:.3f} "
        f"({out['wall_s']:.0f}s, {out['stragglers']} straggler events)"
    )
    assert out["final_loss"] < first * 0.8, "loss must drop"


if __name__ == "__main__":
    main()
