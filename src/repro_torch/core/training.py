"""Dominance-embedding training (paper Alg. 2) with a verified fallback.

Trains the GAT encoder on every (unit star, substructure) pair of a
partition with the hinge loss of Eq. (7) until the loss is *exactly*
zero (the paper overfits deliberately).  Differences from the paper,
both conservative:

* a small training margin ``δ`` inside the hinge (verify still checks
  the exact ``o(s) ⪯ o(g)``) reaches exact zero in far fewer epochs;
* vertices whose pairs still violate after the epoch budget fall back to
  the all-ones embedding (the paper's own high-degree trick), so the
  no-false-dismissal guarantee never depends on optimizer luck.

Gradients come from torch autograd; the Adam update is written out by
hand, step for step as in the JAX package.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .encoder import EncoderConfig, MonotoneEncoder, make_encoder
from .stars import PairDataset, StarTensors

__all__ = ["TrainConfig", "TrainResult", "train_dominance", "dominance_violations"]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr: float = 2e-2
    margin: float = 0.03
    max_epochs: int = 600
    batch_size: int = 16384
    check_every: int = 25
    seed: int = 0


@dataclasses.dataclass
class TrainResult:
    params: dict
    epochs: int
    final_violations: int
    fallback_vertices: np.ndarray  # star indices forced to all-ones
    loss_history: list


def _pair_embeddings(encoder, params, stars: StarTensors, pair_idx, pair_mask):
    """(o(g), o(s)) for a batch of (star, substructure) pairs."""
    c = stars.center_labels[pair_idx]
    ll = stars.leaf_labels[pair_idx]
    full_mask = stars.leaf_mask[pair_idx]
    o_g = encoder.embed_stars(params, c, ll, full_mask)
    o_s = encoder.embed_stars(params, c, ll, pair_mask & full_mask)
    return o_g, o_s


def _adam_step(encoder, params, opt, stars, pair_idx, pair_mask, lr, margin, t):
    """One hand-written Adam step on the Eq. (7) hinge; returns the loss."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    o_g, o_s = _pair_embeddings(encoder, leaves, stars, pair_idx, pair_mask)
    viol = torch.clamp(o_s - o_g + margin, min=0.0)
    loss = torch.sum(viol * viol)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    b1, b2, eps = 0.9, 0.999, 1e-8
    with torch.no_grad():
        for k in params:
            g = grads[k]
            opt["m"][k] = b1 * opt["m"][k] + (1 - b1) * g
            opt["v"][k] = b2 * opt["v"][k] + (1 - b2) * g * g
            mh = opt["m"][k] / (1 - b1**t)
            vh = opt["v"][k] / (1 - b2**t)
            params[k] = params[k] - lr * mh / (torch.sqrt(vh) + eps)
    return float(loss.detach())


@torch.no_grad()
def dominance_violations(encoder, params, stars: StarTensors, pairs: PairDataset) -> torch.Tensor:
    """Per-pair exact (margin-free) violation mask of o(s) ⪯ o(g), in chunks."""
    out = []
    step = 65536
    for lo in range(0, pairs.n_pairs, step):
        o_g, o_s = _pair_embeddings(
            encoder, params, stars,
            pairs.star_idx[lo : lo + step], pairs.subset_mask[lo : lo + step],
        )
        out.append((o_s > o_g).any(dim=-1))
    if not out:
        return torch.zeros((0,), dtype=torch.bool, device=stars.leaf_mask.device)
    return torch.cat(out)


def train_dominance(
    cfg: EncoderConfig,
    stars: StarTensors,
    pairs: PairDataset,
    tcfg: TrainConfig = TrainConfig(),
) -> TrainResult:
    """Alg. 2: epochs of Adam on Eq. (7) + exact testing epoch until L == 0."""
    encoder = make_encoder(cfg)
    device = stars.leaf_mask.device
    gen = torch.Generator().manual_seed(tcfg.seed)
    params = {k: v.to(device) for k, v in encoder.init(gen).items()}
    if isinstance(encoder, MonotoneEncoder) or pairs.n_pairs == 0:
        # dominance holds by construction: nothing to train
        viol = dominance_violations(encoder, params, stars, pairs)
        assert not bool(viol.any()), "monotone encoder must be violation-free"
        return TrainResult(params, 0, 0, np.zeros((0,), np.int32), [])

    opt = {
        "m": {k: torch.zeros_like(v) for k, v in params.items()},
        "v": {k: torch.zeros_like(v) for k, v in params.items()},
    }
    P = pairs.n_pairs
    bs = min(tcfg.batch_size, P)
    rng = np.random.default_rng(tcfg.seed)
    loss_hist: list[float] = []
    t = 0
    epochs_run = 0
    for epoch in range(tcfg.max_epochs):
        epochs_run = epoch + 1
        perm = torch.as_tensor(rng.permutation(P), device=device)
        epoch_loss = 0.0
        for lo in range(0, P, bs):
            sel = perm[lo : lo + bs]
            t += 1
            epoch_loss += _adam_step(
                encoder, params, opt, stars,
                pairs.star_idx[sel], pairs.subset_mask[sel], tcfg.lr, tcfg.margin, t,
            )
        loss_hist.append(epoch_loss)
        if epoch % tcfg.check_every == tcfg.check_every - 1 or epoch_loss == 0.0:
            if not bool(dominance_violations(encoder, params, stars, pairs).any()):
                return TrainResult(params, epochs_run, 0, np.zeros((0,), np.int32), loss_hist)
    # Budget exhausted: force the offending centers to all-ones (safe).
    viol = dominance_violations(encoder, params, stars, pairs)
    bad_stars = torch.unique(pairs.star_idx[viol]).cpu().numpy().astype(np.int32)
    return TrainResult(params, epochs_run, int(viol.sum()), bad_stars, loss_hist)
