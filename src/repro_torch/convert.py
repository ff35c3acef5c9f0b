"""Carry a JAX-package model's weights across to the port.

``jax.random`` initialisation cannot be reproduced in torch, so a parity
check builds the port from the reference's state: an engine's trained
per-partition state (``GnnPeEngine.build(g, params=...)``), a DCN-v2
params tree or a dense LM's.  This module only reads the reference objects' attributes
and turns arrays into NumPy; it imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

from .device import default_device

__all__ = [
    "partition_state_from_reference",
    "dcn_params_from_reference",
    "lm_params_from_reference",
]


def _numpy_params(params: dict) -> dict:
    return {k: np.asarray(v, np.float32) for k, v in params.items()}


def _star_indices(vertex_set: np.ndarray, vertex_ids: np.ndarray) -> np.ndarray:
    """Fallback vertex ids → indices into the partition's (sorted) vertex set."""
    return np.searchsorted(vertex_set, np.asarray(vertex_ids, np.int64)).astype(np.int64)


def partition_state_from_reference(models) -> list[dict]:
    """``repro.core.engine.PartitionModel`` list → the port's ``params`` list.

    One dict per partition: ``part_id``, ``params`` and ``multi_params``
    (NumPy float32 dicts of both encoders' weights), ``label_perms``, and
    the star indices forced to all-ones, ``fallback`` (main GNN) and
    ``fallback_multi`` (one array per multi-GNN).
    """
    out = []
    for m in models:
        vset = np.asarray(m.vertex_set, np.int64)
        out.append(
            {
                "part_id": int(m.part_id),
                "params": _numpy_params(m.params),
                "multi_params": [_numpy_params(p) for p in m.multi_params],
                "label_perms": np.asarray(m.label_perms, np.int64),
                "fallback": _star_indices(vset, m.fallback_vids),
                "fallback_multi": [_star_indices(vset, f) for f in m.fallback_vids_multi],
            }
        )
    return out


def dcn_params_from_reference(params: dict, device=None) -> dict:
    """The JAX package's DCN-v2 params tree (``tables``, ``cross`` and
    ``mlp`` lists of ``{"w", "b"}``, ``head``, ``retrieval_proj``) → the
    port's dict of float32 tensors on ``device`` (the card unless told
    otherwise)."""
    dev = default_device(device)

    def t(a):
        return torch.from_numpy(np.array(a, np.float32)).to(dev)

    return {
        "tables": t(params["tables"]),
        "cross": [{"w": t(c["w"]), "b": t(c["b"])} for c in params["cross"]],
        "mlp": [{"w": t(m["w"]), "b": t(m["b"])} for m in params["mlp"]],
        "head": t(params["head"]),
        "retrieval_proj": t(params["retrieval_proj"]),
    }


def lm_params_from_reference(params: dict, device=None) -> dict:
    """The JAX package's dense LM params tree (``embed``, ``final_norm`` and
    ``layers``, a dict of arrays stacked over layers) → the port's dict of
    tensors on ``device`` (the card unless told otherwise), one dict per
    layer, float32 as the reference stores them."""
    dev = default_device(device)

    def t(a):
        return torch.from_numpy(np.array(a, np.float32)).to(dev)

    stacked = {k: np.asarray(v, np.float32) for k, v in params["layers"].items()}
    n_layers = next(iter(stacked.values())).shape[0]
    return {
        "embed": t(params["embed"]),
        "final_norm": t(params["final_norm"]),
        "layers": [{k: t(v[i]) for k, v in stacked.items()} for i in range(n_layers)],
    }
