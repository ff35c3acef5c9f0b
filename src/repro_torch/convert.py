"""Carry a JAX-package engine's weights across to the port.

``jax.random`` initialisation cannot be reproduced in torch, so a parity
check builds the port from the reference's trained per-partition state
(``GnnPeEngine.build(g, params=...)``).  This module only reads the
reference objects' attributes and turns arrays into NumPy; it imports
neither JAX nor the JAX package.
"""
from __future__ import annotations

import numpy as np

__all__ = ["partition_state_from_reference"]


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
