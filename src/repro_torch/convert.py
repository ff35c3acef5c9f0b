"""Carry a JAX-package model's weights across to the port.

``jax.random`` initialisation cannot be reproduced in torch, so a parity
check builds the port from the reference's state: an engine's trained
per-partition state (``GnnPeEngine.build(g, params=...)``), a DCN-v2
params tree or an LM's, an AdamW state over either, or a whole
``Trainer`` checkpoint directory.  This module only reads the reference
objects' attributes and turns arrays into NumPy; it imports neither JAX
nor the JAX package.
"""
from __future__ import annotations

import re

import numpy as np
import torch

from .device import default_device
from .dist.checkpoint import CheckpointManager

__all__ = [
    "partition_state_from_reference",
    "dcn_params_from_reference",
    "lm_params_from_reference",
    "opt_state_from_reference",
    "trainer_state_from_reference",
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
    """The JAX package's LM params tree → the port's dict of float32 tensors
    on ``device`` (the card unless told otherwise): ``embed``,
    ``final_norm``, ``lm_head`` where the head is untied, and ``layers``, one
    dict a layer: the unstacked ``prefix_layers`` first, then the stacked
    ``layers`` split along their first dim (a MoE layer's nested ``moe``
    dict with them).  bf16 arrays are widened to float32, which is exact."""
    dev = default_device(device)

    def t(a):
        return torch.from_numpy(np.array(a, np.float32)).to(dev)

    def arrays(tree):
        if isinstance(tree, dict):
            return {k: arrays(v) for k, v in tree.items()}
        return np.asarray(tree, np.float32)

    def layer(tree, i=None):
        if isinstance(tree, dict):
            return {k: layer(v, i) for k, v in tree.items()}
        return t(tree if i is None else tree[i])

    stacked = arrays(params["layers"])
    first = stacked
    while isinstance(first, dict):
        first = next(iter(first.values()))
    out = {"embed": t(params["embed"]), "final_norm": t(params["final_norm"])}
    if "lm_head" in params:
        out["lm_head"] = t(params["lm_head"])
    out["layers"] = [layer(arrays(p)) for p in params.get("prefix_layers", [])] + [
        layer(stacked, i) for i in range(first.shape[0])]
    return out


def _tensors(tree, device):
    """A tree of arrays (dicts, lists) → the same tree of tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: _tensors(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tensors(v, device) for v in tree]
    return torch.from_numpy(np.array(tree)).to(device)


def opt_state_from_reference(opt_state: dict, params_fn=None, device=None) -> dict:
    """The JAX package's AdamW state ``{"m", "v", "step"}`` → the port's:
    ``m`` and ``v`` through ``params_fn`` (``dcn_params_from_reference`` or
    ``lm_params_from_reference``, which lay out the trees as the port's
    params are; None keeps the tree as it is), ``step`` a 0-d int32 tensor,
    all on ``device`` (the card unless told otherwise)."""
    dev = default_device(device)

    def conv(tree):
        return params_fn(tree, device=dev) if params_fn is not None else _tensors(tree, dev)

    return {"m": conv(opt_state["m"]), "v": conv(opt_state["v"]),
            "step": torch.tensor(int(np.asarray(opt_state["step"])), dtype=torch.int32,
                                 device=dev)}


_KEY_PART = re.compile(r"\['([^']*)'\]|\[(\d+)\]")


def _nest(flat: dict):
    """{checkpoint key string (``['a'][0]['b']``): array} → the nested tree,
    a dict whose keys are all ints becoming a list."""
    root: dict = {}
    for key, arr in flat.items():
        parts = [name if name else int(i) for name, i in _KEY_PART.findall(key)]
        node = root
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = arr

    def lists(node):
        if not isinstance(node, dict):
            return node
        out = {k: lists(v) for k, v in node.items()}
        if out and all(isinstance(k, int) for k in out):
            return [out[i] for i in range(len(out))]
        return out

    return lists(root)


def trainer_state_from_reference(directory, family: str | None = None, step: int | None = None,
                                 device=None) -> dict:
    """A JAX-package ``Trainer`` checkpoint (``{"params", "opt", "step"}``,
    verified as ``dist/checkpoint.py`` reads it; the newest valid step by
    default) → the port's ``{"params", "opt", "step"}`` on ``device``, for
    ``Trainer.load_state``.  ``family`` lays the params out as the port's
    model does: "lm" (layers stacked in the reference, a list here),
    "recsys", or None to keep the tree as stored."""
    dev = default_device(device)
    flat, _ = CheckpointManager(directory).restore_arrays(step)
    tree = _nest({k if k.startswith("[") else f"['{k}']": v for k, v in flat.items()})
    params_fn = {"lm": lm_params_from_reference, "recsys": dcn_params_from_reference}.get(family)
    if family is not None and params_fn is None:
        raise ValueError(f"unknown family {family!r}; use 'lm', 'recsys' or None")

    def conv(t):
        return params_fn(t, device=dev) if params_fn is not None else _tensors(t, dev)

    return {"params": conv(tree["params"]),
            "opt": opt_state_from_reference(tree["opt"], params_fn, device=dev),
            "step": torch.tensor(int(np.asarray(tree["step"])), dtype=torch.int32)}
