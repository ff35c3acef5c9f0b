"""GNN-PE in PyTorch for NVIDIA Hopper: the port of the JAX package ``repro``.

The main path is ``GnnPeEngine(cfg).build(g)`` then ``.match_many(queries)``
(``repro_torch.core``).  It runs on the card unless it is given
``device="cpu"``; the fused dominance verdict is a hand-written CUDA
kernel (``repro_torch.kernels.dominance_scan``).  The seed substrate's
DCN-v2 recommender serves through ``repro_torch.configs`` on the
hand-written embedding-bag and cross-layer kernels.  This package
imports neither JAX nor ``repro``.
"""
from .device import default_device

__all__ = ["default_device"]
