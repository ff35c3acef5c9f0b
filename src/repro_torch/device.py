"""Device selection for the port (the card unless the caller asks for the
CPU), and the test that tells a device fault from a request's."""
from __future__ import annotations

import torch

__all__ = ["default_device", "is_device_fault"]


def default_device(device=None) -> torch.device:
    """``torch.device("cuda")`` unless ``device`` names another one.

    Turns TF32 off for matmuls and cuDNN: the leaf verdict has only
    ``eps = 1e-6`` of slack, and TF32's ~1e-3 relative error would
    dismiss true matches.  Asking for CUDA without a card raises; nothing
    falls back to the CPU.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev


def is_device_fault(exc: BaseException) -> bool:
    """A kernel that did not build or launch, or a CUDA error of the device.

    No request caused it and no retry of one cures it, so the serving
    tiers re-raise it where they quarantine or retry request faults.
    """
    from .kernels.build import KernelBuildError, KernelLaunchError

    if isinstance(exc, (KernelBuildError, KernelLaunchError)):
        return True
    accel = getattr(torch, "AcceleratorError", None)
    if accel is not None and isinstance(exc, accel):
        return True
    return isinstance(exc, RuntimeError) and str(exc).startswith("CUDA error")
