"""Device selection for the port (the card unless the caller asks for the
CPU), the test that tells a device fault from a request's, and the scope
in which meta tensors stand for the card's (the dry-run)."""
from __future__ import annotations

import contextlib
import threading

import torch

__all__ = ["default_device", "is_device_fault", "abstract_card", "takes_card_path",
           "dispatcher_watches"]

_state = threading.local()


@contextlib.contextmanager
def abstract_card():
    """Within this scope (this thread) a meta tensor stands for a card's: the
    kernels' wrappers take their card path for it, where their custom ops'
    fake kernels give the outputs' shapes and nothing runs
    (``launch/dryrun.py``).  Outside it a meta tensor has no kernel and the
    wrappers raise."""
    prev = getattr(_state, "abstract", False)
    _state.abstract = True
    try:
        yield
    finally:
        _state.abstract = prev


def takes_card_path(device) -> bool:
    """Whether a kernel's wrapper takes its card path for ``device``: a card,
    or a meta tensor inside ``abstract_card``."""
    return device.type == "cuda" or (device.type == "meta" and getattr(_state, "abstract", False))


def dispatcher_watches(t: torch.Tensor) -> bool:
    """Whether a kernel's forward on ``t`` goes through its custom op: where a
    dispatch mode is active (a counter such as ``launch/op_cost.py``, a fake
    mode) or ``t`` is not a plain card tensor.  A plain card tensor with no
    mode active launches the kernel directly, without the Python custom-op
    dispatch on the serving paths' host time."""
    return (torch._C._len_torch_dispatch_stack() > 0 or type(t) is not torch.Tensor
            or t.device.type != "cuda")


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
