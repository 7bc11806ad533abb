"""Device choice for the port, and its float32 policy.

Importing this module turns TF32 off for cuBLAS matmuls and cuDNN: the port
is held to the JAX reference at 1e-5, and TF32 keeps about three decimal
digits.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names another.

    Raises ``RuntimeError`` when CUDA is asked for, explicitly or by default,
    and no CUDA device is present: the port never falls back to the CPU on
    its own. Under ``FakeTensorMode`` (the dry-run) CUDA tensors hold no data
    and need no card.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available() and not _fake_mode():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev


def _fake_mode() -> bool:
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

    return any(isinstance(m, FakeTensorMode) for m in _get_current_dispatch_mode_stack())
