"""Carry weights from the JAX package across into the port.

The inputs are anything ``numpy.asarray`` accepts (a JAX array converts
without this module importing JAX); the outputs are contiguous float32
tensors on the chosen device.
"""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from repro_torch._device import resolve_device

__all__ = ["result_to_torch", "weights_to_torch"]

_RESULT_FIELDS = ("W", "w_consensus", "W_avg")


def _tensor(a, device: torch.device) -> torch.Tensor:
    # a fresh contiguous copy: JAX hands out read-only buffers
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C")).to(device)


def weights_to_torch(w, device: torch.device | str | None = None) -> torch.Tensor:
    """A (d,) binary weight vector or (C, d) class-weight plane, as the
    float32 tensor ``ops.dense_predict`` takes."""
    if np.ndim(w) not in (1, 2):
        raise ValueError(f"weights must be (d,) or (C, d), got shape {np.shape(w)}")
    return _tensor(w, resolve_device(device))


def result_to_torch(result, device: torch.device | str | None = None) -> dict:
    """The weights of a ``GadgetResult``-like value (a mapping or an object
    with ``W``, ``w_consensus`` and ``W_avg``) as ``{name: tensor}``; a
    field that is None stays None."""
    dev = resolve_device(device)
    out = {}
    for name in _RESULT_FIELDS:
        v = result[name] if isinstance(result, Mapping) else getattr(result, name)
        out[name] = None if v is None else _tensor(v, dev)
    return out
