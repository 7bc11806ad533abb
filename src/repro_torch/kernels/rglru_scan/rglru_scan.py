"""Wrapper of the ``rglru_scan`` kernel (CUDA source: ``csrc/rglru_scan.cu``)
and its plain PyTorch version.

For tensors on the CPU the wrapper takes the plain version; for tensors on
a CUDA device it checks device, dtype, shape and contiguity and launches the
kernel; anything else raises. A launch adds one to ``rglru_scan.launches``,
and nothing else does. The kernel stages a and b in shared memory with
``cp.async``; :func:`copy_width` picks its copies' width.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import copy_width
from repro_torch.kernels.rglru_scan.ref import scan_ref

__all__ = ["rglru_scan", "rglru_scan_plain", "copy_width"]

_SOURCE = Path(__file__).resolve().parent / "csrc" / "rglru_scan.cu"
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"rglru_scan": [_P, _P, _P, _I, _I, _I, _I, _P]}


def rglru_scan_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the sequential recurrence, one step at a time."""
    return scan_ref(a, b)


def rglru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a, b: (B, S, D) float32 -> h: (B, S, D) with h_t = a_t h_{t-1} + b_t,
    h_{-1} = 0, each step a multiply then an add, as the plain version."""
    if _build.on_cpu(a, b):
        return rglru_scan_plain(a, b)
    if a.ndim != 3:
        raise ValueError(f"a must be (B, S, D), got shape {tuple(a.shape)}")
    B, S, D = a.shape
    _build.check_tensor("a", a, (B, S, D))
    _build.check_tensor("b", b, (B, S, D))
    h = torch.empty_like(a)
    with torch.cuda.device(a.device):
        code = _build.load(_SOURCE, _SIGNATURES).rglru_scan(
            a.data_ptr(), b.data_ptr(), h.data_ptr(), B, S, D,
            copy_width(D, a.data_ptr(), b.data_ptr()), _build.stream(a))
    _build.check(code, "rglru_scan")
    rglru_scan.launches += 1
    return h


rglru_scan.launches = 0
