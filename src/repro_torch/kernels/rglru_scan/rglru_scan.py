"""Wrapper of the ``rglru_scan`` kernel (CUDA source: ``csrc/rglru_scan.cu``)
and its plain PyTorch version.

For tensors on the CPU the wrapper takes the plain version, which autograd
differentiates; for tensors on a CUDA device it checks device, dtype, shape
and contiguity and launches the kernel inside a ``torch.autograd.Function``;
anything else raises. A launch adds one to ``rglru_scan.launches``, and
nothing else does. The kernel stages a and b in shared memory with
``cp.async``; :func:`copy_width` picks its copies' width.

The backward is the same recurrence run backwards in time
(:func:`rglru_scan_backward`): the adjoint g of h_t = a_t h_{t-1} + b_t is
g_t = dh_t + a_{t+1} g_{t+1}, with db = g and da_t = g_t h_{t-1}
(h_{-1} = 0), so one more launch of the same kernel on the time-flipped
inputs computes it.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import copy_width
from repro_torch.kernels.rglru_scan.ref import scan_ref

__all__ = ["rglru_scan", "rglru_scan_plain", "rglru_scan_backward", "copy_width"]

_SOURCE = Path(__file__).resolve().parent / "csrc" / "rglru_scan.cu"
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"rglru_scan": [_P, _P, _P, _I, _I, _I, _I, _P]}


def rglru_scan_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the sequential recurrence, one step at a time."""
    return scan_ref(a, b)


def rglru_scan_backward(a: torch.Tensor, h: torch.Tensor, dh: torch.Tensor,
                        scan=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(da, db) of h = scan(a, b) given the output h and its cotangent dh,
    all (B, S, D): the reverse recurrence g_t = dh_t + a_{t+1} g_{t+1}
    (a_S = 0) as one forward ``scan`` (the kernel by default) on the
    time-flipped inputs; db = g, da_t = g_t h_{t-1} with h_{-1} = 0."""
    scan = _launch if scan is None else scan
    a_next = torch.cat([a[:, 1:], torch.zeros_like(a[:, :1])], dim=1)
    g = torch.flip(scan(torch.flip(a_next, (1,)), torch.flip(dh, (1,)).contiguous()), (1,))
    h_prev = torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]], dim=1)
    return g * h_prev, g


def rglru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a, b: (B, S, D) float32 -> h: (B, S, D) with h_t = a_t h_{t-1} + b_t,
    h_{-1} = 0, each step a multiply then an add, as the plain version."""
    if _build.on_cpu(a, b):
        return rglru_scan_plain(a, b)
    return _RglruScan.apply(a, b)


class _RglruScan(torch.autograd.Function):
    """The kernel forward; the backward by the kernel, backwards in time."""

    @staticmethod
    def forward(ctx, a, b):
        h = _launch(a, b)
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    def backward(ctx, dh):
        a, h = ctx.saved_tensors
        return rglru_scan_backward(a, h, dh)


def _launch(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The kernel's launch on CUDA tensors, after the checks."""
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
