"""Wrapper of the ``wkv_scan`` kernel (CUDA source: ``csrc/wkv_scan.cu``)
and its plain PyTorch version.

For tensors on the CPU the wrapper takes the plain version, which autograd
differentiates; for tensors on a CUDA device it checks device, dtype, shape
and contiguity and launches the kernel inside a ``torch.autograd.Function``;
anything else raises. A launch adds one to ``wkv_scan.launches``, and
nothing else does. The reference has no backward kernel (XLA differentiates
its plain scan), so the Function's backward recomputes the plain version
under autograd from the saved inputs and takes its vector-Jacobian product;
each such pass adds one to ``wkv_scan.plain_backwards``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rwkv6_scan.ref import scan_ref

__all__ = ["MAX_HEAD_SIZE", "wkv_scan", "wkv_scan_plain"]

MAX_HEAD_SIZE = 256  # the kernel's largest n (a lane holds at most 32 rows of 4 columns)

_SOURCE = Path(__file__).resolve().parent / "csrc" / "wkv_scan.cu"
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"wkv_scan": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]}


def wkv_scan_plain(r, k, v, w, u) -> torch.Tensor:
    """Plain PyTorch version: the recurrence one time step at a time, S_0 = 0."""
    return scan_ref(r, k, v, w, u)


def wkv_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
             u: torch.Tensor) -> torch.Tensor:
    """r, k, v, w: (B, S, H, n) float32; u: (H, n). Returns out (B, S, H, n)
    with ``out_t = r_t (S + diag(u) k_tᵀ v_t)`` and
    ``S <- diag(w_t) S + k_tᵀ v_t`` per (batch, head), S_0 = 0. On CUDA, n
    must be at most ``MAX_HEAD_SIZE``."""
    if _build.on_cpu(r, k, v, w, u):
        return wkv_scan_plain(r, k, v, w, u)
    return _WkvScan.apply(r, k, v, w, u)


class _WkvScan(torch.autograd.Function):
    """The kernel forward; the backward through the plain version."""

    @staticmethod
    def forward(ctx, r, k, v, w, u):
        ctx.save_for_backward(r, k, v, w, u)
        return _launch(r, k, v, w, u)

    @staticmethod
    def backward(ctx, d_out):
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            out = wkv_scan_plain(*leaves)
            # at S = 1 the decay w reaches no output: its gradient is zero
            grads = torch.autograd.grad(out, leaves, d_out, materialize_grads=True)
        wkv_scan.plain_backwards += 1
        return grads


def _launch(r, k, v, w, u) -> torch.Tensor:
    """The kernel's launch on CUDA tensors, after the checks."""
    if r.ndim != 4:
        raise ValueError(f"r must be (B, S, H, n), got shape {tuple(r.shape)}")
    B, S, H, n = r.shape
    if not 1 <= n <= MAX_HEAD_SIZE:
        raise ValueError(f"head size {n} outside the kernel's 1..{MAX_HEAD_SIZE}")
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w)):
        _build.check_tensor(name, t, (B, S, H, n))
    _build.check_tensor("u", u, (H, n))
    out = torch.empty_like(r)
    with torch.cuda.device(r.device):
        code = _build.load(_SOURCE, _SIGNATURES).wkv_scan(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
            out.data_ptr(), B, S, H, n, _build.stream(r))
    _build.check(code, "wkv_scan")
    wkv_scan.launches += 1
    return out


wkv_scan.launches = 0
wkv_scan.plain_backwards = 0
