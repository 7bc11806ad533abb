"""Wrapper of the ``flash_attention`` kernel (CUDA source:
``csrc/flash_attention.cu``) and its plain PyTorch version.

For tensors on the CPU the wrapper takes the plain version, which autograd
differentiates; for tensors on a CUDA device it checks device, dtype, shape
and strides and launches the kernel inside a ``torch.autograd.Function``;
anything else raises. A launch adds one to ``flash_attention.launches``,
and nothing else does. The reference has no backward kernel (XLA
differentiates its plain attention), so the Function's backward recomputes
the plain version under autograd from the saved q, k and v and takes its
vector-Jacobian product; each such pass adds one to
``flash_attention.plain_backwards``.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from repro_torch.kernels import _build

__all__ = ["NEG_INF", "MAX_HEAD_DIM", "flash_attention", "flash_attention_plain", "band_mask"]

NEG_INF = -1e30
MAX_HEAD_DIM = 256  # the kernel's largest head (it pads dh up to 32, 64, 96, 128 or 256)
_DTYPES = (torch.float32, torch.bfloat16)

_SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {"flash_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _I, *[_L] * 9, _I, _I, _I, _P]}


def band_mask(sq: int, sk: int, *, causal: bool, window: int,
              device: torch.device | str | None = None) -> torch.Tensor:
    """(sq, sk) bool mask, True where query i may see key j: ``j <= i`` when
    causal, and ``j > i - window`` when ``window`` > 0."""
    q_pos = torch.arange(sq, device=device)[:, None]
    k_pos = torch.arange(sk, device=device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask = mask & (k_pos <= q_pos)
    if window:
        mask = mask & (k_pos > q_pos - window)
    return mask


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"q, k, v must be (B, S, H, dh); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, s, h, dh = q.shape
    hkv = k.shape[2]
    if tuple(k.shape) != (b, s, hkv, dh) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"k and v must be ({b}, {s}, Hkv, {dh}); got {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if hkv < 1 or h % hkv:
        raise ValueError(f"query heads {h} must be a multiple of kv heads {hkv}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"q, k, v must share one of {_DTYPES}; got {q.dtype}, {k.dtype}, {v.dtype}")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True, window: int = 0) -> torch.Tensor:
    """Plain PyTorch version: masked softmax attention in f32, the queries
    grouped per kv head (nothing repeated), the masked scores filled with
    -1e30, the output in q's dtype."""
    _check(q, k, v)
    b, s, h, dh = q.shape
    hkv = k.shape[2]
    qg = q.float().reshape(b, s, hkv, h // hkv, dh)
    scores = torch.einsum("bqhrd,bkhd->bhrqk", qg, k.float()) * (1.0 / math.sqrt(dh))
    mask = band_mask(s, s, causal=causal, window=window, device=q.device)
    probs = torch.softmax(scores.masked_fill(~mask, NEG_INF), dim=-1)
    out = torch.einsum("bhrqk,bkhd->bqhrd", probs, v.float())
    return out.reshape(b, s, h, dh).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """softmax(q kᵀ/√dh + mask) v in the model's layout.

    q: (B, S, H, dh); k, v: (B, S, Hkv, dh) with H a multiple of Hkv (query
    head h reads kv head h // (H / Hkv)); float32 or bfloat16, all one type;
    any S. The mask is causal (``k <= q``) when ``causal`` and a band
    (``k > q - window``) when ``window`` > 0. Returns (B, S, H, dh) in q's
    dtype, accumulated in f32. On CUDA the inputs may be strided views with
    a contiguous last dim, and dh must be at most ``MAX_HEAD_DIM``.
    """
    if _build.on_cpu(q, k, v):
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    return _FlashAttention.apply(q, k, v, causal, window)


class _FlashAttention(torch.autograd.Function):
    """The kernel forward; the backward through the plain version."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        return _launch(q, k, v, causal=causal, window=window)

    @staticmethod
    def backward(ctx, d_out):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            out = flash_attention_plain(*leaves, causal=ctx.causal, window=ctx.window)
            grads = torch.autograd.grad(out, leaves, d_out)
        flash_attention.plain_backwards += 1
        return (*grads, None, None)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
            window: int) -> torch.Tensor:
    """The kernel's launch on CUDA tensors, after the checks."""
    _check(q, k, v)
    b, s, h, dh = q.shape
    hkv = k.shape[2]
    if not 1 <= dh <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {dh} outside the kernel's 1..{MAX_HEAD_DIM}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must have a contiguous last dim, got strides {t.stride()}")
    o = torch.empty((b, s, h, dh), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        code = _build.load(_SOURCE, _SIGNATURES).flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, s, h, hkv, dh,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], int(causal), int(window),
            int(q.dtype == torch.bfloat16), _build.stream(q))
    _build.check(code, "flash_attention")
    flash_attention.launches += 1
    return o


flash_attention.launches = 0
flash_attention.plain_backwards = 0
