"""Wrapper of the ``flash_attention`` kernel (CUDA source:
``csrc/flash_attention.cu``) and its plain PyTorch version, registered as
the operator ``torch.ops.repro_torch.flash_attention``.

The dispatcher picks the implementation by the inputs' dispatch key: on
CUDA tensors the kernel's launch (after checks of dtype, shape and
strides), on CPU tensors the plain version; ``meta`` and fake tensors take
the fake implementation, which gives the output's shape, dtype and strides
and computes nothing; a real tensor on any other device raises. A launch
adds one to ``flash_attention.launches``, and nothing else does. The
reference has no backward kernel (XLA differentiates its plain attention),
so the backward is an operator of its own,
``torch.ops.repro_torch.flash_attention_backward``, the plain version's
vector-Jacobian product written out (the scores recomputed in f32); each
such pass on a
CUDA device adds one to ``flash_attention.plain_backwards``. Both operators
carry a FLOP formula (``torch.utils.flop_counter``) and a DTensor sharding
rule (``register_sharding``): replicated, batch-sharded, or head-sharded
when every mesh dimension divides both the query and the kv heads (and,
for grouped queries, their product does too), so that a shard holds whole
groups and the kernel's ``h // (H / Hkv)`` mapping holds on it. A trace
under ``FakeTensorMode`` or a sharded step therefore never enters the plain
version.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from repro_torch.kernels import _build

__all__ = ["NEG_INF", "MAX_HEAD_DIM", "flash_attention", "flash_attention_plain", "band_mask",
           "flash_attention_backward_plain", "live_pairs"]

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
    _build.same_device(q, k, v)
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
    return torch.ops.repro_torch.flash_attention(q, k, v, bool(causal), int(window))


def flash_attention_backward_plain(q, k, v, d_out, *, causal: bool, window: int):
    """(dq, dk, dv) in the inputs' dtypes: the vector-Jacobian product of the
    plain version at (q, k, v) with ``d_out``, its f32 arithmetic written
    out (the scores and probabilities recomputed; the softmax's adjoint
    p ⊙ (dp − Σ p·dp); masked pairs get none)."""
    _check(q, k, v)
    b, s, h, dh = q.shape
    hkv = k.shape[2]
    scale = 1.0 / math.sqrt(dh)
    qg = q.float().reshape(b, s, hkv, h // hkv, dh)
    kf, vf = k.float(), v.float()
    scores = torch.einsum("bqhrd,bkhd->bhrqk", qg, kf) * scale
    mask = band_mask(s, s, causal=causal, window=window, device=q.device)
    probs = torch.softmax(scores.masked_fill(~mask, NEG_INF), dim=-1)
    do = d_out.float().reshape(b, s, hkv, h // hkv, dh)
    dv = torch.einsum("bhrqk,bqhrd->bkhd", probs, do)
    dp = torch.einsum("bqhrd,bkhd->bhrqk", do, vf)
    ds = probs * (dp - torch.sum(dp * probs, dim=-1, keepdim=True)) * scale
    dq = torch.einsum("bhrqk,bkhd->bqhrd", ds, kf).reshape(b, s, h, dh)
    dk = torch.einsum("bhrqk,bqhrd->bkhd", ds, qg)
    return (dq.to(q.dtype).contiguous(), dk.to(k.dtype).contiguous(),
            dv.to(v.dtype).contiguous())


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=(), device_types="cpu")
def _op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
        window: int) -> torch.Tensor:
    return flash_attention_plain(q, k, v, causal=causal, window=window).contiguous()


@_op.register_kernel("cuda")
def _(q, k, v, causal, window):
    return _launch(q, k, v, causal=causal, window=window)


@_op.register_fake
def _(q, k, v, causal, window):
    _check(q, k, v)
    return q.new_empty(q.shape)


@torch.library.custom_op("repro_torch::flash_attention_backward", mutates_args=(),
                         device_types=("cpu", "cuda"))
def _backward_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, d_out: torch.Tensor,
                 causal: bool, window: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    grads = flash_attention_backward_plain(q, k, v, d_out, causal=causal, window=window)
    if q.device.type == "cuda":
        flash_attention.plain_backwards += 1
    return grads


@_backward_op.register_fake
def _(q, k, v, d_out, causal, window):
    return q.new_empty(q.shape), k.new_empty(k.shape), v.new_empty(v.shape)


def _setup_context(ctx, inputs, output):
    q, k, v, causal, window = inputs
    ctx.save_for_backward(q, k, v)
    ctx.causal, ctx.window = causal, window


def _backward(ctx, d_out):
    q, k, v = ctx.saved_tensors
    grads = torch.ops.repro_torch.flash_attention_backward(q, k, v, d_out, ctx.causal, ctx.window)
    return (*grads, None, None)


_op.register_autograd(_backward, setup_context=_setup_context)


def live_pairs(seq: int, *, causal: bool, window: int) -> int:
    """The (query, key) pairs of one (batch, head) that the mask leaves live."""
    if causal:
        if window and window < seq:
            return window * (window + 1) // 2 + (seq - window) * window
        return seq * (seq + 1) // 2
    if window and window <= seq:
        return seq * seq - (seq - window) * (seq - window + 1) // 2
    return seq * seq


def _flops(q_shape, k_shape, causal, window) -> int:
    """4·dh flops for each live (query, key) pair of each (batch, query head):
    2·dh for the score and 2·dh for the weighted sum of v."""
    b, s, h, dh = q_shape
    return 4 * dh * h * b * live_pairs(s, causal=causal, window=window)


def _register_flops() -> None:
    from torch.utils.flop_counter import register_flop_formula

    @register_flop_formula(torch.ops.repro_torch.flash_attention)
    def _(q_shape, k_shape, v_shape, causal, window, *args, out_shape=None, **kwargs) -> int:
        return _flops(q_shape, k_shape, causal, window)

    @register_flop_formula(torch.ops.repro_torch.flash_attention_backward)
    def _(q_shape, k_shape, v_shape, d_shape, causal, window, *args, out_shape=None,
          **kwargs) -> int:
        # the flash backward: the scores again, then dP, dV, dQ and dK (2.5× the forward)
        return 5 * _flops(q_shape, k_shape, causal, window) // 2


def _heads_divide(q, k) -> bool:
    """True when a head shard on any mesh dimension holds whole GQA groups:
    every mesh dimension divides H and Hkv and, with grouped queries, so
    does the product of all of them (two dimensions may shard the heads
    at once)."""
    h, hkv, sizes = q.shape[2], k.shape[2], tuple(q.mesh.shape)
    if any(h % n or hkv % n for n in sizes):
        return False
    total = 1
    for n in sizes:
        total *= n
    return h == hkv or (h % total == 0 and hkv % total == 0)


def _register_sharding() -> None:
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    def strategies(q, k, n_in: int, n_out: int):
        out = [([Replicate()] * n_out, [Replicate()] * n_in + [None, None]),
               ([Shard(0)] * n_out, [Shard(0)] * n_in + [None, None])]
        if _heads_divide(q, k):
            out.append(([Shard(2)] * n_out, [Shard(2)] * n_in + [None, None]))
        return out

    @register_sharding(torch.ops.repro_torch.flash_attention.default)
    def _(q, k, v, causal, window):
        return strategies(q, k, 3, 1)

    @register_sharding(torch.ops.repro_torch.flash_attention_backward.default)
    def _(q, k, v, d_out, causal, window):
        return strategies(q, k, 4, 3)


_register_flops()
_register_sharding()


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
