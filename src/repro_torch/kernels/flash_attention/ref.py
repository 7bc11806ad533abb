"""Plain PyTorch oracle for flash attention (the masking of
``models.attention``), on the reference kernel's (BH, S, dh) planes, and a
plain emulation of the kernel's TF32 arithmetic that shows why its f32
route splits every operand."""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.flash_attention.flash_attention import (NEG_INF, band_mask,
                                                                 flash_attention_plain)

__all__ = ["attention_ref", "tf32_round", "tf32_matmul", "attention_tf32"]


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0) -> torch.Tensor:
    """q, k, v: (BH, S, dh); each plane is one head of ``flash_attention_plain``."""
    return flash_attention_plain(q[:, :, None], k[:, :, None], v[:, :, None],
                                 causal=causal, window=window)[:, :, 0]


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` rounded to TF32 as ``cvt.rna.tf32.f32`` does: 0x1000 added to
    the int32 view (half away from zero on the magnitude) and the low 13
    mantissa bits cleared."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_matmul(a: torch.Tensor, b: torch.Tensor, *, terms: int) -> torch.Tensor:
    """``a @ b`` from TF32 operands, summed in f32: ``terms`` = 1 is one TF32
    product (hi·hi); 3 is the kernel's split, lo·hi + hi·lo + hi·hi with
    hi = tf32(x) and lo = tf32(x − hi)."""
    if terms not in (1, 3):
        raise ValueError(f"terms must be 1 or 3, got {terms}")
    a_hi, b_hi = tf32_round(a), tf32_round(b)
    out = a_hi @ b_hi
    if terms == 3:
        a_lo, b_lo = tf32_round(a - a_hi), tf32_round(b - b_hi)
        out = a_lo @ b_hi + a_hi @ b_lo + out
    return out


def attention_tf32(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, terms: int,
                   causal: bool = True, window: int = 0) -> torch.Tensor:
    """Masked softmax attention on (BH, S, dh) f32 planes with both products
    (q kᵀ and P v) taken by :func:`tf32_matmul` and everything else in f32,
    as the kernel's tensor-core route computes it."""
    s, dh = q.shape[1], q.shape[2]
    scores = tf32_matmul(q, k.transpose(1, 2), terms=terms) * (1.0 / math.sqrt(dh))
    mask = band_mask(s, s, causal=causal, window=window, device=q.device)
    probs = torch.softmax(scores.masked_fill(~mask, NEG_INF), dim=-1)
    return tf32_matmul(probs, v, terms=terms)
