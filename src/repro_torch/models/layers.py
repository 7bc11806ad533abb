"""Shared neural layers: norms, embeddings, rotary, MLP variants.

Each layer with weights is an ``nn.Module`` holding them under the
reference's names (``scale``, ``bias``, ``table``, ``w``, ``wi`` / ``wg`` /
``wo``), so a parameter's dotted path in ``state_dict`` is its key path in
the reference's param dict. The apply functions keep the reference's names
and take the module where the reference takes the dict. ``init_*`` build a
module on a device and fill it from an explicit ``torch.Generator`` with
the reference's distributions and scales.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.sharding.api import vocab_rows

__all__ = [
    "Norm", "Embedding", "Dense", "MLP",
    "rms_norm", "layer_norm", "init_norm",
    "init_embedding", "embed", "unembed",
    "rotary", "init_dense", "dense",
    "init_mlp", "mlp_apply", "normal_", "MLP_KINDS",
]

MLP_KINDS = ("gated_silu", "squared_relu", "gelu")


def normal_(t: torch.Tensor, gen: torch.Generator | None, scale: float = 1.0) -> torch.Tensor:
    """Fill ``t`` in place with N(0, 1) draws from ``gen`` times ``scale``
    (the reference's ``jax.random.normal(key, shape) * scale``)."""
    with torch.no_grad():
        t.normal_(0.0, 1.0, generator=gen)
        if scale != 1.0:
            t.mul_(scale)
    return t


def _param(shape, device, dtype) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype))


class Norm(nn.Module):
    """RMS or layer norm weights: ``scale`` (ones) and, optionally, ``bias``."""

    def __init__(self, d: int, *, with_bias: bool = False, device=None, dtype=torch.float32):
        super().__init__()
        self.scale = nn.Parameter(torch.ones((d,), device=device, dtype=dtype))
        if with_bias:
            self.bias = nn.Parameter(torch.zeros((d,), device=device, dtype=dtype))


class Embedding(nn.Module):
    """Token embedding ``table`` (vocab, d), N(0, 1) · 0.02."""

    def __init__(self, vocab: int, d: int, *, device=None, dtype=torch.float32):
        super().__init__()
        self.table = _param((vocab, d), device, dtype)

    def reset(self, gen: torch.Generator | None) -> None:
        normal_(self.table, gen, 0.02)


class Dense(nn.Module):
    """A (d_in, d_out) weight ``w``, N(0, 1) · scale (default 1/√d_in)."""

    def __init__(self, d_in: int, d_out: int, *, device=None, dtype=torch.float32):
        super().__init__()
        self.w = _param((d_in, d_out), device, dtype)

    def reset(self, gen: torch.Generator | None, scale: float | None = None) -> None:
        normal_(self.w, gen, scale if scale is not None else 1.0 / math.sqrt(self.w.shape[0]))


class MLP(nn.Module):
    """``wi``, ``wg`` (gated_silu only) and ``wo``; ``kind`` is a plain attribute."""

    def __init__(self, d: int, d_ff: int, kind: str, *, device=None, dtype=torch.float32):
        super().__init__()
        if kind not in MLP_KINDS:
            raise ValueError(f"unknown mlp kind {kind!r}")
        self.kind = kind
        self.wi = Dense(d, d_ff, device=device, dtype=dtype)
        if kind == "gated_silu":
            self.wg = Dense(d, d_ff, device=device, dtype=dtype)
        self.wo = Dense(d_ff, d, device=device, dtype=dtype)

    def reset(self, gen: torch.Generator | None) -> None:
        for sub in (self.wi, getattr(self, "wg", None), self.wo):
            if sub is not None:
                sub.reset(gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mlp_apply(self, x, self.kind)


def init_norm(d: int, dtype=torch.float32, with_bias: bool = False, device=None) -> Norm:
    return Norm(d, with_bias=with_bias, device=device, dtype=dtype)


def rms_norm(p: Norm, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps) * p.scale.float()
    return out.to(x.dtype)


def layer_norm(p: Norm, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, correction=0)  # jnp.var: population
    out = (x32 - mu) * torch.rsqrt(var + eps) * p.scale.float()
    if hasattr(p, "bias"):
        out = out + p.bias.float()
    return out.to(x.dtype)


def init_embedding(gen: torch.Generator | None, vocab: int, d: int, dtype=torch.float32,
                   device=None) -> Embedding:
    e = Embedding(vocab, d, device=device, dtype=dtype)
    e.reset(gen)
    return e


def embed(p: Embedding, tokens: torch.Tensor) -> torch.Tensor:
    """The rows of ``table`` at ``tokens`` (vocab-parallel on a sharded
    DTensor table: ``sharding.api.vocab_rows``)."""
    return vocab_rows(p.table, tokens)


def unembed(p: Embedding, x: torch.Tensor) -> torch.Tensor:
    """Tied unembedding: logits = x @ table^T (f32)."""
    return torch.matmul(x.float(), p.table.float().t())


def rotary(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """RoPE on the last dim of x: (..., S, H, Dh), positions (..., S). The
    two halves of the last dim rotate together (not interleaved pairs)."""
    dh = x.shape[-1]
    half = dh // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32, device=x.device) / half))
    ang = positions.float()[..., None] * freqs  # (..., S, half)
    cos = torch.cos(ang)[..., None, :]  # broadcast over heads
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def init_dense(gen: torch.Generator | None, d_in: int, d_out: int, dtype=torch.float32,
               scale: float | None = None, device=None) -> Dense:
    m = Dense(d_in, d_out, device=device, dtype=dtype)
    m.reset(gen, scale)
    return m


def dense(p: Dense, x: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x, p.w)


def init_mlp(gen: torch.Generator | None, d: int, d_ff: int, kind: str, dtype=torch.float32,
             device=None) -> MLP:
    m = MLP(d, d_ff, kind, device=device, dtype=dtype)
    m.reset(gen)
    return m


def mlp_apply(p: MLP, x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "gated_silu":
        h = F.silu(dense(p.wi, x)) * dense(p.wg, x)
    elif kind == "squared_relu":
        h = torch.square(F.relu(dense(p.wi, x)))
    elif kind == "gelu":
        h = F.gelu(dense(p.wi, x), approximate="tanh")  # jax.nn.gelu's default
    else:
        raise ValueError(f"unknown mlp kind {kind!r}")
    return dense(p.wo, h)
