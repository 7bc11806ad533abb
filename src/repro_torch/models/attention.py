"""Grouped-query attention: full / sliding-window / local, train + decode.

Full-sequence attention (training / prefill) runs the ``flash_attention``
kernel through ``kernels.flash_attention.ops.gqa_flash_attention``: on a
CUDA tensor it launches the kernel, on a CPU tensor it takes the kernel's
plain version. One-token decode stays plain PyTorch (``_attend``), as in
the reference, which runs no kernel there.

Layouts: activations (B, S, D); q/k/v (B, S, H, Dh) with H_kv <= H (GQA).
KV cache for decode: (B, S_cache, H_kv, Dh) absolute-position layout for full
attention, ring layout (pos % window) for SWA, so a windowed cache holds
O(window) slots instead of O(seq).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.distributed.tensor
from torch import nn

from repro_torch.kernels.flash_attention.ops import gqa_flash_attention
from repro_torch.models import layers as L
from repro_torch.sharding.api import constrain, gathered

__all__ = ["Attention", "KVCache", "init_attention", "attention_train", "attention_decode",
           "init_kv_cache"]

NEG_INF = -1e30


class Attention(nn.Module):
    """``wq`` (D, H, Dh), ``wk`` / ``wv`` (D, Hkv, Dh), ``wo`` (H, Dh, D)."""

    def __init__(self, d_model: int, n_heads: int, n_kv_heads: int, head_dim: int, *,
                 device=None, dtype=torch.float32):
        super().__init__()
        shapes = {"wq": (d_model, n_heads, head_dim), "wk": (d_model, n_kv_heads, head_dim),
                  "wv": (d_model, n_kv_heads, head_dim), "wo": (n_heads, head_dim, d_model)}
        for name, shape in shapes.items():
            setattr(self, name, nn.Parameter(torch.empty(shape, device=device, dtype=dtype)))

    def reset(self, gen: torch.Generator | None) -> None:
        d_model, n_heads, head_dim = self.wq.shape
        s = 1.0 / math.sqrt(d_model)
        for w in (self.wq, self.wk, self.wv):
            L.normal_(w, gen, s)
        L.normal_(self.wo, gen, 1.0 / math.sqrt(n_heads * head_dim))


def init_attention(gen: torch.Generator | None, d_model: int, n_heads: int, n_kv_heads: int,
                   head_dim: int, dtype=torch.float32, device=None) -> Attention:
    a = Attention(d_model, n_heads, n_kv_heads, head_dim, device=device, dtype=dtype)
    a.reset(gen)
    return a


class KVCache(NamedTuple):
    k: torch.Tensor      # (B, S_cache, H_kv, Dh)
    v: torch.Tensor      # (B, S_cache, H_kv, Dh)

    @property
    def size(self) -> int:
        return self.k.shape[1]


def init_kv_cache(batch: int, seq: int, n_kv: int, head_dim: int, window: int,
                  dtype=torch.bfloat16, device=None) -> KVCache:
    s_cache = min(seq, window) if window else seq
    shape = (batch, s_cache, n_kv, head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor,
            score_axes: tuple | None = None) -> torch.Tensor:
    """GQA-native softmax(q k^T / sqrt(dh) + mask) v, f32 softmax.

    q: (B,Sq,H,Dh); k/v: (B,Sk,Hkv,Dh) with Hkv | H — queries are grouped
    per kv head in the einsum itself, so K/V are never repeated. ``mask``
    broadcasts to (B, Sq, Sk). Types promote as in JAX: the scores in the
    wider of q's and k's types, the probabilities in v's. ``score_axes``:
    logical axes pinned onto the (B, Hkv, rep, Sq, Sk) scores and
    probabilities (decode keeps them sharded on the cache sequence).
    """
    b, sq, h, dh = q.shape
    hkv = k.shape[2]
    rep = h // hkv
    qk = torch.promote_types(q.dtype, k.dtype)
    qg = q.to(qk).reshape(b, sq, hkv, rep, dh)
    scores = torch.einsum("bqhrd,bkhd->bhrqk", qg, k.to(qk)).float() / math.sqrt(float(dh))
    scores = torch.where(mask[:, None, None], scores, NEG_INF)  # mask (B|1, Sq, Sk)
    if score_axes is not None:
        scores = constrain(scores, score_axes)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    if score_axes is not None:
        probs = constrain(probs, score_axes)
    out = torch.einsum("bhrqk,bkhd->bqhrd", probs, v)
    return out.reshape(b, sq, h, dh)


def _project_qkv(p: Attention, x: torch.Tensor):
    q = torch.einsum("bsd,dhk->bshk", x, gathered(p.wq, (1,)))
    k = torch.einsum("bsd,dhk->bshk", x, gathered(p.wk, (1,)))
    v = torch.einsum("bsd,dhk->bshk", x, gathered(p.wv, (1,)))
    return q, k, v


def _out(p: Attention, o: torch.Tensor) -> torch.Tensor:
    wo = gathered(p.wo, (0,)).to(torch.promote_types(o.dtype, p.wo.dtype))
    return torch.einsum("bshk,hkd->bsd", o.to(wo.dtype), wo)


def attention_train(p: Attention, x: torch.Tensor, positions: torch.Tensor, *,
                    window: int = 0, causal: bool = True,
                    rope_theta: float = 10000.0) -> torch.Tensor:
    """Full-sequence attention (training / prefill), through flash attention."""
    q, k, v = _project_qkv(p, x)
    q = L.rotary(q, positions, rope_theta)
    k = L.rotary(k, positions, rope_theta)
    out = gqa_flash_attention(q, k, v, causal=causal, window=window)
    return _out(p, out)


def attention_decode(p: Attention, x: torch.Tensor, cache: KVCache, pos: int, *,
                     window: int = 0, rope_theta: float = 10000.0) -> tuple[torch.Tensor, KVCache]:
    """One-token decode: x (B, 1, D), ``pos`` an int (same for all rows).

    Full attention: write at absolute slot ``pos``, attend over slots <= pos.
    SWA: ring slot ``pos % window``, attend over the last ``window`` slots.
    The new key and value are written into ``cache`` in place (the reference
    returns a new cache; this keeps one copy of a long cache), and the same
    cache is returned. A DTensor cache (sharded on the cache sequence) takes
    the reference's masked write instead, which every shard does locally,
    and a new cache is returned.
    """
    b = x.shape[0]
    q, k_new, v_new = _project_qkv(p, x)
    posb = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q = L.rotary(q, posb, rope_theta)
    k_new = L.rotary(k_new, posb, rope_theta)
    # flash-decode sharding: q heads replicated, so the scores inherit the
    # cache's sequence sharding
    q = constrain(q, ("batch", None, "heads_dec", None))

    s_cache = cache.size
    slot = (pos % window) if window else pos
    if isinstance(cache.k, torch.distributed.tensor.DTensor):
        write = (torch.arange(s_cache, device=x.device) == slot)[None, :, None, None]
        cache = KVCache(k=torch.where(write, k_new.to(cache.k.dtype), cache.k),
                        v=torch.where(write, v_new.to(cache.v.dtype), cache.v))
    else:
        cache.k[:, slot] = k_new[:, 0].to(cache.k.dtype)
        cache.v[:, slot] = v_new[:, 0].to(cache.v.dtype)

    slots = torch.arange(s_cache, device=x.device)
    if window:
        # ring: slot i holds absolute position p_i = the latest p <= pos with p % window == i
        abs_pos = pos - torch.remainder(pos - slots, window)
        valid = (abs_pos >= 0) & (abs_pos >= pos - window + 1)
    else:
        valid = slots <= pos
    out = _attend(q, cache.k, cache.v, valid[None, None, :],
                  score_axes=("batch", "kv_heads", "heads_dec", None, "cache_seq"))
    return _out(p, out), cache
