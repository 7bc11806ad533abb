"""RWKV-6 "Finch" block (arXiv:2404.05892): attention-free time mixing with
data-dependent decay, plus RWKV channel mixing.

Time mixing (per head, head_dim = n):
    state S in R^{n x n};  per step t with receptance r, key k, value v, decay
    w_t (data-dependent, per channel) and bonus u:
        out_t = r_t @ (S_{t-1} + diag(u) k_t^T v_t)
        S_t   = diag(w_t) S_{t-1} + k_t^T v_t

Token shift: x'_t = lerp(x_t, x_{t-1}, mu) with per-projection learned mu
(the paper's LoRA-parameterized shifts are folded into per-channel mu plus a
low-rank data-dependent term for the decay, ddlerp_w).

The full-sequence path (S_0 = 0) runs the recurrence through the
``wkv_scan`` kernel (``kernels.rwkv6_scan.ops.wkv``); decode, one step from
a carried state, runs the plain oracle ``wkv_scan_ref``, as the reference
does on both paths.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.rwkv6_scan.ops import wkv
from repro_torch.kernels.rwkv6_scan.ref import wkv_scan_ref
from repro_torch.models import layers as L
from repro_torch.sharding.api import grad_like, split_ready

__all__ = ["RWKV6", "init_rwkv6_block", "time_mix_train", "channel_mix_train",
           "time_mix_decode", "channel_mix_decode", "RWKV6State",
           "wkv_scan_ref", "init_rwkv6_state"]

_DECAY_LORA = 32


class RWKV6State(NamedTuple):
    S: torch.Tensor          # (B, H, n, n) wkv state
    x_prev_tm: torch.Tensor  # (B, D) last token for time-mix shift
    x_prev_cm: torch.Tensor  # (B, D) last token for channel-mix shift


class RWKV6(nn.Module):
    """The block's weights under the reference's names."""

    def __init__(self, d_model: int, d_ff: int, head_dim: int, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        h = d_model // head_dim
        shapes = {
            "w_r": (d_model, d_model), "w_k": (d_model, d_model), "w_v": (d_model, d_model),
            "w_g": (d_model, d_model), "w_o": (d_model, d_model),
            "mu_r": (d_model,), "mu_k": (d_model,), "mu_v": (d_model,), "mu_g": (d_model,),
            "mu_w": (d_model,),
            "decay_base": (d_model,),
            "decay_lora_a": (d_model, _DECAY_LORA), "decay_lora_b": (_DECAY_LORA, d_model),
            "bonus_u": (h, head_dim),
            "cm_mu": (d_model,), "cm_wi": (d_model, d_ff), "cm_wo": (d_ff, d_model),
            "cm_wr": (d_model, d_model), "ln_x_scale": (d_model,),
        }
        f32 = ("decay_base", "bonus_u")  # float32 whatever the param dtype, as in the reference
        for name, shape in shapes.items():
            setattr(self, name, nn.Parameter(torch.empty(
                shape, device=device, dtype=torch.float32 if name in f32 else dtype)))

    def reset(self, gen: torch.Generator | None) -> None:
        d_model, d_ff = self.cm_wi.shape
        s = 1.0 / math.sqrt(d_model)
        for w in (self.w_r, self.w_k, self.w_v, self.w_g, self.w_o):
            L.normal_(w, gen, s)
        L.normal_(self.decay_lora_a, gen, s)
        L.normal_(self.decay_lora_b, gen, 0.01)
        L.normal_(self.bonus_u, gen, 0.1)
        L.normal_(self.cm_wi, gen, s)
        L.normal_(self.cm_wo, gen, 1.0 / math.sqrt(d_ff))
        L.normal_(self.cm_wr, gen, s)
        with torch.no_grad():
            for mu in (self.mu_r, self.mu_k, self.mu_v, self.mu_g, self.mu_w, self.cm_mu):
                mu.fill_(0.5)
            # decay base spread per channel (RWKV init: -6..-0.3 in log space)
            ratios = torch.arange(d_model, dtype=torch.float32, device=self.decay_base.device)
            self.decay_base.copy_(-6.0 + 5.7 * (ratios / max(1, d_model - 1)))
            self.ln_x_scale.fill_(1.0)  # group-norm on wkv output


def init_rwkv6_block(gen: torch.Generator | None, d_model: int, d_ff: int, head_dim: int,
                     dtype=torch.float32, device=None) -> RWKV6:
    m = RWKV6(d_model, d_ff, head_dim, device=device, dtype=dtype)
    m.reset(gen)
    return m


def _shift_train(x: torch.Tensor, x0: torch.Tensor) -> torch.Tensor:
    """x_{t-1} along seq axis; position 0 gets x0 (decode carry or zeros)."""
    return torch.cat([x0[:, None], x[:, :-1]], dim=1)


def _lerp(x, x_prev, mu):
    return x + (x_prev - x) * mu.to(x.dtype)


def _heads(x, head_dim):
    b, s, d = x.shape
    return split_ready(x, -1, d // head_dim).reshape(b, s, d // head_dim, head_dim)


def _time_mix(p: RWKV6, x: torch.Tensor, x_prev: torch.Tensor, S0: torch.Tensor | None,
              head_dim: int):
    """Shared by train (x: full seq, ``S0`` None: a zero state, through the
    kernel; the final state is not returned) and decode (x: one step from
    the carried ``S0``, plain)."""
    xs = x_prev
    r = torch.matmul(_lerp(x, xs, p.mu_r), p.w_r)
    k = torch.matmul(_lerp(x, xs, p.mu_k), p.w_k)
    v = torch.matmul(_lerp(x, xs, p.mu_v), p.w_v)
    g = F.silu(torch.matmul(_lerp(x, xs, p.mu_g), p.w_g))
    xw = _lerp(x, xs, p.mu_w)
    dd = torch.matmul(torch.matmul(xw, p.decay_lora_a), p.decay_lora_b)
    w = torch.exp(-torch.exp(p.decay_base.float() + dd.float()))  # (B,S,D) in (0,1)

    hd = head_dim
    rh, kh, vh = (_heads(t, hd).float().contiguous() for t in (r, k, v))
    wh = _heads(w, hd).contiguous()
    u = p.bonus_u.float().contiguous()
    if S0 is None:
        out, S = wkv(rh, kh, vh, wh, u), None
    else:
        out, S = wkv_scan_ref(rh, kh, vh, wh, u, S0)
    b, s, h, n = out.shape
    # per-head group norm (population variance, as jnp.var)
    o = (out - out.mean(-1, keepdim=True)) * torch.rsqrt(
        out.var(-1, keepdim=True, correction=0) + 1e-5)
    o = grad_like(o.reshape(b, s, h * n)) * p.ln_x_scale.float()
    o = o.to(x.dtype) * g
    return torch.matmul(o, p.w_o), S


def _channel_mix(p: RWKV6, x: torch.Tensor, x_prev: torch.Tensor) -> torch.Tensor:
    xk = _lerp(x, x_prev, p.cm_mu)
    rr = torch.sigmoid(torch.matmul(xk, p.cm_wr).float()).to(x.dtype)
    h = torch.square(F.relu(torch.matmul(xk, p.cm_wi)))
    return rr * torch.matmul(h, p.cm_wo)


def time_mix_train(p: RWKV6, x: torch.Tensor, head_dim: int) -> torch.Tensor:
    """Full-sequence time mixing; x is the post-norm stream (B, S, D)."""
    tm, _ = _time_mix(p, x, _shift_train(x, torch.zeros_like(x[:, 0])), None, head_dim)
    return tm


def channel_mix_train(p: RWKV6, x: torch.Tensor) -> torch.Tensor:
    """Full-sequence channel mixing; x is the post-norm stream (B, S, D)."""
    return _channel_mix(p, x, _shift_train(x, torch.zeros_like(x[:, 0])))


def init_rwkv6_state(batch: int, d_model: int, head_dim: int, dtype=torch.float32,
                     device=None) -> RWKV6State:
    h = d_model // head_dim
    return RWKV6State(
        S=torch.zeros((batch, h, head_dim, head_dim), dtype=torch.float32, device=device),
        x_prev_tm=torch.zeros((batch, d_model), dtype=dtype, device=device),
        x_prev_cm=torch.zeros((batch, d_model), dtype=dtype, device=device),
    )


def time_mix_decode(p: RWKV6, x: torch.Tensor, state: RWKV6State, head_dim: int):
    """One-token time mixing; x: (B, 1, D) post-norm."""
    tm, S = _time_mix(p, x, state.x_prev_tm[:, None], state.S, head_dim)
    return tm, state._replace(S=S, x_prev_tm=x[:, 0])


def channel_mix_decode(p: RWKV6, x: torch.Tensor, state: RWKV6State):
    """One-token channel mixing; x: (B, 1, D) post-norm."""
    cm = _channel_mix(p, x, state.x_prev_cm[:, None])
    return cm, state._replace(x_prev_cm=x[:, 0])
