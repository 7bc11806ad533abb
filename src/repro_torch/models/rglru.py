"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427).

Temporal-mixing block:  x -> [branch A: dense -> GeLU]  x  [branch B: dense ->
causal conv1d(w=4) -> RG-LRU] -> elementwise product -> dense out.

RG-LRU recurrence (per channel):
    r_t = sigmoid(W_a x_t + b_a)            recurrence gate
    i_t = sigmoid(W_x x_t + b_x)            input gate
    a_t = exp(-c * softplus(Lambda) * r_t)  data-dependent decay, c = 8
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The training / prefill path runs the linear recurrence through the
``rglru_scan`` kernel (``kernels.rglru_scan.ops.linear_recurrence``), a
sequential scan; the reference runs an associative scan there, whose
rounding differs. Decode is the single-step update carrying h as state.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.rglru_scan.ops import linear_recurrence
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref
from repro_torch.models import layers as L

__all__ = ["RGLRU", "init_rglru_block", "rglru_scan_ref", "rglru_train", "rglru_decode",
           "RGLRUState", "init_rglru_state", "CONV_WIDTH"]

CONV_WIDTH = 4
_C = 8.0  # decay sharpening constant from the Griffin paper


class RGLRUState(NamedTuple):
    h: torch.Tensor       # (B, D_rnn) recurrence carry
    conv: torch.Tensor    # (B, CONV_WIDTH-1, D_rnn) causal conv tail


class RGLRU(nn.Module):
    """The block's weights under the reference's names (``lambda`` included,
    reached as ``getattr(p, "lambda")``)."""

    def __init__(self, d_model: int, d_rnn: int | None = None, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        d_rnn = d_rnn or d_model
        shapes = {"w_gate_in": (d_model, d_rnn), "w_rnn_in": (d_model, d_rnn),
                  "conv_w": (CONV_WIDTH, d_rnn), "w_a": (d_rnn, d_rnn), "b_a": (d_rnn,),
                  "w_x": (d_rnn, d_rnn), "b_x": (d_rnn,), "w_out": (d_rnn, d_model)}
        for name, shape in shapes.items():
            self.register_parameter(name, nn.Parameter(torch.empty(shape, device=device,
                                                                   dtype=dtype)))
        self.register_parameter("lambda", nn.Parameter(torch.empty((d_rnn,), device=device,
                                                                   dtype=torch.float32)))

    def reset(self, gen: torch.Generator | None) -> None:
        d_model, d_rnn = self.w_gate_in.shape
        s = 1.0 / math.sqrt(d_model)
        for w in (self.w_gate_in, self.w_rnn_in, self.w_a, self.w_x):
            L.normal_(w, gen, s)
        L.normal_(self.conv_w, gen, 0.5)
        L.normal_(self.w_out, gen, 1.0 / math.sqrt(d_rnn))
        with torch.no_grad():
            self.b_a.zero_()
            self.b_x.zero_()
            # Lambda so that a^(1/c) = softplus^-1 decay spreads over [0.9, 0.999]
            u = torch.empty_like(self.b_a, dtype=torch.float32).uniform_(0.9, 0.999, generator=gen)
            getattr(self, "lambda").copy_(torch.log(torch.expm1(-torch.log(u) / _C)))


def init_rglru_block(gen: torch.Generator | None, d_model: int, d_rnn: int | None = None,
                     dtype=torch.float32, device=None) -> RGLRU:
    m = RGLRU(d_model, d_rnn, device=device, dtype=dtype)
    m.reset(gen)
    return m


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) as the reference's ``jax.nn.softplus`` writes it,
    max(x, 0) + log1p(e^-|x|), in ops every DTensor version shards."""
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def _gates(p: RGLRU, u: torch.Tensor):
    """u: (..., D_rnn) post-conv activations -> (a, beta_scaled_input)."""
    r = torch.sigmoid(torch.matmul(u, p.w_a).float() + p.b_a.float())
    i = torch.sigmoid(torch.matmul(u, p.w_x).float() + p.b_x.float())
    log_a = -_C * _softplus(getattr(p, "lambda").float()) * r
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return a, beta * i * u.float()


def _conv1d_train(p: RGLRU, x: torch.Tensor) -> torch.Tensor:
    """Causal depthwise conv, width CONV_WIDTH. x: (B, S, D). The zero
    history is concatenated, not padded in: DTensor shards ``cat`` in every
    version, ``F.pad``'s backward not."""
    pads = torch.cat([torch.zeros_like(x[:, :1]).expand(-1, CONV_WIDTH - 1, -1), x], dim=1)
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for w in range(CONV_WIDTH):
        out = out + pads[:, w:w + x.shape[1]].float() * p.conv_w[w].float()
    return out.to(x.dtype)


def rglru_train(p: RGLRU, x: torch.Tensor) -> torch.Tensor:
    """Full-sequence Griffin recurrent block. x: (B, S, D_model)."""
    gate = F.gelu(torch.matmul(x, p.w_gate_in), approximate="tanh")
    u = torch.matmul(x, p.w_rnn_in)
    u = _conv1d_train(p, u)
    a, b = _gates(p, u)
    h = linear_recurrence(a.contiguous(), b.contiguous()).to(x.dtype)
    return torch.matmul(h * gate, p.w_out)


def init_rglru_state(batch: int, d_rnn: int, dtype=torch.float32, device=None) -> RGLRUState:
    return RGLRUState(
        h=torch.zeros((batch, d_rnn), dtype=torch.float32, device=device),
        conv=torch.zeros((batch, CONV_WIDTH - 1, d_rnn), dtype=dtype, device=device),
    )


def rglru_decode(p: RGLRU, x: torch.Tensor, state: RGLRUState) -> tuple[torch.Tensor, RGLRUState]:
    """One-token step. x: (B, 1, D_model)."""
    gate = F.gelu(torch.matmul(x, p.w_gate_in), approximate="tanh")
    u = torch.matmul(x, p.w_rnn_in)  # (B, 1, D)
    hist = torch.cat([state.conv, u.to(state.conv.dtype)], dim=1)  # (B, W, D)
    u_c = torch.einsum("bwd,wd->bd", hist.float(), p.conv_w.float())[:, None].to(x.dtype)
    a, b = _gates(p, u_c)
    h = a[:, 0] * state.h + b[:, 0]
    y = torch.matmul(h.to(x.dtype) * gate[:, 0], p.w_out)[:, None]
    return y, RGLRUState(h=h, conv=hist[:, 1:])
