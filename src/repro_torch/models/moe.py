"""Mixture-of-Experts channel mixing (Mixtral / Qwen2-MoE style), the port of
``repro.models.moe``.

Capacity-based top-k routing per batch row (the reference routes each row
as its own group, a vmap over rows): softmax router probabilities, the top
k renormalised, each (token, choice) given the exclusive prefix count of
its expert as its capacity slot. Choices at or past the capacity go to a
sink slot and are dropped (they pass through the residual). Dispatch writes
the kept (expert, slot) pairs, which are distinct, with a plain indexed
write into zeros (the reference's add into zeros, with no float atomics);
the experts run as batched products over the (E, C, D) buffers; combine
gathers each kept choice's output and weights it. Auxiliary outputs: the
Switch load-balance loss and the router z-loss, scaled by ``aux_coef`` and
``router_z_coef``. The reference runs no Pallas kernel here; neither does
the port.

On a mesh the per-row work (routing, dispatch, combine and the per-row aux
terms) runs on each rank's own rows (``sharding.api.rows_local``): rows stay
sharded on the batch axes, as the reference's group vmap keeps them, and
the expert buffers are pinned with ``constrain`` at the reference's sites.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import layers as L
from repro_torch.models.config import MoEConfig
from repro_torch.sharding.api import constrain, rows_local

__all__ = ["MoE", "MoEAux", "Routing", "capacity", "route", "moe_apply"]


class MoEAux(NamedTuple):
    load_balance_loss: torch.Tensor
    router_z_loss: torch.Tensor
    expert_fraction: torch.Tensor  # (E,) fraction of top-1 tokens per expert


class MoE(nn.Module):
    """``router`` (D, E) in float32, the stacked expert FFNs ``wi`` and ``wg``
    (E, D, F) and ``wo`` (E, F, D), and the optional ``shared`` MLP."""

    def __init__(self, d_model: int, cfg: MoEConfig, mlp_kind: str, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        e, dff = cfg.n_experts, cfg.d_expert
        self.router = nn.Parameter(torch.empty((d_model, e), device=device, dtype=torch.float32))
        for name, shape in (("wi", (e, d_model, dff)), ("wg", (e, d_model, dff)),
                            ("wo", (e, dff, d_model))):
            setattr(self, name, nn.Parameter(torch.empty(shape, device=device, dtype=dtype)))
        if cfg.d_shared:
            self.shared = L.MLP(d_model, cfg.d_shared, mlp_kind, device=device, dtype=dtype)

    def reset(self, gen: torch.Generator | None) -> None:
        d_model, dff = self.wi.shape[1:]
        s_in, s_out = 1.0 / math.sqrt(d_model), 1.0 / math.sqrt(dff)
        L.normal_(self.router, gen, s_in)
        L.normal_(self.wi, gen, s_in)
        L.normal_(self.wg, gen, s_in)
        L.normal_(self.wo, gen, s_out)
        if hasattr(self, "shared"):
            self.shared.reset(gen)


def capacity(n_tokens: int, cfg: MoEConfig) -> int:
    c = int(cfg.capacity_factor * cfg.top_k * n_tokens / cfg.n_experts)
    return max(cfg.top_k, min(n_tokens, c))


class Routing(NamedTuple):
    logits: torch.Tensor   # (B, S, E) float32
    probs: torch.Tensor    # (B, S, E)
    topv: torch.Tensor     # (B, S, k) renormalised
    topi: torch.Tensor     # (B, S, k) expert ids
    pos: torch.Tensor      # (B, S, k) rank within the expert (capacity slot)
    keep: torch.Tensor     # (B, S, k) pos < capacity


def route(router: torch.Tensor, x: torch.Tensor, cfg: MoEConfig, cap: int) -> Routing:
    """Top-k routing of every row of x (B, S, D), each row on its own."""
    e, k = cfg.n_experts, cfg.top_k
    b, s, _ = x.shape
    logits = torch.einsum("bsd,de->bse", x.float(), router)
    probs = torch.softmax(logits, dim=-1)
    topv, topi = torch.topk(probs, k, dim=-1)
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    onehot = F.one_hot(topi, e)                                  # (B, S, k, E)
    flat = onehot.reshape(b, s * k, e)
    ranks = torch.cumsum(flat, dim=1) - flat                     # exclusive prefix count
    pos = torch.sum(ranks.reshape(b, s, k, e) * onehot, dim=-1)  # (B, S, k)
    return Routing(logits, probs, topv, topi, pos, pos < cap)


def _dispatch(x: torch.Tensor, router: torch.Tensor, cfg: MoEConfig, cap: int):
    """Per-row routing and dispatch of x (B, S, D): the expert buffers xe
    (B, E, C, D), each (token, choice)'s expert id and slot (B, S·k), its
    combine weight (B, S·k), and the per-row load-balance term, z term and
    top-1 fractions (B,), (B,), (B, E)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    r = route(router, x, cfg, cap)
    eid = r.topi.reshape(b, s * k)
    slot = torch.where(r.keep, r.pos, cap).reshape(b, s * k)    # overflow -> sink slot
    rows = torch.arange(b, device=x.device)[:, None]
    toks = x[:, :, None, :].expand(b, s, k, d).reshape(b, s * k, d)
    # dispatch into (B, E, C+1, D); slot C is the sink. The kept (expert,
    # slot) pairs are distinct, so a plain write is the reference's add into
    # zeros; the sink's writes collide and are dropped with it
    xe = torch.zeros((b, e, cap + 1, d), dtype=x.dtype, device=x.device)
    xe = xe.index_put_((rows, eid, slot), toks)[:, :, :cap]
    w = (r.topv.reshape(b, s * k) * r.keep.reshape(b, s * k)).to(x.dtype)
    frac_routed = torch.mean(F.one_hot(r.topi[..., 0], e).float(), dim=1)   # (B, E)
    mean_prob = torch.mean(r.probs, dim=1)
    lb = e * torch.sum(frac_routed * mean_prob, dim=-1)
    z = torch.mean(torch.square(torch.logsumexp(r.logits, dim=-1)), dim=-1)
    return xe, eid, slot, w, lb, z, frac_routed


def _combine(ye: torch.Tensor, eid: torch.Tensor, slot: torch.Tensor, w: torch.Tensor,
             cap: int, k: int) -> torch.Tensor:
    """Gather each kept choice's expert output from ye (B, E, C, D), weight
    it and sum over the k choices: (B, S, D)."""
    b, d = ye.shape[0], ye.shape[-1]
    rows = torch.arange(b, device=ye.device)[:, None]
    gathered = ye[rows, eid, torch.clamp(slot, max=cap - 1)]    # (B, S*k, D)
    return torch.sum((gathered * w[..., None]).reshape(b, -1, k, d), dim=2)


def moe_apply(p: MoE, x: torch.Tensor, cfg: MoEConfig, mlp_kind: str) -> tuple[torch.Tensor, MoEAux]:
    """x: (B, S, D) -> ((B, S, D), MoEAux). Routing is per batch row."""
    cap = capacity(x.shape[1], cfg)
    xe, eid, slot, w, lb, z, frac_routed = rows_local(
        lambda x, router: _dispatch(x, router, cfg, cap), (x,), (p.router,), n_out=7)
    xe = constrain(xe, ("batch", "expert", "capacity", "embed"))
    h = torch.einsum("becd,edf->becf", xe, p.wi)
    g = torch.einsum("becd,edf->becf", xe, p.wg)
    h = constrain(h, ("batch", "expert", "capacity", "mlp"))
    g = constrain(g, ("batch", "expert", "capacity", "mlp"))
    ye = torch.einsum("becf,efd->becd", F.silu(h) * g, p.wo)     # (B, E, C, D)
    ye = constrain(ye, ("batch", "expert", "capacity", "embed"))
    y = rows_local(lambda ye, eid, slot, w: _combine(ye, eid, slot, w, cap, cfg.top_k),
                   (ye, eid, slot, w))
    if hasattr(p, "shared"):
        y = y + L.mlp_apply(p.shared, x, mlp_kind)
    return y, MoEAux(load_balance_loss=torch.mean(lb) * cfg.aux_coef,
                     router_z_loss=torch.mean(z) * cfg.router_z_coef,
                     expert_fraction=torch.mean(frac_routed, dim=0))
