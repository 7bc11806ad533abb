"""Oracle of the WKV recurrence: the sequential scan over time."""
from __future__ import annotations

import torch

__all__ = ["wkv_scan_ref", "scan_ref"]


def wkv_scan_ref(r, k, v, w, u, S0):
    """Oracle wkv recurrence.

    r,k,v: (B, S, H, n); w: (B, S, H, n) decay in (0,1); u: (H, n) bonus;
    S0: (B, H, n, n). Returns (out (B,S,H,n), S_final).
    S layout: S[b,h,i,j] accumulates k_i v_j.
    """
    S = S0
    outs = []
    for t in range(r.shape[1]):
        r_t, k_t, v_t, w_t = r[:, t], k[:, t], v[:, t], w[:, t]  # (B, H, n)
        kv = torch.einsum("bhi,bhj->bhij", k_t, v_t)
        outs.append(torch.einsum("bhi,bhij->bhj", r_t, S + u[None][..., None] * kv))
        S = w_t[..., None] * S + kv
    return torch.stack(outs, dim=1), S


def scan_ref(r, k, v, w, u):
    """out only (state discarded); S_0 = 0."""
    B, S, H, n = r.shape
    S0 = torch.zeros((B, H, n, n), dtype=torch.float32, device=r.device)
    out, _ = wkv_scan_ref(r, k, v, w, u, S0)
    return out
