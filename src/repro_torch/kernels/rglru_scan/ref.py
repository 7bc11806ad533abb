"""Oracle of the RG-LRU linear recurrence: the sequential scan."""
from __future__ import annotations

import torch

__all__ = ["rglru_scan_ref", "scan_ref"]


def rglru_scan_ref(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t along axis 1. a, b: (B, S, D); h0 (B, D)."""
    h = h0
    hs = []
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1)


def scan_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t with h_{-1} = 0. a, b: (B, S, D)."""
    return rglru_scan_ref(a, b, torch.zeros_like(a[:, 0]))
