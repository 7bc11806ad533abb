"""The entry point of the RG-LRU scan and its cost model."""
from __future__ import annotations

import torch

from repro_torch.kernels.rglru_scan.rglru_scan import rglru_scan

__all__ = ["linear_recurrence", "launch_cost"]


def linear_recurrence(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t along axis 1, h_{-1} = 0. a, b: (B, S, D)
    float32. Unlike the reference's wrapper nothing is padded: the kernel
    takes any S and D."""
    return rglru_scan(a, b)


def launch_cost(*, B: int, S: int, D: int) -> dict:
    """Per-call cost of ``rglru_scan``: a and b read once, h written once
    (float32), and a multiply and an add per element."""
    n = B * S * D
    return {"launches": 1, "bytes": 4 * 3 * n, "flops": 2 * n}
