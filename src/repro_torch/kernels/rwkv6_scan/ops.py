"""The entry point of the WKV scan and its cost model."""
from __future__ import annotations

import torch

from repro_torch.kernels.rwkv6_scan.rwkv6_scan import wkv_scan

__all__ = ["wkv", "launch_cost"]


def wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
        u: torch.Tensor) -> torch.Tensor:
    """RWKV-6 wkv. r,k,v,w: (B, S, H, n); u: (H, n); S_0 = 0. Unlike the
    reference's wrapper nothing is padded: the kernel takes any S."""
    return wkv_scan(r, k, v, w, u)


def launch_cost(*, B: int, S: int, H: int, n: int) -> dict:
    """Per-call cost of ``wkv_scan``: r, k, v, w and u read once and out
    written once (float32), and the least flops the function needs. The
    bonus term factors out, ``out_j = Σ_i r_i S_ij + v_j Σ_i r_i u_i k_i``,
    so a step and head costs 2·n² for r·S, 3·n² for the decayed update
    ``w_i S_ij + k_i v_j`` and 5·n for the bonus (3·n for its sum, 2·n to
    add it to each out_j)."""
    return {"launches": 1, "bytes": 4 * (5 * B * S * H * n + H * n),
            "flops": B * S * H * (5 * n * n + 5 * n)}
