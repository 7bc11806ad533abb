"""The GQA entry point of flash attention and its cost model."""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.flash_attention import flash_attention, live_pairs

__all__ = ["gqa_flash_attention", "live_pairs", "launch_cost"]


def gqa_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B, S, H, Dh); k/v: (B, S, Hkv, Dh) -> (B, S, H, Dh).

    The kernel reads the kv head of each query head itself, so unlike the
    reference's wrapper nothing is moved, repeated or padded: one launch.
    """
    return flash_attention(q, k, v, causal=causal, window=window)


def launch_cost(*, B: int, S: int, H: int, Hkv: int, dh: int, causal: bool = True,
                window: int = 0, itemsize: int = 4) -> dict:
    """Per-call cost of ``flash_attention``, from shapes alone.

    Returns ``{"launches", "bytes", "flops", "live_pairs"}``: q, k and v each
    read once and the output written once (``itemsize`` bytes an element),
    and 4·dh flops for each live (query, key) pair of each (batch, query
    head): 2·dh for the score and 2·dh for the weighted sum of v.
    """
    pairs = live_pairs(S, causal=causal, window=window)
    return {"launches": 1, "bytes": itemsize * B * S * dh * (2 * H + 2 * Hkv),
            "flops": 4 * dh * H * B * pairs, "live_pairs": B * H * pairs}
