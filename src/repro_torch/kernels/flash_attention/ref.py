"""Plain PyTorch oracle for flash attention (the masking of
``models.attention``), on the reference kernel's (BH, S, dh) planes."""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.flash_attention import flash_attention_plain

__all__ = ["attention_ref"]


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0) -> torch.Tensor:
    """q, k, v: (BH, S, dh); each plane is one head of ``flash_attention_plain``."""
    return flash_attention_plain(q[:, :, None], k[:, :, None], v[:, :, None],
                                 causal=causal, window=window)[:, :, 0]
