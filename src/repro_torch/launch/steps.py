"""Serve-side step factories of the transformer scaffolding.

The reference's steps take a params pytree; here the ``Model`` holds its
weights, so the steps take the batch (prefill) or the tokens, caches and
position (serve) alone. Both run without autograd. Training steps
(``TrainerConfig``, ``make_train_step``) are not ported yet (ROADMAP Queue A
item 2).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models.transformer import Model

__all__ = ["make_prefill_step", "make_serve_step"]


def make_prefill_step(model: Model) -> Callable:
    """Full-sequence inference forward (the prefill_32k shape): batch -> logits."""

    def prefill(batch):
        with torch.no_grad():
            logits, _ = model.forward(batch)
        return logits

    return prefill


def make_serve_step(model: Model) -> Callable:
    """One-token decode against a seq_len-deep cache (decode shapes):
    (tokens (B, 1), caches, pos) -> (logits (B, 1, V), caches)."""

    def serve(tokens, caches, pos):
        with torch.no_grad():
            return model.decode_step(tokens, caches, pos)

    return serve
