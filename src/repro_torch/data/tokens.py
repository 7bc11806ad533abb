"""Deterministic synthetic token/batch pipeline for LM training: a copy of
``repro.data.tokens`` (numpy only), so the port draws the reference's stream
bit for bit.

Produces reproducible batches without any disk dataset (container is offline).
The stream is a mixture of Zipf-distributed unigrams and short repeated
motifs, so a language model has real (learnable) structure: loss drops well
below log(vocab) within a few hundred steps — which is what the end-to-end
examples assert.

Sharding: ``Batcher.local_slice(host_id, n_hosts)`` yields the per-host rows
of the global batch, matching how a multi-host pod feeds ``jit`` with
host-local data.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np

__all__ = ["TokenStreamConfig", "Batcher", "synthetic_tokens"]


@dataclass(frozen=True)
class TokenStreamConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2          # unigram skew
    motif_len: int = 8           # repeated n-gram length
    motif_prob: float = 0.35     # fraction of positions inside a copied motif


def synthetic_tokens(cfg: TokenStreamConfig, step: int) -> np.ndarray:
    """(global_batch, seq_len+1) int32 tokens for a given step (stateless)."""
    rng = np.random.default_rng((cfg.seed, step))
    B, S = cfg.global_batch, cfg.seq_len + 1
    # Zipf unigrams clipped to vocab
    base = rng.zipf(cfg.zipf_a, size=(B, S)).astype(np.int64)
    toks = (base - 1) % cfg.vocab_size
    # overlay motifs: copy an earlier window forward (gives in-context structure)
    n_motifs = max(1, int(cfg.motif_prob * S / cfg.motif_len))
    for _ in range(n_motifs):
        src = rng.integers(0, max(1, S - 2 * cfg.motif_len), size=B)
        dst = src + cfg.motif_len + rng.integers(0, cfg.motif_len, size=B)
        for b in range(B):
            e = min(S, dst[b] + cfg.motif_len)
            toks[b, dst[b]:e] = toks[b, src[b]:src[b] + (e - dst[b])]
    return toks.astype(np.int32)


class Batcher:
    """Stateless step->batch mapping with host-local slicing."""

    def __init__(self, cfg: TokenStreamConfig):
        self.cfg = cfg

    def global_batch(self, step: int) -> dict[str, np.ndarray]:
        toks = synthetic_tokens(self.cfg, step)
        return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}

    def local_slice(self, step: int, host_id: int, n_hosts: int) -> dict[str, np.ndarray]:
        b = self.cfg.global_batch
        if b % n_hosts:
            raise ValueError(f"global batch {b} not divisible by {n_hosts} hosts")
        per = b // n_hosts
        g = self.global_batch(step)
        sl = slice(host_id * per, (host_id + 1) * per)
        return {k: v[sl] for k, v in g.items()}

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.global_batch(step)
            step += 1
