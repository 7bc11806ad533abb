"""Serving buckets: the small fixed set of batch shapes sparse queries are
scored in.

A copy of the bucket half of ``repro.serve.batcher`` (the port imports
nothing of ``repro``): :class:`Bucket`, the doubling-``k`` ladder
:func:`bucket_ladder`, and :func:`calibrate_buckets`, which tightens each
rung's touched-block cap from representative queries. A batch of a bucket
is padded with ``repro_torch.sparse.formats.pad_query_planes``, so every
batch the server scores has one of ``len(buckets)`` shapes. The request
queue that drains into them (``MicroBatcher``) comes with the serving
control plane.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.sparse.formats import (DEFAULT_BUCKET_BLK_D, minibatch_block_bound,
                                        row_block_counts)

__all__ = ["Bucket", "bucket_ladder", "calibrate_buckets"]


@dataclass(frozen=True)
class Bucket:
    """One static serving shape: batches of ``rows`` queries padded to ``k``
    nonzeros each, scored with a ``n_blocks_max``-slot touched-block map."""

    rows: int
    k: int
    n_blocks_max: int

    def __post_init__(self):
        if self.rows < 1 or self.k < 1 or self.n_blocks_max < 1:
            raise ValueError(f"degenerate bucket {self}")


def bucket_ladder(k_max: int, *, rows: int = 8, min_k: int = 16, d: int = None,
                  blk_d: int = DEFAULT_BUCKET_BLK_D) -> tuple[Bucket, ...]:
    """Doubling-``k`` ladder up to ``k_max``: [min_k, 2·min_k, …, ≥ k_max].

    A doubling ladder bounds pad waste at 2× while keeping the shape set
    logarithmic in ``k_max``. ``n_blocks_max`` defaults to each rung's
    structural cap — tighten with :func:`calibrate_buckets`.
    """
    if k_max < 1:
        raise ValueError("k_max must be >= 1")
    n_d_blocks = -(-d // blk_d) if d else None
    ks = []
    k = min(min_k, k_max)
    while k < k_max:
        ks.append(k)
        k *= 2
    ks.append(k_max)

    def cap(k):
        structural = rows * k
        return max(1, min(structural, n_d_blocks) if n_d_blocks else structural)

    return tuple(Bucket(rows, k, cap(k)) for k in ks)


def calibrate_buckets(buckets, sample_cols: np.ndarray, sample_vals: np.ndarray,
                      d: int, *, blk_d: int = DEFAULT_BUCKET_BLK_D
                      ) -> tuple[Bucket, ...]:
    """Tighten every bucket's ``n_blocks_max`` from representative queries.

    ``sample_cols/vals``: (n, k) ELL planes of typical traffic (e.g. a slice
    of the training set). The cap per bucket is
    ``minibatch_block_bound(sample, batch_size=rows)``: sound for any
    ``rows`` sample-like queries, and on Zipf-distributed text features far
    below the structural bound."""
    counts = row_block_counts(sample_cols, sample_vals, blk_d)
    return tuple(
        Bucket(b.rows, b.k, minibatch_block_bound(
            sample_cols, sample_vals, b.rows, blk_d, d=d, counts=counts))
        for b in buckets)
