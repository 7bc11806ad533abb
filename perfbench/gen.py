"""The benchmark's data: synthetic sets with a published signature, made on
the device from the seed, and their partition over the m nodes.

The model is the program's own data generator's (``data/svm_datasets.py``,
which is O(n*d) on the host), rewritten for the device:

* every row has exactly ``k`` nonzero columns, drawn without replacement,
  uniformly or, with ``col_skew`` > 0, with Zipf popularity
  P(col = r) ~ (r + 1)^-skew (frequency-ranked ids). Draws with replacement
  from the Zipf law, keeping the first k distinct ones in draw order, are
  exactly weighted sampling without replacement;
* values are |N(0, 1)|, each row scaled to unit norm;
* labels are the sign of <x, w*> with w* = |N(0, 1)^d|, thresholded at the
  ``1 - class_balance`` quantile of the margins, then flipped with
  probability ``label_noise``.

Training rows are shuffled and split over m nodes as the program's
``partition`` splits them: the first n % m nodes hold one row more, the
rest are padded with zero rows whose label is 0. Everything is made with
one ``torch.Generator`` on the device, in a few large calls.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from perfbench.reference import Fleet

ZIPF_DRAWS = 320        # draws a row before its first k distinct are taken
ROW_CHUNK = 1 << 16     # rows drawn together
BLOCK = 128             # the d-block width of the program's touched-block bound


class Split(NamedTuple):
    """Rows as dense ``X`` (n, d) or ELL ``cols``/``vals`` (n, k), labels ``y``."""

    y: torch.Tensor
    X: torch.Tensor | None = None
    cols: torch.Tensor | None = None
    vals: torch.Tensor | None = None


def nnz_per_row(config: dict) -> int:
    return max(1, round(config["sparsity"] * config["d"]))


def _uniform_cols(g: torch.Generator, n: int, k: int, d: int, dev) -> torch.Tensor:
    out = torch.empty((n, k), dtype=torch.int64, device=dev)
    for s in range(0, n, ROW_CHUNK):
        e = min(n, s + ROW_CHUNK)
        out[s:e] = torch.rand((e - s, d), generator=g, device=dev).topk(k, dim=1).indices
    return out


def _zipf_cols(g: torch.Generator, n: int, k: int, d: int, skew: float, dev) -> torch.Tensor:
    w = torch.arange(1, d + 1, dtype=torch.float64, device=dev) ** -skew
    cdf = torch.cumsum(w, 0) / w.sum()
    cdf[-1] = 1.0
    out = torch.empty((n, k), dtype=torch.int64, device=dev)
    todo = torch.arange(n, device=dev)
    draws = ZIPF_DRAWS
    while todo.numel():
        left = []
        for s in range(0, todo.numel(), ROW_CHUNK):
            rows = todo[s:s + ROW_CHUNK]
            u = torch.rand((rows.numel(), draws), generator=g, device=dev, dtype=torch.float64)
            idx = torch.searchsorted(cdf, u).clamp_(max=d - 1)
            srt, pos = torch.sort(idx, dim=1, stable=True)
            first = torch.ones_like(srt, dtype=torch.bool)
            first[:, 1:] = srt[:, 1:] != srt[:, :-1]
            # draw positions of the distinct values, earliest first
            order = torch.where(first, pos, draws).sort(dim=1).values[:, :k]
            ok = first.sum(1) >= k
            out[rows[ok]] = idx[ok].gather(1, order[ok])
            left.append(rows[~ok])
        todo = torch.cat(left)
        draws *= 2
    return out


def make_split(config: dict, g: torch.Generator, n: int, w_star: torch.Tensor,
               dense: bool) -> Split:
    """``n`` rows of the configuration's signature."""
    d, k, dev = config["d"], nnz_per_row(config), w_star.device
    skew = float(config.get("col_skew", 0.0))
    cols = (_zipf_cols(g, n, k, d, skew, dev) if skew > 0
            else _uniform_cols(g, n, k, d, dev)).sort(dim=1).values
    vals = torch.randn((n, k), generator=g, device=dev).abs_()
    vals /= torch.linalg.vector_norm(vals, dim=1, keepdim=True).clamp_(min=1e-8)
    margin = (vals * w_star[cols]).sum(1)
    thr = torch.quantile(margin, 1.0 - config["class_balance"])
    y = torch.where(margin > thr, 1.0, -1.0)
    flip = torch.rand((n,), generator=g, device=dev) < config["label_noise"]
    y = torch.where(flip, -y, y)
    if dense:
        X = torch.zeros((n, d), dtype=torch.float32, device=dev).scatter_(1, cols, vals)
        return Split(y, X=X)
    return Split(y, cols=cols.to(torch.int32), vals=vals)


def partition(split: Split, m: int, d: int, g: torch.Generator) -> Fleet:
    """Shuffle the rows and split them over m nodes, zero-padded to a common
    n_i = ceil(n/m); the first n % m nodes hold one row more."""
    n = split.y.shape[0]
    dev = split.y.device
    if n < m:
        raise ValueError(f"cannot partition {n} rows over {m} nodes")
    n_i = -(-n // m)
    counts = torch.full((m,), n // m, dtype=torch.int64, device=dev)
    counts[: n % m] += 1
    starts = torch.cumsum(counts, 0) - counts
    slot = torch.arange(n_i, device=dev)
    valid = slot[None, :] < counts[:, None]
    src = torch.randperm(n, generator=g, device=dev)[
        (starts[:, None] + slot[None, :]).clamp(max=n - 1)]

    def lay(a: torch.Tensor) -> torch.Tensor:
        out = a[src]
        return out * valid.view(valid.shape + (1,) * (out.dim() - 2)).to(out.dtype)

    y = lay(split.y)
    if split.X is not None:
        return Fleet(y, counts, d, X=lay(split.X))
    return Fleet(y, counts, d, cols=lay(split.cols), vals=lay(split.vals))


def make(config: dict, m: int, seed: int, device) -> tuple[Fleet, Split]:
    """The partitioned training set over ``m`` nodes and the test split, from
    ``seed``."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    d = config["d"]
    dense = config["storage"] == "dense"
    w_star = torch.randn((d,), generator=g, device=device).abs_()
    train = make_split(config, g, config["n_train"], w_star, dense)
    test = make_split(config, g, config["n_test"], w_star, dense)
    return partition(train, m, d, g), test


def block_bound(fleet: Fleet, batch_size: int, blk_d: int = BLOCK) -> int:
    """The program's static cap on the distinct d-blocks a minibatch can
    touch (its ``minibatch_block_bound``): the largest, over nodes, sum of
    the ``batch_size`` largest per-row distinct-block counts, clamped to the
    number of blocks and to ``batch_size * k``; at least 1. Rows' columns
    are ascending and pad entries have value 0."""
    cols, vals = fleet.cols, fleet.vals
    k = cols.shape[-1]
    blocks = cols.long() // blk_d
    live = vals != 0
    new = torch.ones_like(live)
    new[..., 1:] = blocks[..., 1:] != blocks[..., :-1]
    per_row = (new & live).sum(-1)
    top = per_row.topk(min(batch_size, per_row.shape[1]), dim=1).values.sum(1)
    n_blocks = -(-fleet.d // blk_d)
    return max(1, min(int(top.max()), n_blocks, max(1, batch_size * k)))
