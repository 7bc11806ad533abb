"""The benchmark's data: synthetic sets with a published signature, made on
the device from the seed, and their partition over the m nodes.

The model is the program's own data generator's (``data/svm_datasets.py``,
which is O(n*d) on the host), rewritten for the device:

* every row has exactly ``k`` nonzero columns, drawn without replacement,
  uniformly or, with ``col_skew`` > 0, with Zipf popularity
  P(col = r) ~ (r + 1)^-skew (frequency-ranked ids). Draws with replacement,
  keeping the first k distinct ones in draw order, are exactly (weighted)
  sampling without replacement. A row takes ``first_draws`` draws, twice
  as many again if it falls short; uniform columns whose (rows, d) keys fit
  ``DRAW_BUDGET``, and rows whose draws would reach d, take the k largest
  of d random keys instead. No call's matrix holds more than
  ``DRAW_BUDGET`` elements or one row, so wide rows (webspam's 3,727 of
  16.6 M) draw in bounded memory;
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

import math
from typing import NamedTuple

import torch

from perfbench.reference import Fleet

ZIPF_DRAWS = 320        # the fewest draws a row before its first k distinct are taken
ROW_CHUNK = 1 << 16     # the most rows drawn together
# the most elements of one call's draw or key matrix: ccat's and kdda's calls,
# 65,536 rows of 320 draws, and reuters' 7,770 x 8,315 keys, fit as they are
DRAW_BUDGET = ROW_CHUNK * 1280
SPREAD = 4.0            # standard deviations by which the first draw count clears k
BLOCK = 128             # the d-block width of the program's touched-block bound


class Split(NamedTuple):
    """Rows as dense ``X`` (n, d) or ELL ``cols``/``vals`` (n, k), labels ``y``."""

    y: torch.Tensor
    X: torch.Tensor | None = None
    cols: torch.Tensor | None = None
    vals: torch.Tensor | None = None


def nnz_per_row(config: dict) -> int:
    return max(1, round(config["sparsity"] * config["d"]))


def zipf_cdf(d: int, skew: float, dev) -> torch.Tensor:
    """The cumulative Zipf law over ranks 0 ... d-1, P(r) ~ (r + 1)^-skew.
    The running sum is taken on the host: CUDA's floating-point cumsum is not
    deterministic (past one tile its order of addition varies from run to
    run), and a cdf whose last bits vary moves the draws near its steps."""
    w = torch.arange(1, d + 1, dtype=torch.float64, device=dev) ** -skew
    cdf = (torch.cumsum(w.cpu(), 0) / w.sum().cpu()).to(dev)
    cdf[-1] = 1.0
    return cdf


def first_draws(k: int, d: int, p: torch.Tensor | None) -> int:
    """The fewest draws ``ZIPF_DRAWS * 2**j``, up to ``d``, whose expected
    count of distinct columns is at least ``k`` plus ``SPREAD`` standard
    deviations, so that nearly every row has k at its first draw. A column
    of probability p_r (``p``; uniform where None) is drawn at least once
    in N draws with probability q_r = 1 - (1 - p_r)^N; the count's variance
    is at most the sum of q_r (1 - q_r), the indicators being negatively
    correlated."""
    draws = ZIPF_DRAWS
    while draws < d:
        if p is None:
            q = -math.expm1(draws * math.log1p(-1.0 / d))
            mean, var = d * q, d * q * (1.0 - q)
        else:
            q = -torch.expm1(draws * torch.log1p(-p))
            mean, var = float(q.sum()), float((q * (1.0 - q)).sum())
        if mean >= k + SPREAD * math.sqrt(var):
            break
        draws *= 2
    return draws


def _top_keys(g: torch.Generator, n: int, k: int, d: int, p: torch.Tensor | None,
              dev) -> torch.Tensor:
    """Each row's k largest of d random keys: u uniform, or log(u) / p_r, the
    exponential race that is weighted sampling without replacement."""
    out = torch.empty((n, k), dtype=torch.int32, device=dev)
    step = min(ROW_CHUNK, max(1, DRAW_BUDGET // d))
    for s in range(0, n, step):
        e = min(n, s + step)
        keys = torch.rand((e - s, d), generator=g, device=dev)
        if p is not None:
            keys = keys.log_().div_(p)
        out[s:e] = keys.topk(k, dim=1).indices.sort(dim=1).values
    return out


def _first_distinct(g: torch.Generator, n: int, k: int, d: int, cdf: torch.Tensor | None,
                    draws: int, dev) -> torch.Tensor:
    """Each row's first k distinct columns in draw order, ascending: draws
    with replacement (from ``cdf``, or uniform where None), twice as many
    again for the rows that fall short."""
    out = torch.empty((n, k), dtype=torch.int32, device=dev)
    todo = torch.arange(n, device=dev)
    while todo.numel():
        left = []
        step = min(ROW_CHUNK, max(1, DRAW_BUDGET // draws))
        for s in range(0, todo.numel(), step):
            rows = todo[s:s + step]
            if cdf is None:
                idx = torch.randint(d, (rows.numel(), draws), generator=g, device=dev,
                                    dtype=torch.int32)
            else:
                u = torch.rand((rows.numel(), draws), generator=g, device=dev,
                               dtype=torch.float64)
                idx = torch.searchsorted(cdf, u, out_int32=True).clamp_(max=d - 1)
            srt, pos = torch.sort(idx, dim=1, stable=True)
            first = torch.ones_like(srt, dtype=torch.bool)
            first[:, 1:] = srt[:, 1:] != srt[:, :-1]
            # a distinct value's rank in draw order: the first draws up to its own
            rank = torch.zeros_like(first).scatter_(1, pos, first).cumsum(
                1, dtype=torch.int32).gather(1, pos)
            ok = first.sum(1) >= k
            out[rows[ok]] = srt[ok][(first & (rank <= k))[ok]].view(-1, k)
            left.append(rows[~ok])
        todo = torch.cat(left)
        draws *= 2
    return out


def columns(g: torch.Generator, n: int, k: int, d: int, skew: float, dev) -> torch.Tensor:
    """``n`` rows of ``k`` distinct columns of ``d``, each row ascending
    (int32), no call's matrix above ``DRAW_BUDGET`` elements or one row."""
    cdf = zipf_cdf(d, skew, dev) if skew > 0 else None
    if cdf is None and min(n, ROW_CHUNK) * d <= DRAW_BUDGET:
        return _top_keys(g, n, k, d, None, dev)
    p = None if cdf is None else torch.diff(cdf, prepend=cdf.new_zeros(1))
    draws = first_draws(k, d, p)
    if draws >= d:
        return _top_keys(g, n, k, d, None if p is None else p.float(), dev)
    return _first_distinct(g, n, k, d, cdf, draws, dev)


def make_split(config: dict, g: torch.Generator, n: int, w_star: torch.Tensor,
               dense: bool) -> Split:
    """``n`` rows of the configuration's signature."""
    d, k, dev = config["d"], nnz_per_row(config), w_star.device
    skew = float(config.get("col_skew", 0.0))
    cols = columns(g, n, k, d, skew, dev)
    vals = torch.randn((n, k), generator=g, device=dev).abs_()
    vals /= torch.linalg.vector_norm(vals, dim=1, keepdim=True).clamp_(min=1e-8)
    margin = (vals * w_star[cols]).sum(1)
    thr = torch.quantile(margin, 1.0 - config["class_balance"])
    y = torch.where(margin > thr, 1.0, -1.0)
    flip = torch.rand((n,), generator=g, device=dev) < config["label_noise"]
    y = torch.where(flip, -y, y)
    if dense:
        X = torch.zeros((n, d), dtype=torch.float32, device=dev).scatter_(1, cols.long(), vals)
        return Split(y, X=X)
    return Split(y, cols=cols, vals=vals)


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
    are ascending and pad entries have value 0. Counted in chunks of at most
    ``DRAW_BUDGET`` entries."""
    k = fleet.cols.shape[-1]
    cols, vals = fleet.cols.flatten(0, -2), fleet.vals.flatten(0, -2)
    step = max(1, DRAW_BUDGET // k)
    per_row = []
    for s in range(0, cols.shape[0], step):
        blocks = cols[s:s + step] // blk_d
        new = vals[s:s + step] != 0
        new[:, 1:] &= blocks[:, 1:] != blocks[:, :-1]
        per_row.append(new.sum(-1))
    per_row = torch.cat(per_row).view(fleet.cols.shape[:-1])
    top = per_row.topk(min(batch_size, per_row.shape[1]), dim=1).values.sum(1)
    n_blocks = -(-fleet.d // blk_d)
    return max(1, min(int(top.max()), n_blocks, max(1, batch_size * k)))
