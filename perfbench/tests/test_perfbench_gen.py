"""The device data generator holds to its signature, at a small scale."""
from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench import gen

CCAT = dict(n_train=20000, n_test=500, d=3000, sparsity=0.01, col_skew=1.25,
            class_balance=0.47, label_noise=0.05, storage="ell", lam=1e-4)
REUTERS = dict(CCAT, d=1000, sparsity=0.02, col_skew=0.0, class_balance=0.3,
               label_noise=0.03, storage="dense", n_train=4000)


@pytest.fixture(scope="module")
def ccat():
    return gen.make(CCAT, 7, 2 ** 31 + 99, "cpu")


def test_exact_k_unit_nonnegative_rows(ccat):
    fleet, test = ccat
    k = gen.nnz_per_row(CCAT)
    live = fleet.vals != 0
    rows = live.any(-1)
    assert int(rows.sum()) == CCAT["n_train"]
    assert bool((live.sum(-1)[rows] == k).all()) and bool((fleet.vals >= 0).all())
    norms = torch.linalg.vector_norm(fleet.vals, dim=-1)[rows]
    assert torch.allclose(norms, torch.ones_like(norms), atol=1e-5)
    cols = fleet.cols[rows].long()
    assert bool((cols[:, 1:] > cols[:, :-1]).all())  # ascending, no repeat
    assert test.cols.shape == (CCAT["n_test"], k)


def test_partition_pads_and_counts(ccat):
    fleet, _ = ccat
    n, m = CCAT["n_train"], 7
    assert fleet.counts.tolist() == [n // m + (i < n % m) for i in range(m)]
    assert fleet.y.shape[1] == math.ceil(n / m)
    for i, c in enumerate(fleet.counts.tolist()):
        assert bool((fleet.y[i, :c] != 0).all()) and bool((fleet.y[i, c:] == 0).all())
        assert bool((fleet.vals[i, c:] == 0).all())


def test_class_balance_within_sampling_error(ccat):
    fleet, _ = ccat
    y = fleet.y[fleet.y != 0]
    share = float((y > 0).double().mean())
    # the threshold puts class_balance above it; label noise moves a share
    # noise * (1 - 2 * balance) across
    want = CCAT["class_balance"] + CCAT["label_noise"] * (1 - 2 * CCAT["class_balance"])
    assert abs(share - want) < 4 * math.sqrt(want * (1 - want) / y.numel())


def test_zipf_ranked_column_popularity(ccat):
    fleet, _ = ccat
    cols = fleet.cols[fleet.vals != 0].long()
    freq = torch.bincount(cols, minlength=CCAT["d"]).double()
    # popularity falls with rank: each decade's mean below the one before
    decades = [freq[a:b].mean() for a, b in ((0, 10), (10, 100), (100, 1000), (1000, 3000))]
    assert all(x > y for x, y in zip(decades, decades[1:]))
    # and follows the law: a row holds column r with about the probability
    # of a k-draw without replacement, 1 for the hottest ranks
    rows = CCAT["n_train"]
    assert float(freq[0]) == rows
    w = np.arange(1, CCAT["d"] + 1) ** -1.25
    tail = freq[1000:].sum() / (rows * gen.nnz_per_row(CCAT))
    assert 0.5 * w[1000:].sum() / w.sum() < float(tail) < 2 * w[1000:].sum() / w.sum()


def test_dense_rows_and_uniform_columns():
    fleet, test = gen.make(REUTERS, 4, 5, "cpu")
    k = gen.nnz_per_row(REUTERS)
    X = fleet.X.reshape(-1, REUTERS["d"])
    rows = (X != 0).any(-1)
    assert bool(((X[rows] != 0).sum(-1) == k).all()) and bool((X >= 0).all())
    freq = (X[rows] != 0).sum(0).double()
    assert float(freq.std() / freq.mean()) < 0.25  # uniform up to sampling noise
    assert test.X.shape == (REUTERS["n_test"], REUTERS["d"])


def test_same_seed_same_data():
    a, _ = gen.make(REUTERS, 4, 11, "cpu")
    b, _ = gen.make(REUTERS, 4, 11, "cpu")
    c, _ = gen.make(REUTERS, 4, 12, "cpu")
    assert torch.equal(a.X, b.X) and torch.equal(a.y, b.y) and not torch.equal(a.X, c.X)


CELL_BATCHES = sorted({json.loads(f.read_text())["batch_size"]
                       for f in (Path(gen.__file__).parent / "traffic").glob("*.json")})


@pytest.mark.parametrize("B", sorted(set(CELL_BATCHES) | {3, 64, 5000}))
def test_block_bound_is_the_programs(ccat, B):
    """The copy decides the schedule the program's ``auto`` picks: it has to
    be the program's bound, at every cell's own B and beyond."""
    from repro_torch.sparse.formats import minibatch_block_bound
    fleet, _ = ccat
    assert gen.block_bound(fleet, B) == minibatch_block_bound(
        fleet.cols.numpy(), fleet.vals.numpy(), B, d=CCAT["d"])
