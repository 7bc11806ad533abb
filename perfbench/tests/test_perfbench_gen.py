"""The device data generator holds to its signature, at a small scale."""
from __future__ import annotations

import hashlib
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
# rows as wide as webspam's byte trigrams (3,727 Zipf columns of 16.6 M), cut
WIDE = dict(CCAT, n_train=3000, n_test=200, d=2_000_000, sparsity=5e-4, class_balance=0.39,
            label_noise=0.1, lam=1 / 3000)
CONFIGS = Path(gen.__file__).parent / "configs"
SEED = 2 ** 31 + 2025
# sha256 of gen.make's outputs over the m10.b1 mix's 10 nodes at SEED, as
# the generator drew them before it drew wide rows, at each configuration's
# cpu_cut on the CPU; and at full size on the card, with the block bound at
# B = 1. On the card kdda's is the present generator's: before the Zipf cdf's
# running sum moved to the host, kdda's columns varied from run to run at one
# seed (5 of its 302.7 M training entries between two runs), so no earlier
# digest of kdda holds; reuters' and ccat's are the earlier generator's.
DRAWN = {"reuters": "1d7491942784f7c455b6c5f0eb9201445ed265eb9042a449699bd7965abe1c5a",
         "ccat": "fc78b7dc7ebab8c71f74c99160c721a175699edea586fad194000c913fc8a7ce",
         "kdda": "d7c2495e16a23230120b4274ca001ae0b1dc56e828c6e0637fe766013ec1722c"}
DRAWN_ON_CARD = {
    "reuters": ("950d63e9ff23fd1eff17a1bb1ec17e9b7c185d846d234a56b5eb582a48e139d2", None),
    "ccat": ("c029d3d237ad133d3f30858fd603d2ccd902e075be0090b0042ebc3ee715df1a", 37),
    "kdda": ("6c8ce456c1f831b7f485a8176fcb338b19137d933daf5ce77508a74d46586272", 25)}


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


@pytest.fixture(scope="module")
def wide():
    return gen.make(WIDE, 5, 2 ** 31 + 77, "cpu")


def test_wide_zipf_rows(wide):
    fleet, test = wide
    k = gen.nnz_per_row(WIDE)
    assert k == 1000 and fleet.cols.dtype == torch.int32
    cols = fleet.cols.reshape(-1, k)[fleet.y.reshape(-1) != 0].long()
    assert cols.shape[0] == WIDE["n_train"] and test.cols.shape == (WIDE["n_test"], k)
    assert bool((cols[:, 1:] > cols[:, :-1]).all()) and 0 <= int(cols.min()) < WIDE["d"]
    freq = torch.bincount(cols.flatten(), minlength=WIDE["d"]).double()
    cuts = (0, 10, 100, 1000, 10 ** 4, 10 ** 5, 10 ** 6, WIDE["d"])
    decades = [freq[a:b].mean() for a, b in zip(cuts, cuts[1:])]
    assert all(x > y for x, y in zip(decades, decades[1:]))


@pytest.mark.parametrize("B", [1, 8, 600])
def test_block_bound_on_wide_rows_is_the_programs(wide, B):
    from repro_torch.sparse.formats import minibatch_block_bound
    fleet, _ = wide
    assert gen.block_bound(fleet, B) == minibatch_block_bound(
        fleet.cols.numpy(), fleet.vals.numpy(), B, d=WIDE["d"])


def test_uniform_columns_in_bounded_memory(monkeypatch):
    """At d = 50 M no (rows, d) matrix is built: every draw call's matrix
    stays within the budget, and the rows are exact."""
    sizes, d, k = [], 50_000_000, 20

    def held(draw):
        def call(*args, **kwargs):
            shape = next(a for a in args if isinstance(a, tuple))
            sizes.append(math.prod(shape))
            # before the draw, which could not be held: no row of d keys
            assert sizes[-1] <= gen.DRAW_BUDGET and shape[-1] < d
            return draw(*args, **kwargs)
        return call

    monkeypatch.setattr(torch, "rand", held(torch.rand))
    monkeypatch.setattr(torch, "randint", held(torch.randint))
    g = torch.Generator().manual_seed(3)
    cols = gen.columns(g, 1000, k, d, 0.0, "cpu").long()
    assert sizes and cols.shape == (1000, k)
    assert bool((cols[:, 1:] > cols[:, :-1]).all()) and 0 <= int(cols.min())
    assert int(cols.max()) < d and abs(float(cols.double().mean()) / d - 0.5) < 0.01


@pytest.mark.parametrize("skew", [0.0, 1.25])
def test_draws_and_keys_sample_alike(skew):
    """The two rules, first k distinct of draws with replacement and the k
    largest keys, give each column the same inclusion probability, and a
    row whose draws would reach d takes the keys."""
    d, k, n = 60, 25, 40000
    g = torch.Generator().manual_seed(5)
    cdf = gen.zipf_cdf(d, skew, "cpu") if skew else None
    p = None if cdf is None else torch.diff(cdf, prepend=cdf.new_zeros(1))
    drawn = gen._first_distinct(g, n, k, d, cdf, 320, "cpu")
    keyed = gen._top_keys(g, n, k, d, None if p is None else p.float(), "cpu")
    assert gen.first_draws(k, d, p) >= d
    for cols in (drawn, keyed, gen.columns(g, n, k, d, skew, "cpu")):
        assert bool((cols[:, 1:] > cols[:, :-1]).all())
    a, b = (torch.bincount(c.flatten().long(), minlength=d).double() / n for c in (drawn, keyed))
    assert float(((a - b).abs() / (2 * a * (1 - a) / n).sqrt().clamp(min=1e-9)).max()) < 5


@pytest.mark.parametrize("name, k, d, want", [
    ("ccat", 76, 47236, 320), ("kdda", 36, 20216830, 320),
    ("webspam trigram", 3727, 16609143, 40960)])
def test_first_draws_clear_k(name, k, d, want):
    """The ladder starts where the expected distinct count clears k by
    SPREAD deviations: ccat and kdda at 320 as before, webspam at 40,960."""
    cdf = gen.zipf_cdf(d, 1.25, "cpu")
    assert gen.first_draws(k, d, torch.diff(cdf, prepend=cdf.new_zeros(1))) == want


def digest(fleet, test) -> str:
    h = hashlib.sha256()
    for t in (fleet.y, fleet.counts, fleet.X, fleet.cols, fleet.vals,
              test.y, test.X, test.cols, test.vals):
        if t is not None:
            h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def _config(name: str, cut: bool) -> dict:
    config = json.loads((CONFIGS / f"{name}.json").read_text())
    return {**config, **config["cpu_cut"]} if cut else config


@pytest.mark.parametrize("name", sorted(DRAWN))
def test_present_configurations_draw_as_before(name):
    assert digest(*gen.make(_config(name, True), 10, SEED, "cpu")) == DRAWN[name]


@pytest.mark.chip
@pytest.mark.parametrize("name", sorted(DRAWN))
def test_present_configurations_draw_as_before_at_full_size(card, name):
    """The cells' data and block bound at full size, on the card."""
    fleet, test = gen.make(_config(name, False), 10, SEED, card)
    bound = None if fleet.cols is None else gen.block_bound(fleet, 1)
    assert (digest(fleet, test), bound) == DRAWN_ON_CARD[name]
