"""The port's dense_predict against the reference's fused dense_scores
kernel (interpret mode), binary and multiclass, ties included; ell_predict
against the reference's over a map wider than 256 slots; rows with NaN and
infinite scores against the reference's dense_predict and ell_predict,
labels bit for bit."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.hinge_subgrad import ops as RO  # noqa: E402
from repro.kernels.hinge_subgrad import predict as RP  # noqa: E402
from repro_torch.kernels.hinge_subgrad import ops as TO  # noqa: E402
from repro_torch.kernels.hinge_subgrad import predict as TP  # noqa: E402


def _inputs(B, d, C, seed=0):
    rng = np.random.default_rng(seed + B + d + C)
    X = (rng.normal(size=(B, d)) / np.sqrt(d)).astype(np.float32)
    W = rng.normal(size=(C, d)).astype(np.float32)
    if C > 1:
        W[C - 1] = W[0]          # classes 0 and C-1 tie on every row
    X[0] = 0.0                   # an all-zero query: every class scores 0
    return X, W


@pytest.mark.parametrize("C", [1, 3])
@pytest.mark.parametrize("B,d", [(1, 100), (5, 130), (37, 300)])
def test_dense_predict(B, d, C):
    X, W = _inputs(B, d, C)
    Wq = W[0] if C == 1 else W
    s_ref, l_ref = RO.dense_predict(jnp.asarray(Wq), jnp.asarray(X), interpret=True)
    s_port, l_port = TO.dense_predict(torch.from_numpy(Wq), torch.from_numpy(X))
    assert s_port.shape == s_ref.shape and l_port.shape == l_ref.shape
    np.testing.assert_allclose(s_port.numpy(), np.asarray(s_ref), rtol=0, atol=1e-5)
    assert l_port.dtype == (torch.float32 if C == 1 else torch.int32)
    np.testing.assert_array_equal(l_port.numpy(), np.asarray(l_ref))
    if C == 1:
        assert l_port[0] == 1.0  # margin 0 labels +1
    else:
        assert l_port[0] == 0    # an all-way tie takes the first class
        assert not torch.any(l_port == C - 1)  # a tie with class 0 never picks the later one


@pytest.mark.parametrize("C", [1, 3, 17])
@pytest.mark.parametrize("d", [64, 65, 66, 67])
@pytest.mark.parametrize("B", [1, 8, 260])
def test_dense_predict_every_row_alignment(B, d, C):
    """d of every residue mod 4 (the kernel's rows then start at every
    16-byte phase), one to several hundred rows, up to 17 classes with ties."""
    X, W = _inputs(B, d, C, seed=7)
    Wq = W[0] if C == 1 else W
    s_ref, l_ref = RO.dense_predict(jnp.asarray(Wq), jnp.asarray(X), interpret=True)
    s_port, l_port = TO.dense_predict(torch.from_numpy(Wq), torch.from_numpy(X))
    np.testing.assert_allclose(s_port.numpy(), np.asarray(s_ref), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(l_port.numpy(), np.asarray(l_ref))
    if C > 1:
        assert not torch.any(l_port == C - 1)  # tied with class 0: the first wins


@pytest.mark.parametrize("n,parts", [(3299, 132), (8, 132), (1, 132), (0, 16), (5, 16),
                                     (25 * 2079, 16), (2079, 16), (132, 132)])
def test_even_split_covers_each_item_once(n, parts):
    ranges = TP.even_split(n, parts)
    assert len(ranges) == parts and ranges[0][0] == 0 and ranges[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))  # contiguous, no overlap
    sizes = [hi - lo for lo, hi in ranges]
    assert min(sizes) >= 0 and max(sizes) - min(sizes) <= 1
    assert sum(sizes) == n


@pytest.mark.parametrize("B,n_sm,want", [(3299, 132, 132), (64, 132, 64), (8, 132, 8),
                                         (1, 132, 1), (0, 132, 1), (132, 132, 132)])
def test_dense_grid_is_one_wave_without_empty_blocks(B, n_sm, want):
    blocks = TP.dense_grid(B, n_sm)
    assert blocks == want
    if B:
        assert all(hi > lo for lo, hi in TP.even_split(B, blocks))


def test_dense_scores_masks_classes_beyond_n_classes():
    X, W = _inputs(6, 50, 4, seed=3)
    W[3] = 100.0 * np.abs(W[3])  # would win every row if it were counted
    S, labels = TP.dense_scores(torch.from_numpy(X), torch.from_numpy(W), n_classes=3)
    assert S.shape == (6, 4)
    np.testing.assert_array_equal(labels.numpy(), np.argmax((X @ W.T)[:, :3], axis=1))


def test_dense_predict_rejects_3d_weights():
    with pytest.raises(ValueError):
        TO.dense_predict(torch.zeros(2, 3, 4), torch.zeros(5, 4))


def _nan_rows(B, d, C, seed):
    """X (B, d) and W (C, d) whose scores hold, in row 1, NaN for every class
    (a NaN feature); in row 2, NaN for class C - 1 only (an infinite feature
    against its zero weight) and +-inf for the others; in row 3, -inf for
    every class; finite scores elsewhere."""
    rng = np.random.default_rng(seed)
    X = (rng.normal(size=(B, d)) / np.sqrt(d)).astype(np.float32)
    W = rng.normal(size=(C, d)).astype(np.float32)
    X[1, 5] = np.nan
    X[2, 7], W[C - 1, 7] = np.inf, 0.0
    X[3, 9], W[:, 9] = -np.inf, 1.0
    return X, W


@pytest.mark.parametrize("C", [1, 3, 130])
def test_dense_predict_nan_rows_match_reference(C):
    """A row with a NaN among its class scores is labelled with the
    reference's pad-lane count 128·⌈C/128⌉ (128 at C 1 and 3, 256 at 130);
    a row of -inf scores takes class 0; the rest the first-occurrence argmax."""
    X, W = _nan_rows(8, 300, C, seed=C)
    s_ref, l_ref = RO.dense_predict(jnp.asarray(W), jnp.asarray(X), interpret=True)
    s_port, l_port = TO.dense_predict(torch.from_numpy(W), torch.from_numpy(X))
    np.testing.assert_allclose(s_port.numpy(), np.asarray(s_ref), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(l_port.numpy(), np.asarray(l_ref))
    assert TP.nan_label(C) == 128 * -(-C // 128)
    assert l_port[1] == l_port[2] == TP.nan_label(C) and l_port[3] == 0


@pytest.mark.parametrize("C", [1, 3, 130])
def test_ell_predict_nan_rows_match_reference(C):
    """The padded-ELL twin: a NaN value, an infinite value against a zero
    weight of class C - 1, and a -inf value against weights of 1. Every
    entry lies in the first 128-column block: the reference's one-hot gather
    multiplies each value by the one-hot rows of every visited block, which
    turns an infinite value into NaN (inf x 0) as soon as a second block is
    visited; the port gathers, so its -inf stays -inf (ROADMAP C)."""
    B, k, d = 8, 6, 700
    rng = np.random.default_rng(20 + C)
    cols = rng.integers(0, 128, size=(B, k)).astype(np.int32)
    vals = rng.normal(size=(B, k)).astype(np.float32)
    W = rng.normal(size=(C, d)).astype(np.float32)
    cols[:, 0] = np.arange(B) * 15 + 3  # a distinct first column a row
    vals[1, 0] = np.nan
    vals[2, 0], W[C - 1, cols[2, 0]] = np.inf, 0.0
    vals[3, 0], W[:, cols[3, 0]] = -np.inf, 1.0
    vals[4, 2:] = 0.0  # pad entries (col, 0) stay inert
    s_ref, l_ref = RO.ell_predict(jnp.asarray(W), jnp.asarray(cols), jnp.asarray(vals),
                                  interpret=True)
    s_port, l_port = TO.ell_predict(torch.from_numpy(W), torch.from_numpy(cols),
                                    torch.from_numpy(vals))
    np.testing.assert_allclose(s_port.numpy(), np.asarray(s_ref), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(l_port.numpy(), np.asarray(l_ref))
    assert l_port[1] == l_port[2] == TP.nan_label(C) and l_port[3] == 0


def test_nan_past_n_classes_is_ignored_as_by_the_reference_kernel():
    """At the kernel level (n_classes < C): a NaN in an unranked class changes
    no label, a NaN in a ranked one gives the pad-lane count; the reference
    kernel on the same planes, its class rows padded to 128 with zeros."""
    B, d, C, n_classes = 8, 256, 4, 3
    X, W = _nan_rows(B, d, C, seed=9)
    W[3, 0] = np.nan  # class 3 unranked: NaN on every row
    Wp = np.zeros((128, d), np.float32)
    Wp[:C] = W
    s_ref, l_ref = RP.dense_scores(jnp.asarray(X), jnp.asarray(Wp), n_classes=n_classes,
                                   blk_b=8, blk_d=128, interpret=True)
    s_port, l_port = TP.dense_scores(torch.from_numpy(X), torch.from_numpy(W),
                                     n_classes=n_classes)
    np.testing.assert_allclose(s_port.numpy(), np.asarray(s_ref)[:, :C], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(l_port.numpy(), np.asarray(l_ref))
    # row 1 holds a NaN among the ranked classes; row 2's NaN is class 3,
    # unranked, so it and every other row rank classes 0-2 (+-inf included)
    assert l_port[1] == TP.nan_label(C) and l_port[3] == 0
    others = np.delete(np.arange(B), 1)
    np.testing.assert_array_equal(l_port.numpy()[others],
                                  np.argmax(s_port.numpy()[others, :n_classes], axis=1))


@pytest.mark.parametrize("C,B,k", [(1, 8, 76), (4, 8, 76), (20, 8, 76), (4, 2, 600)],
                         ids=["C1", "C4", "C20", "C4-k600"])
def test_ell_predict_wide_map_matches_reference(C, B, k):
    """ell_predict against the reference's (interpret mode) with a map of
    300 slots, past 256, and at k = 600, past one wave of 512 entries;
    blocks of 8 columns (d = 2400) keep the reference's walk short. Classes
    0 and C - 1 tie, row 1 is a pad row, and C = 20 runs past a tile of 4
    classes; scores at 1e-5, labels bit for bit."""
    blk_d, d = 8, 2400
    rng = np.random.default_rng(C + B + k)
    cols = rng.integers(0, d, size=(B, k)).astype(np.int32)
    vals = (rng.normal(size=(B, k)) / np.sqrt(k)).astype(np.float32)
    cols[1], vals[1] = 0, 0.0
    vals[0, -k // 4:] = 0.0  # pad entries at the end of row 0
    W = rng.normal(size=(C, d)).astype(np.float32)
    if C > 1:
        W[C - 1] = W[0]
    n_d_blocks = d // blk_d
    assert TO.resolve_block_cap(B, k, n_d_blocks=n_d_blocks) == n_d_blocks == 300
    Wq = W[0] if C == 1 else W
    s_ref, l_ref = RO.ell_predict(jnp.asarray(Wq), jnp.asarray(cols), jnp.asarray(vals),
                                  blk_d=blk_d, interpret=True)
    s_port, l_port = TO.ell_predict(torch.from_numpy(Wq), torch.from_numpy(cols),
                                    torch.from_numpy(vals), blk_d=blk_d)
    assert s_port.shape == s_ref.shape and l_port.shape == l_ref.shape
    np.testing.assert_allclose(s_port.numpy(), np.asarray(s_ref), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(l_port.numpy(), np.asarray(l_ref))
    if C > 1:
        assert l_port[1] == 0 and not torch.any(l_port == C - 1)
