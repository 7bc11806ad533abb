"""The port's ELL formats and sparse dataset generator against the reference.

Both are numpy: the port keeps its own copy of ``repro.sparse.formats`` and
of the ELL generator of ``repro.data.svm_datasets``, so every plane, label,
count and bound must be bit-identical.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.data import svm_datasets as R_ds  # noqa: E402
from repro.sparse import formats as R_fmt  # noqa: E402
from repro_torch.data import svm_datasets as T_ds  # noqa: E402
from repro_torch.sparse import formats as T_fmt  # noqa: E402


def _planes(m, B, k, d, seed, all_pad_row=True):
    """Random (m, B, k) planes with pad entries (0, 0) and, optionally, one
    all-pad row per node."""
    rng = np.random.default_rng(seed)
    cols = rng.integers(0, d, size=(m, B, k)).astype(np.int32)
    vals = rng.normal(size=(m, B, k)).astype(np.float32)
    pad = rng.random((m, B, k)) < 0.3
    cols[pad], vals[pad] = 0, 0.0
    if all_pad_row and B > 1:
        cols[:, 0], vals[:, 0] = 0, 0.0
    return cols, vals


PLANE_CASES = [(1, 1, 1, 130), (3, 5, 13, 1001), (2, 8, 40, 700), (4, 3, 0, 300),
               (2, 6, 9, 128)]


@pytest.mark.parametrize("blk_d", [128, 512])
@pytest.mark.parametrize("m,B,k,d", PLANE_CASES)
def test_row_block_counts_and_bound_match_reference(m, B, k, d, blk_d):
    cols, vals = _planes(m, B, k, d, seed=m + B + k)
    np.testing.assert_array_equal(T_fmt.row_block_counts(cols, vals, blk_d),
                                  R_fmt.row_block_counts(cols, vals, blk_d))
    for batch in (1, 2, 5):
        assert (T_fmt.minibatch_block_bound(cols, vals, batch, blk_d, d=d)
                == R_fmt.minibatch_block_bound(cols, vals, batch, blk_d, d=d))
    assert (T_fmt.minibatch_block_bound(cols, vals, 3, blk_d)
            == R_fmt.minibatch_block_bound(cols, vals, 3, blk_d))  # d inferred


@pytest.mark.parametrize("m,B,k,d", PLANE_CASES)
def test_block_map_matches_reference(m, B, k, d):
    cols, vals = _planes(m, B, k, d, seed=7 * m + k)
    blk_d = 128
    n_d_blocks = -(-d // blk_d)
    bound = R_fmt.minibatch_block_bound(cols, vals, B, blk_d, d=d)
    for n_blocks_max in (bound, bound + 3):
        np.testing.assert_array_equal(
            T_fmt.block_map(cols, vals, blk_d, n_d_blocks, n_blocks_max),
            R_fmt.block_map(cols, vals, blk_d, n_d_blocks, n_blocks_max))


def test_block_map_raises_where_reference_raises():
    cols, vals = _planes(3, 5, 13, 1001, seed=1)
    live = max(len(np.unique(c[v != 0] // 128)) for c, v in zip(cols, vals))
    for fmt in (R_fmt, T_fmt):
        with pytest.raises(ValueError, match="n_blocks_max"):
            fmt.block_map(cols, vals, 128, 8, live - 1)


def test_ell_partitions_block_bound_matches_reference():
    cols, vals = _planes(4, 20, 11, 900, seed=3, all_pad_row=False)
    t, r = T_fmt.EllPartitions(cols, vals, 900), R_fmt.EllPartitions(cols, vals, 900)
    assert t.shape == r.shape == (4, 20, 900)
    for batch in (1, 4):
        for blk_d in (128, 256):
            assert t.block_bound(batch, blk_d) == r.block_bound(batch, blk_d)
    np.testing.assert_array_equal(t.row_block_counts(), r.row_block_counts())


def test_ell_container_matches_reference():
    cols, vals = _planes(1, 30, 7, 200, seed=4)
    t = T_fmt.ELL(cols[0], vals[0], (30, 200))
    r = R_fmt.ELL(cols[0], vals[0], (30, 200))
    np.testing.assert_array_equal(t.to_dense(), r.to_dense())
    np.testing.assert_array_equal(t.row_nnz(), r.row_nnz())
    assert t.nnz == r.nnz and t.k_max == r.k_max and t.nbytes == r.nbytes
    w = np.random.default_rng(5).normal(size=200).astype(np.float32)
    np.testing.assert_array_equal(t.matvec(w), r.matvec(w))
    idx = np.array([3, 0, 29, 3])
    np.testing.assert_array_equal(t.take_rows(idx).cols, r.take_rows(idx).cols)
    np.testing.assert_array_equal(t.take_rows(idx).vals, r.take_rows(idx).vals)
    with pytest.raises(ValueError, match="out of range"):
        T_fmt.ELL(cols[0] + 200, vals[0], (30, 200))


@pytest.mark.parametrize("name,scale", [("ccat", 0.0005), ("reuters", 0.02)])
def test_sparse_dataset_and_partition_bit_identical(name, scale):
    t = T_ds.make_dataset(name, scale=scale, seed=1, sparse=True)
    r = R_ds.make_dataset(name, scale=scale, seed=1, sparse=True)
    assert t.sparse and r.sparse and t.d == r.d and t.lam == r.lam
    for split in ("train", "test"):
        tX, rX = getattr(t, f"X_{split}"), getattr(r, f"X_{split}")
        assert tX.shape == rX.shape
        np.testing.assert_array_equal(tX.cols, rX.cols)
        np.testing.assert_array_equal(tX.vals, rX.vals)
        np.testing.assert_array_equal(getattr(t, f"y_{split}"), getattr(r, f"y_{split}"))
    tP, ty, tc = T_ds.partition(t.X_train, t.y_train, 10, seed=2)
    rP, ry, rc = R_ds.partition(r.X_train, r.y_train, 10, seed=2)
    assert isinstance(tP, T_fmt.EllPartitions) and tP.d == rP.d
    np.testing.assert_array_equal(tP.cols, rP.cols)
    np.testing.assert_array_equal(tP.vals, rP.vals)
    np.testing.assert_array_equal(ty, ry)
    np.testing.assert_array_equal(tc, rc)
    assert tP.block_bound(1) == rP.block_bound(1)


def test_sparse_dataset_refused_for_dense_spec():
    with pytest.raises(ValueError, match="dense"):
        T_ds.make_dataset("usps", scale=0.01, sparse=True)


def test_partition_rows_still_importable_from_datasets():
    assert T_ds.partition_rows is T_fmt.partition_rows
    idx, counts, n_i = T_ds.partition_rows(23, 4, seed=9)
    r_idx, r_counts, r_n_i = R_fmt.partition_rows(23, 4, seed=9)
    np.testing.assert_array_equal(idx, r_idx)
    np.testing.assert_array_equal(counts, r_counts)
    assert n_i == r_n_i


# ------------------------------------------------------------------- CSR


def _dense(n, d, seed, density=0.05, empty_rows=(1,)):
    """A seeded (n, d) float32 matrix at ``density`` with some empty rows."""
    rng = np.random.default_rng(seed)
    X = (rng.normal(size=(n, d)) * (rng.random((n, d)) < density)).astype(np.float32)
    for r in empty_rows:
        if r < n:
            X[r] = 0.0
    return X


def _assert_csr_equal(t, r):
    for name in ("data", "indices", "indptr"):
        a, b = getattr(t, name), getattr(r, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b)
    assert tuple(t.shape) == tuple(r.shape)


@pytest.mark.parametrize("n,d,density", [(1, 7, 0.5), (12, 300, 0.05), (40, 1001, 0.01),
                                         (5, 64, 0.0)])
def test_csr_matches_reference(n, d, density):
    X = _dense(n, d, seed=n + d, density=density)
    t, r = T_fmt.CSR.from_dense(X), R_fmt.CSR.from_dense(X)
    _assert_csr_equal(t, r)
    assert t.nnz == r.nnz and t.nbytes == r.nbytes
    np.testing.assert_array_equal(t.row_nnz(), r.row_nnz())
    np.testing.assert_array_equal(t.to_dense(), X)
    np.testing.assert_array_equal(t.to_dense(np.float64), r.to_dense(np.float64))
    idx = np.array([n - 1, 0, n // 2, n - 1])
    _assert_csr_equal(t.take_rows(idx), r.take_rows(idx))
    for k_max in (None, max(1, int(t.row_nnz().max(initial=0))) + 3):
        te, re_ = t.to_ell(k_max), r.to_ell(k_max)
        np.testing.assert_array_equal(te.cols, re_.cols)
        np.testing.assert_array_equal(te.vals, re_.vals)
        assert te.shape == re_.shape


def test_csr_validation_matches_reference():
    data, idx = np.ones(3, np.float32), np.array([0, 2, 4], np.int32)
    for fmt in (R_fmt, T_fmt):
        with pytest.raises(ValueError, match="bad indptr"):
            fmt.CSR(data, idx, np.array([1, 3]), (1, 5))
        with pytest.raises(ValueError, match="lengths disagree"):
            fmt.CSR(data, idx, np.array([0, 2]), (1, 5))
        with pytest.raises(ValueError, match="out of range"):
            fmt.CSR(data, idx, np.array([0, 3]), (1, 4))
        with pytest.raises(ValueError, match="k_max=1"):
            fmt.CSR(data, idx, np.array([0, 3]), (1, 5)).to_ell(1)


@pytest.mark.parametrize("extra", [None, 5])
def test_ell_from_dense_and_to_csr_match_reference(extra):
    X = _dense(25, 500, seed=11)
    k_max = None if extra is None else int((X != 0).sum(axis=1).max()) + extra
    t, r = T_fmt.ELL.from_dense(X, k_max), R_fmt.ELL.from_dense(X, k_max)
    np.testing.assert_array_equal(t.cols, r.cols)
    np.testing.assert_array_equal(t.vals, r.vals)
    np.testing.assert_array_equal(t.to_dense(), X)
    _assert_csr_equal(t.to_csr(), r.to_csr())
    _assert_csr_equal(t.to_csr(), T_fmt.CSR.from_dense(X))


# ------------------------------------------------ block buckets and remap


@pytest.mark.parametrize("blk_d", [128, 512])
@pytest.mark.parametrize("m,B,k,d", PLANE_CASES)
def test_bucket_by_block_matches_reference(m, B, k, d, blk_d):
    cols, vals = _planes(m, B, k, d, seed=3 * m + B + k)
    for kw in ({}, {"d": d}, {"d": d, "n_blocks_max": -(-d // blk_d) + 2}):
        t = T_fmt.bucket_by_block(cols, vals, blk_d, **kw)
        r = R_fmt.bucket_by_block(cols, vals, blk_d, **kw)
        for name in ("block_ids", "starts", "cols", "vals"):
            np.testing.assert_array_equal(getattr(t, name), getattr(r, name))
        assert (t.blk_d, t.n_d_blocks, t.n_blocks_max) == (r.blk_d, r.n_d_blocks, r.n_blocks_max)
        np.testing.assert_array_equal(t.blocks_visited(), r.blocks_visited())


def test_bucket_by_block_raises_where_reference_raises():
    cols, vals = _planes(2, 6, 9, 1001, seed=2)
    for fmt in (R_fmt, T_fmt):
        with pytest.raises(ValueError, match="n_blocks_max=1"):
            fmt.bucket_by_block(cols, vals, 128, d=1001, n_blocks_max=1)


def test_row_like_max_matches_reference():
    cols, vals = _planes(5, 4, 12, 900, seed=6)
    nd = -(-900 // 128)
    blocks = np.sort(np.where(vals != 0, cols // 128, nd).reshape(5, -1), axis=1)
    assert T_fmt.row_like_max(blocks, nd) == R_fmt.row_like_max(blocks, nd)
    empty = np.zeros((0, 3), np.int64)
    assert T_fmt.row_like_max(empty, nd) == R_fmt.row_like_max(empty, nd) == 0


@pytest.mark.parametrize("m,B,k,d", PLANE_CASES)
def test_frequency_remap_matches_reference(m, B, k, d):
    cols, vals = _planes(m, B, k, d, seed=m * B + d)
    t_cols, t_perm = T_fmt.frequency_remap(cols, vals, d)
    r_cols, r_perm = R_fmt.frequency_remap(cols, vals, d)
    assert t_cols.dtype == r_cols.dtype and t_perm.dtype == r_perm.dtype
    np.testing.assert_array_equal(t_cols, r_cols)
    np.testing.assert_array_equal(t_perm, r_perm)
    w = np.random.default_rng(d).normal(size=d).astype(np.float32)
    # a pure relabelling: the margins under w_new = w_old[perm] are unchanged
    np.testing.assert_array_equal((vals * w[t_perm][t_cols]).sum(-1), (vals * w[cols]).sum(-1))


def test_partition_takes_csr_as_reference():
    ds = T_ds.make_dataset("ccat", scale=0.0005, seed=3, sparse=True)
    csr_t, csr_r = ds.X_train.to_csr(), R_fmt.ELL(ds.X_train.cols, ds.X_train.vals,
                                                  ds.X_train.shape).to_csr()
    tP, ty, tc = T_ds.partition(csr_t, ds.y_train, 10, seed=4)
    rP, ry, rc = R_ds.partition(csr_r, ds.y_train, 10, seed=4)
    eP, _, _ = T_ds.partition(csr_t.to_ell(), ds.y_train, 10, seed=4)
    assert isinstance(tP, T_fmt.EllPartitions) and tP.d == rP.d == ds.d
    for got in (tP, eP):
        np.testing.assert_array_equal(got.cols, rP.cols)
        np.testing.assert_array_equal(got.vals, rP.vals)
    np.testing.assert_array_equal(ty, ry)
    np.testing.assert_array_equal(tc, rc)
