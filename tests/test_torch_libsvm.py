"""The port's LibSVM reader and writer against the reference.

Both are numpy: ``repro_torch.data.libsvm`` is a copy of
``repro.data.libsvm``, so the text written and every array read back must be
identical, in value and dtype (``indices`` int32, ``indptr`` int64).
"""
import warnings

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.data import libsvm as R_lib  # noqa: E402
from repro.data import svm_datasets as R_ds  # noqa: E402
from repro.sparse import formats as R_fmt  # noqa: E402
from repro_torch import data as T_data  # noqa: E402
from repro_torch.data import libsvm as T_lib  # noqa: E402
from repro_torch.data import svm_datasets as T_ds  # noqa: E402
from repro_torch.sparse import formats as T_fmt  # noqa: E402


def _assert_csr_equal(t, r):
    assert isinstance(t, T_fmt.CSR)
    for name in ("data", "indices", "indptr"):
        a, b = getattr(t, name), getattr(r, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b)
    assert tuple(t.shape) == tuple(r.shape)


def _matrix(n, d, seed, density=0.1):
    rng = np.random.default_rng(seed)
    X = (rng.normal(size=(n, d)) * (rng.random((n, d)) < density)).astype(np.float32)
    X[min(2, n - 1)] = 0.0  # a row with no features
    return X


@pytest.fixture(scope="module")
def ccat_small():
    return T_ds.make_dataset("ccat", scale=0.0005, seed=5, sparse=True)


@pytest.mark.parametrize("labels", ["pm1", "01", "multiclass", "float"])
def test_dump_writes_the_reference_text(tmp_path, labels):
    X = _matrix(9, 40, seed=1)
    y = {"pm1": np.array([1, -1] * 4 + [1], np.float32),
         "01": np.array([0, 1] * 4 + [0], np.float32),
         "multiclass": np.arange(9) % 3 + 1.0,
         "float": np.linspace(-1, 1, 9)}[labels]
    for X_in in (X, T_fmt.CSR.from_dense(X)):
        T_lib.dump_libsvm(str(tmp_path / "t.svm"), X_in, y)
        R_lib.dump_libsvm(str(tmp_path / "r.svm"), X, y)
        assert (tmp_path / "t.svm").read_bytes() == (tmp_path / "r.svm").read_bytes()
    with pytest.raises(ValueError, match="labels"):
        T_lib.dump_libsvm(str(tmp_path / "bad.svm"), X, y[:-1])


@pytest.mark.parametrize("labels", ["pm1", "01", "multiclass"])
@pytest.mark.parametrize("n_features", [None, 40, 64])
def test_loaders_read_the_reference_arrays(tmp_path, labels, n_features):
    X = _matrix(30, 40, seed=2)
    X[:, 39] = 0.0
    X[4, 39] = 1.5  # the last column once, so an inferred d is 40
    y = {"pm1": np.where(np.arange(30) % 3, 1.0, -1.0),
         "01": (np.arange(30) % 2).astype(np.float32),
         "multiclass": np.arange(30) % 4 + 2.0}[labels]
    path = str(tmp_path / "x.svm")
    R_lib.dump_libsvm(path, X, y)
    t_csr, t_y = T_lib.load_libsvm_csr(path, n_features, chunk_rows=7)
    r_csr, r_y = R_lib.load_libsvm_csr(path, n_features, chunk_rows=7)
    _assert_csr_equal(t_csr, r_csr)
    assert t_y.dtype == r_y.dtype
    np.testing.assert_array_equal(t_y, r_y)
    assert set(np.unique(t_y)) <= {-1.0, 1.0}
    np.testing.assert_array_equal(t_csr.to_dense()[:, :40], X)
    t_X, t_yd = T_lib.load_libsvm(path, n_features)
    r_X, r_yd = R_lib.load_libsvm(path, n_features)
    assert t_X.dtype == r_X.dtype and t_X.shape == r_X.shape
    np.testing.assert_array_equal(t_X, r_X)
    np.testing.assert_array_equal(t_yd, r_yd)
    if n_features is not None:
        t_chunks = list(T_lib.iter_libsvm_chunks(path, n_features, chunk_rows=8))
        r_chunks = list(R_lib.iter_libsvm_chunks(path, n_features, chunk_rows=8))
        assert len(t_chunks) == len(r_chunks) == 4
        for (tc, tl), (rc, rl) in zip(t_chunks, r_chunks):
            _assert_csr_equal(tc, rc)
            np.testing.assert_array_equal(tl, rl)  # raw labels, not canonical


def test_out_of_range_indices_strict_and_warned_as_reference(tmp_path):
    path = tmp_path / "wide.svm"
    path.write_text("# a comment line\n\n1 1:0.5 7:2 12:1\n-1 3:1\n+1 12:4 13:1\n")
    for lib in (R_lib, T_lib):
        with pytest.raises(ValueError, match="strict=True"):
            lib.load_libsvm_csr(str(path), 10, strict=True)
        with pytest.raises(ValueError, match="strict=True"):
            list(lib.iter_libsvm_chunks(str(path), 10, strict=True))
        with pytest.raises(ValueError, match="n_features"):
            list(lib.iter_libsvm_chunks(str(path), None))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        t_csr, t_y = T_lib.load_libsvm_csr(str(path), 10)
        r_csr, r_y = R_lib.load_libsvm_csr(str(path), 10)
    messages = [str(w.message) for w in caught]
    assert len(messages) == 2 and all("dropped 3 feature entries" in m for m in messages)
    _assert_csr_equal(t_csr, r_csr)
    np.testing.assert_array_equal(t_y, r_y)
    _assert_csr_equal(T_lib.load_libsvm_csr(str(path))[0], R_lib.load_libsvm_csr(str(path))[0])


def test_empty_file_as_reference(tmp_path):
    path = tmp_path / "empty.svm"
    path.write_text("\n# nothing here\n")
    for n_features in (None, 5):
        t_csr, t_y = T_lib.load_libsvm_csr(str(path), n_features)
        r_csr, r_y = R_lib.load_libsvm_csr(str(path), n_features)
        _assert_csr_equal(t_csr, r_csr)
        assert t_y.shape == r_y.shape == (0,) and t_y.dtype == r_y.dtype


@pytest.mark.parametrize("labels,want", [
    ([0.0, 1.0, 1.0], [-1.0, 1.0, 1.0]),
    ([-1.0, 1.0, -1.0], [-1.0, 1.0, -1.0]),
    ([3.0, 1.0, 2.0, 1.0], [-1.0, 1.0, -1.0, 1.0]),  # the first class against the rest
    ([1.0, 1.0], [1.0, 1.0]),
])
def test_canonical_labels_as_reference(labels, want):
    y = np.array(labels)
    for dtype in (np.float32, np.float64):
        got, ref = T_lib._canonical_labels(y, dtype), R_lib._canonical_labels(y, dtype)
        assert got.dtype == ref.dtype == dtype
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(got, want)


def test_ccat_round_trips_to_its_planes(tmp_path, ccat_small):
    """The generated CCAT test set written with dump_libsvm and read back,
    whole and in chunks, is its ELL planes bit for bit (``%.9g`` round-trips
    float32), and the reference reads the same arrays."""
    X, y = ccat_small.X_test, ccat_small.y_test
    path = str(tmp_path / "ccat.svm")
    T_lib.dump_libsvm(path, X.to_csr(), y)
    csr, y_back = T_lib.load_libsvm_csr(path, X.shape[1])
    _assert_csr_equal(csr, R_lib.load_libsvm_csr(path, X.shape[1])[0])
    ell = csr.to_ell(X.k_max)
    np.testing.assert_array_equal(ell.cols, X.cols)
    np.testing.assert_array_equal(ell.vals, X.vals)
    np.testing.assert_array_equal(y_back, y)
    chunks = list(T_lib.iter_libsvm_chunks(path, X.shape[1], chunk_rows=50))
    assert len(chunks) == -(-X.shape[0] // 50)
    cols = np.concatenate([c.to_ell(X.k_max).cols for c, _ in chunks])
    vals = np.concatenate([c.to_ell(X.k_max).vals for c, _ in chunks])
    np.testing.assert_array_equal(cols, X.cols)
    np.testing.assert_array_equal(vals, X.vals)
    np.testing.assert_array_equal(np.concatenate([lab for _, lab in chunks]), y)


def test_loaded_csr_partitions_as_reference(tmp_path, ccat_small):
    X, y = ccat_small.X_train, ccat_small.y_train
    path = str(tmp_path / "train.svm")
    T_lib.dump_libsvm(path, X.to_csr(), y)
    t_csr, t_y = T_data.load_libsvm_csr(path, X.shape[1])
    r_csr, r_y = R_lib.load_libsvm_csr(path, X.shape[1])
    tP, ty, tc = T_data.partition(t_csr, t_y, 10, seed=1)
    rP, ry, rc = R_ds.partition(r_csr, r_y, 10, seed=1)
    assert isinstance(tP, T_fmt.EllPartitions) and isinstance(rP, R_fmt.EllPartitions)
    np.testing.assert_array_equal(tP.cols, rP.cols)
    np.testing.assert_array_equal(tP.vals, rP.vals)
    np.testing.assert_array_equal(ty, ry)
    np.testing.assert_array_equal(tc, rc)
    assert T_data.iter_libsvm_chunks is T_lib.iter_libsvm_chunks
    assert T_data.load_libsvm is T_lib.load_libsvm
