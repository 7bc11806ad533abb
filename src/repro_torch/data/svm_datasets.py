"""Synthetic SVM datasets with the signature of the paper's benchmarks.

A copy of ``repro.data.svm_datasets`` (the port imports nothing of
``repro``): the same generator on the same numpy streams, so
``make_dataset(name, scale, seed, sparse)`` returns bit-identical arrays in
both packages, and ``partition`` splits them identically. The six datasets
of the paper's Table 2 are regenerated with matching (N_train, N_test, d,
sparsity, λ); ``scale`` shrinks the row counts and keeps d and sparsity.

``sparse=True`` (sparse specs only) draws :class:`~repro_torch.sparse.ELL`
planes directly, per row, so the dense matrix never exists: full-shape CCAT
(781,265 × 47,236 at 0.16% nonzeros) is about 0.5 GB of planes against
about 147 GB dense.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass

import numpy as np

from repro_torch.sparse.formats import ELL, EllPartitions, partition_rows

__all__ = ["DatasetSpec", "SVMDataset", "PAPER_DATASETS", "make_dataset",
           "partition", "partition_rows"]


@dataclass(frozen=True)
class DatasetSpec:
    """Signature of one paper dataset: sizes, sparsity, λ and label model."""

    name: str
    n_train: int
    n_test: int
    d: int
    sparsity: float      # fraction of nonzero features (1.0 = dense)
    lam: float           # paper's lambda for this dataset (Table 2)
    label_noise: float = 0.05
    class_balance: float = 0.5
    # Zipf exponent of the column-popularity profile (0 = uniform). Real
    # tf-idf text draws its terms from a Zipf-distributed vocabulary, so with
    # frequency-ranked column ids a document's nonzeros concentrate in the
    # leading columns — the locality that makes touched-block kernel
    # scheduling (repro.sparse.formats block bucketing) pay off. Uniform
    # column draws would erase that structure and misrepresent the workload.
    col_skew: float = 0.0


# Table 2 of the paper. Sparsity "NA" in the paper => dense here, except CCAT
# which the paper reports at 0.16% nonzeros. CCAT (RCV1 tf-idf) additionally
# carries a Zipf column-popularity profile with frequency-ranked ids — see
# DatasetSpec.col_skew.
PAPER_DATASETS: dict[str, DatasetSpec] = {
    "adult":   DatasetSpec("adult",   32561,  16281,   123, 1.0,    3.07e-5, label_noise=0.15, class_balance=0.24),
    "ccat":    DatasetSpec("ccat",    781265, 23149, 47236, 0.0016, 1e-4,    label_noise=0.05, class_balance=0.47, col_skew=1.25),
    "mnist":   DatasetSpec("mnist",   60000,  10000,   784, 0.19,   1.67e-5, label_noise=0.02, class_balance=0.099),
    "reuters": DatasetSpec("reuters", 7770,   3299,   8315, 0.01,   1.29e-4, label_noise=0.03, class_balance=0.3),
    "usps":    DatasetSpec("usps",    7329,   1969,    256, 1.0,    1.36e-4, label_noise=0.02, class_balance=0.167),
    "webspam": DatasetSpec("webspam", 234500, 115500,  254, 0.33,   1e-5,    label_noise=0.1,  class_balance=0.39),
}


@dataclass
class SVMDataset:
    """One generated dataset: float32 features, dense or ELL, and ±1 labels."""

    name: str
    X_train: "np.ndarray | ELL"  # (n_train, d) float32, dense or ELL planes
    y_train: np.ndarray          # (n_train,)  float32 in {-1, +1}
    X_test: "np.ndarray | ELL"
    y_test: np.ndarray
    lam: float

    @property
    def d(self) -> int:
        """Feature dimension."""
        return self.X_train.shape[1]

    @property
    def sparse(self) -> bool:
        """True when the features are ELL planes."""
        return isinstance(self.X_train, ELL)


def _sample_cols(rng: np.random.Generator, n: int, nnz: int, d: int,
                 skew: float = 0.0) -> np.ndarray:
    """(n, nnz) nonzero column ids, **without replacement** within each row —
    realized per-row nnz is exact, where the old with-replacement draw
    undershot the spec increasingly with density.

    ``skew`` > 0 draws each row's columns with Zipf popularity
    P(col = r) ∝ (r+1)^-skew (frequency-ranked ids: column 0 is the hottest
    term). Implemented as a chunked exponential race — ``key_r = E_r / w_r``
    with E ~ Exp(1), keep the nnz smallest keys — which is exact weighted
    sampling without replacement, vectorized with an O(chunk·d) transient.

    Uniform regimes: when collisions are rare (nnz² ≤ d — all the text-like
    specs), rejection-resample colliding rows (exactly uniform, O(n·nnz)
    memory); otherwise chunked Gumbel-top-k via argpartition, bounding the
    (chunk, d) scratch so full-shape generation never goes dense-scale.
    """
    if nnz >= d:
        return np.tile(np.arange(d, dtype=np.int64), (n, 1))
    if skew > 0.0:
        inv_w = np.arange(1, d + 1, dtype=np.float32) ** np.float32(skew)
        chunk = max(1, (1 << 25) // d)
        out = np.empty((n, nnz), np.int64)
        for s in range(0, n, chunk):
            e = min(n, s + chunk)
            u = rng.random((e - s, d), dtype=np.float32)
            with np.errstate(divide="ignore"):  # u=0 → -inf: never selected
                np.log(u, out=u)   # -E ~ -Exp(1)
            u *= inv_w             # key = -E/w: keep the nnz *largest* -keys
            out[s:e] = np.argpartition(u, d - nnz, axis=1)[:, d - nnz:]
        return out
    if nnz * nnz <= d:
        cols = rng.integers(0, d, size=(n, nnz))
        bad = np.arange(n)
        for _ in range(200):
            s = np.sort(cols[bad], axis=1)
            bad = bad[(s[:, 1:] == s[:, :-1]).any(axis=1)]
            if bad.size == 0:
                break
            cols[bad] = rng.integers(0, d, size=(bad.size, nnz))
        else:  # pathological tail: per-row exact draw for the few left
            for r in bad:
                cols[r] = rng.choice(d, nnz, replace=False)
        return cols
    chunk = max(1, (1 << 25) // d)
    out = np.empty((n, nnz), np.int64)
    for s in range(0, n, chunk):
        e = min(n, s + chunk)
        r = rng.random((e - s, d), dtype=np.float32)
        out[s:e] = np.argpartition(r, nnz, axis=1)[:, :nnz]
    return out


def _labels_for(margin: np.ndarray, spec: DatasetSpec,
                rng: np.random.Generator) -> np.ndarray:
    """Threshold margins at the class-balance quantile, then flip with the
    spec's label noise — shared by the dense and ELL generators."""
    thr = np.quantile(margin, 1.0 - spec.class_balance)
    y = np.where(margin > thr, 1.0, -1.0).astype(np.float32)
    flip = rng.random(len(margin)) < spec.label_noise
    return np.where(flip, -y, y)


def _gen_split(spec: DatasetSpec, n: int, w_star: np.ndarray, rng: np.random.Generator) -> tuple[np.ndarray, np.ndarray]:
    d = spec.d
    X = rng.normal(0.0, 1.0, size=(n, d)).astype(np.float32)
    if spec.sparsity < 1.0:
        nnz = max(1, int(round(spec.sparsity * d)))
        # sparse nonnegative "text-like" features; exact nnz per row
        mask = np.zeros((n, d), dtype=bool)
        cols = _sample_cols(rng, n, nnz, d, spec.col_skew)
        mask[np.arange(n)[:, None], cols] = True
        X = np.where(mask, np.abs(X), 0.0).astype(np.float32)
    # normalize rows (the paper's text sets are tf-idf normalized)
    norms = np.linalg.norm(X, axis=1, keepdims=True)
    X = X / np.maximum(norms, 1e-8)
    return X, _labels_for(X @ w_star, spec, rng)


def _gen_split_ell(spec: DatasetSpec, n: int, w_star: np.ndarray,
                   rng: np.random.Generator) -> tuple[ELL, np.ndarray]:
    """ELL twin of :func:`_gen_split`: the same feature model (nonnegative
    values, unit rows, quantile-thresholded labels) drawn directly as
    (n, nnz) column and value planes."""
    d = spec.d
    nnz = max(1, int(round(spec.sparsity * d)))
    cols = np.sort(_sample_cols(rng, n, nnz, d, spec.col_skew), axis=1).astype(np.int32)
    vals = np.abs(rng.normal(0.0, 1.0, size=(n, nnz)).astype(np.float32))
    vals /= np.maximum(np.linalg.norm(vals, axis=1, keepdims=True), 1e-8)
    # chunked gather-dot keeps the transient at (chunk, nnz)
    margin = np.empty(n, np.float32)
    step = max(1, (1 << 24) // max(nnz, 1))
    for s in range(0, n, step):
        e = min(n, s + step)
        margin[s:e] = np.einsum("rk,rk->r", vals[s:e], w_star[cols[s:e]])
    return ELL(cols, vals, (n, d)), _labels_for(margin, spec, rng)


def make_dataset(name: str, scale: float = 1.0, seed: int = 0,
                 sparse: bool = False) -> SVMDataset:
    """Build a paper-signature dataset. ``scale`` < 1 shrinks the row counts
    (to at least 64 each). ``sparse=True`` returns ELL feature planes and
    is refused for dense specs."""
    spec = PAPER_DATASETS[name]
    if sparse and spec.sparsity >= 1.0:
        raise ValueError(f"dataset {name!r} is dense (sparsity=1.0); "
                         "sparse=True only applies to sparse specs")
    # crc32, not hash(): string hashing is randomized per process
    rng = np.random.default_rng((seed, zlib.crc32(name.encode()) & 0xFFFF))
    w_star = rng.normal(size=spec.d).astype(np.float32)
    if spec.sparsity < 1.0:
        w_star = np.abs(w_star)  # nonneg features need signed-balance via threshold
    gen = _gen_split_ell if sparse else _gen_split
    n_tr = max(64, int(spec.n_train * scale))
    n_te = max(64, int(spec.n_test * scale))
    X_tr, y_tr = gen(spec, n_tr, w_star, rng)
    X_te, y_te = gen(spec, n_te, w_star, rng)
    return SVMDataset(name, X_tr, y_tr, X_te, y_te, spec.lam)


def partition(X, y: np.ndarray, m: int, seed: int = 0):
    """Horizontal partition over m nodes: shuffle, split into near-equal
    chunks, and pad the last chunks with X=0, y=0 rows.

    Returns ``(X_parts, y_parts (m, n_i), n_counts (m,))``, where X_parts is
    an (m, n_i, d) array for dense X and an :class:`EllPartitions` for
    :class:`ELL` or CSR input; ``n_counts`` goes straight into
    ``gadget_train(n_counts=...)``. The row permutation depends only on
    ``(len(y), m, seed)``, so a dense matrix and its ELL planes partition
    identically.
    """
    y = np.asarray(y)
    idx, counts, n_i = partition_rows(len(y), m, seed)

    def zero_pads(parts):
        for i in range(m):
            parts[i, counts[i]:] = 0
        return parts

    y_parts = zero_pads(y[idx].reshape(m, n_i).copy())
    if hasattr(X, "to_ell"):  # CSR input: convert once, partition as ELL
        X = X.to_ell()
    if isinstance(X, ELL):
        return (EllPartitions(zero_pads(X.cols[idx].reshape(m, n_i, -1)),
                              zero_pads(X.vals[idx].reshape(m, n_i, -1)),
                              X.shape[1]),
                y_parts, counts)
    X = np.asarray(X)
    return zero_pads(X[idx].reshape(m, n_i, X.shape[1])), y_parts, counts
