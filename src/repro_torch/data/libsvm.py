"""LibSVM/SVMlight text-format readers: dense, streaming-CSR, and chunked.

A copy of ``repro.data.libsvm`` (the port imports nothing of ``repro``),
numpy only. The paper's datasets ship in this format
(``label idx:val idx:val ...``, 1-based indices). Three entry points share
one parse-and-accumulate loop (``_iter_raw_chunks``):

  * :func:`load_libsvm`       — dense (N, d) matrix, for small dense sets;
  * :func:`load_libsvm_csr`   — streams the file into one
    :class:`repro_torch.sparse.CSR` without the dense matrix (memory
    O(nnz)); ``load_libsvm_csr(path)[0].to_ell()`` feeds ``partition`` →
    ``gadget_train``;
  * :func:`iter_libsvm_chunks` — yields ``(CSR, raw_labels)`` blocks of
    ``chunk_rows`` rows, which ``serve.MicroBatcher.submit_csr`` takes
    chunk by chunk.

Out-of-range feature indices (> ``n_features`` when given): ``strict=True``
raises; the default warns once per call with the dropped-entry count.
:func:`dump_libsvm` writes the format (values as ``%.9g``, which round-trips
float32 exactly).
"""
from __future__ import annotations

import warnings
from typing import Iterator

import numpy as np

from repro_torch.sparse.formats import CSR

__all__ = ["load_libsvm", "load_libsvm_csr", "iter_libsvm_chunks",
           "dump_libsvm"]


def _canonical_labels(y: np.ndarray, dtype) -> np.ndarray:
    """Map raw LibSVM labels to {-1, +1} (the repo-wide convention):
    {0,1} sources shift, multiclass sources map 'first class vs rest'
    (paper: MNIST digit 0 vs rest); {-1,+1} pass through."""
    y = np.asarray(y, dtype=dtype)
    uniq = np.unique(y)
    if set(uniq.tolist()) <= {0.0, 1.0}:
        return np.where(y > 0, 1.0, -1.0).astype(dtype)
    if not set(uniq.tolist()) <= {-1.0, 1.0}:
        return np.where(y == uniq[0], 1.0, -1.0).astype(dtype)
    return y


class _LineParser:
    """Shared tokenizer: tracks max index seen and out-of-range drop count."""

    def __init__(self, n_features: int | None, strict: bool, path: str):
        self.d_cap = n_features
        self.strict = strict
        self.path = path
        self.max_idx = 0
        self.n_dropped = 0

    def parse(self, line: str):
        """-> (label, [idx0...], [val...]) with 0-based in-range indices, or
        None for blank/comment lines."""
        line = line.strip()
        if not line or line.startswith("#"):
            return None
        parts = line.split()
        idxs: list[int] = []
        vals: list[float] = []
        for tok in parts[1:]:
            if ":" not in tok:
                continue
            i_s, v_s = tok.split(":", 1)
            i = int(i_s)  # 1-based per LibSVM convention
            if self.d_cap is not None and i > self.d_cap:
                if self.strict:
                    raise ValueError(
                        f"{self.path}: feature index {i} exceeds "
                        f"n_features={self.d_cap} (strict=True)")
                self.n_dropped += 1
                continue
            self.max_idx = max(self.max_idx, i)
            idxs.append(i - 1)
            vals.append(float(v_s))
        return float(parts[0]), idxs, vals

    def warn_if_dropped(self) -> None:
        if self.n_dropped:
            warnings.warn(
                f"{self.path}: dropped {self.n_dropped} feature entr"
                f"{'y' if self.n_dropped == 1 else 'ies'} with index > "
                f"n_features={self.d_cap} (pass strict=True to raise instead)",
                stacklevel=4)


def _iter_raw_chunks(path: str, parser: _LineParser, chunk_rows: int,
                     dtype) -> Iterator[tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]:
    """The one accumulate loop: yields ``(labels, data, indices, indptr)``
    arrays per ≤ chunk_rows block (indptr local to the block). Emits the
    end-of-file drop warning after the last chunk."""
    labels: list[float] = []
    indices: list[int] = []
    data: list[float] = []
    indptr: list[int] = [0]

    def flush():
        return (np.asarray(labels, dtype), np.asarray(data, dtype),
                np.asarray(indices, np.int32), np.asarray(indptr, np.int64))

    with open(path, "r") as fh:
        for line in fh:
            parsed = parser.parse(line)
            if parsed is None:
                continue
            lab, idxs, vals = parsed
            labels.append(lab)
            indices.extend(idxs)
            data.extend(vals)
            indptr.append(len(indices))
            if len(labels) >= chunk_rows:
                yield flush()
                labels, indices, data, indptr = [], [], [], [0]
    if labels:
        yield flush()
    parser.warn_if_dropped()


def iter_libsvm_chunks(path: str, n_features: int, chunk_rows: int = 8192,
                       dtype=np.float32, strict: bool = False,
                       ) -> Iterator[tuple[CSR, np.ndarray]]:
    """Stream a LibSVM file as ``(CSR chunk, raw labels)`` blocks.

    ``n_features`` is required — every chunk must agree on d before the whole
    file has been seen. Labels are passed through **raw** (no {-1,+1}
    canonicalization: the multiclass mapping needs the global class set;
    :func:`load_libsvm_csr` applies it after the last chunk). Peak memory is
    O(chunk nnz) — this is the out-of-core ingest primitive.
    """
    if n_features is None:
        raise ValueError("iter_libsvm_chunks requires n_features (chunks must "
                         "agree on d); use load_libsvm_csr to infer it")
    parser = _LineParser(n_features, strict, path)
    for labels, data, indices, indptr in _iter_raw_chunks(path, parser,
                                                          chunk_rows, dtype):
        yield CSR(data, indices, indptr, (len(labels), n_features)), labels


def load_libsvm_csr(path: str, n_features: int | None = None,
                    dtype=np.float32, chunk_rows: int = 8192,
                    strict: bool = False) -> tuple[CSR, np.ndarray]:
    """Stream a LibSVM file into one :class:`CSR` + (N,) labels in {-1,+1}.

    Never materializes the dense matrix — memory is O(nnz), which is what
    makes full-shape CCAT (0.16% nonzeros) fit in host memory.
    ``n_features=None`` infers d as the max index seen (requires the whole
    file, which this reads anyway).
    """
    parser = _LineParser(n_features, strict, path)
    chunks = list(_iter_raw_chunks(path, parser, chunk_rows, dtype))
    d = n_features if n_features is not None else parser.max_idx
    if not chunks:
        return (CSR(np.zeros(0, dtype), np.zeros(0, np.int32),
                    np.zeros(1, np.int64), (0, d)),
                np.zeros(0, dtype))
    labels = np.concatenate([c[0] for c in chunks])
    data = np.concatenate([c[1] for c in chunks])
    indices = np.concatenate([c[2] for c in chunks])
    row_nnz = np.concatenate([np.diff(c[3]) for c in chunks])
    indptr = np.zeros(len(labels) + 1, np.int64)
    np.cumsum(row_nnz, out=indptr[1:])
    return (CSR(data, indices, indptr, (len(labels), d)),
            _canonical_labels(labels, dtype))


def load_libsvm(path: str, n_features: int | None = None, dtype=np.float32,
                strict: bool = False) -> tuple[np.ndarray, np.ndarray]:
    """Parse a LibSVM file into a dense (N, d) matrix + (N,) labels in {-1,+1}.

    Indices are 1-based per convention. ``n_features`` pads/validates d;
    entries beyond it raise (``strict=True``) or are dropped with one warning
    carrying the total count. Thin wrapper over :func:`load_libsvm_csr` —
    for the paper's sparse text sets at full size use the CSR loader
    directly (dense CCAT is ~147 GB).
    """
    csr, y = load_libsvm_csr(path, n_features, dtype, strict=strict)
    return csr.to_dense(dtype), y


def dump_libsvm(path: str, X, y) -> None:
    """Write ``(X, y)`` as LibSVM text (`label idx:val ...`, 1-based indices).

    ``X``: dense (N, d) array **or** anything CSR-shaped (``data`` /
    ``indices`` / ``indptr`` attributes — ``repro_torch.sparse.CSR``,
    scipy.sparse.csr_matrix); only nonzeros are written either way, so the
    output round-trips through :func:`iter_libsvm_chunks` /
    :func:`load_libsvm_csr` structure-exactly. ``y``: (N,) labels written
    as integers when integral (the {-1,+1} convention) else as floats.
    Stages an on-disk streaming source without shipping dataset files."""
    if hasattr(X, "indptr"):
        data = np.asarray(X.data)
        indices = np.asarray(X.indices)
        indptr = np.asarray(X.indptr)
        rows = [(indices[indptr[i]:indptr[i + 1]],
                 data[indptr[i]:indptr[i + 1]]) for i in range(len(indptr) - 1)]
    else:
        X = np.asarray(X)
        rows = [(np.nonzero(r)[0], r[np.nonzero(r)[0]]) for r in X]
    y = np.asarray(y)
    if len(rows) != len(y):
        raise ValueError(f"X has {len(rows)} rows but y has {len(y)} labels")
    with open(path, "w") as fh:
        for (idxs, vals), lab in zip(rows, y):
            lab_s = str(int(lab)) if float(lab).is_integer() else repr(float(lab))
            feats = " ".join(f"{int(i) + 1}:{v:.9g}" for i, v in zip(idxs, vals))
            fh.write(f"{lab_s} {feats}\n".rstrip() + "\n")
