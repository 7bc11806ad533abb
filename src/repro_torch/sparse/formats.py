"""Sparse feature containers (CSR and padded ELL) and the touched-block
schedule helpers.

A copy of ``repro.sparse.formats`` (the port imports nothing of ``repro``),
numpy only. :class:`CSR` is the compressed-sparse-row triplet that streaming
ingest appends rows to (``repro_torch.data.libsvm``). :class:`ELL` stores
every row as exactly ``k_max`` (column, value) pairs in two (rows, k_max)
planes; ragged rows are padded with the inert entry ``(col=0, val=0.0)``,
which adds nothing to a gather-dot or a scatter-add, so no mask plane is
kept. :class:`EllPartitions` stacks the planes per node for
``gadget_train``.

The touched-block helpers state the schedule of the prefetch kernels on the
host: :func:`row_block_counts` and :func:`minibatch_block_bound` give the
static ``n_blocks_max`` cap (sound for every minibatch the trainer can
draw), and :func:`block_map` builds the compact (m, n_blocks_max) map of
each node's distinct live d-blocks followed by the sentinel ``n_d_blocks``;
``repro_torch.kernels.hinge_subgrad.sparse.ell_block_map`` is its device
twin.
:func:`bucket_by_block` sorts a minibatch's entries by d-block
(:class:`BlockBuckets`, the layout that counts blocks per schedule), and
:func:`frequency_remap` ranks columns by document frequency so hot columns
share blocks. :func:`pad_query_planes` states the serving buckets' fixed
batch shapes.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

__all__ = [
    "CSR", "ELL", "EllPartitions", "partition_rows",
    "BlockBuckets", "DEFAULT_BUCKET_BLK_D", "block_map", "bucket_by_block",
    "row_block_counts", "minibatch_block_bound", "frequency_remap",
    "pad_query_planes",
]

# d-block width of the touched-block schedule and of its static bound
DEFAULT_BUCKET_BLK_D = 128


@dataclass
class CSR:
    """Compressed sparse row matrix: ``data[indptr[r]:indptr[r+1]]`` are the
    nonzero values of row r at columns ``indices[indptr[r]:indptr[r+1]]``."""

    data: np.ndarray     # (nnz,) float
    indices: np.ndarray  # (nnz,) int32, 0-based column ids, < shape[1]
    indptr: np.ndarray   # (rows+1,) int64, monotone, indptr[0] == 0
    shape: tuple[int, int]

    def __post_init__(self):
        self.data = np.asarray(self.data)
        self.indices = np.asarray(self.indices, np.int32)
        self.indptr = np.asarray(self.indptr, np.int64)
        n, d = self.shape
        if self.indptr.shape != (n + 1,) or self.indptr[0] != 0:
            raise ValueError(f"bad indptr for {n} rows")
        if self.indptr[-1] != len(self.data) or len(self.data) != len(self.indices):
            raise ValueError("indptr/data/indices lengths disagree")
        if len(self.indices) and (self.indices.min() < 0 or self.indices.max() >= d):
            raise ValueError(f"column index out of range for d={d}")

    @property
    def nnz(self) -> int:
        """Stored entries over all rows."""
        return int(self.indptr[-1])

    @property
    def nbytes(self) -> int:
        """Bytes of the three arrays."""
        return self.data.nbytes + self.indices.nbytes + self.indptr.nbytes

    def row_nnz(self) -> np.ndarray:
        """(n,) stored entries per row."""
        return np.diff(self.indptr).astype(np.int64)

    @classmethod
    def from_dense(cls, X: np.ndarray) -> "CSR":
        """The nonzeros of a dense (n, d) matrix, row by row."""
        X = np.asarray(X)
        n, d = X.shape
        mask = X != 0
        indptr = np.zeros(n + 1, np.int64)
        np.cumsum(mask.sum(axis=1), out=indptr[1:])
        cols = np.nonzero(mask)[1].astype(np.int32)
        return cls(X[mask].astype(X.dtype), cols, indptr, (n, d))

    def to_dense(self, dtype=None) -> np.ndarray:
        """The dense (n, d) matrix."""
        n, d = self.shape
        X = np.zeros((n, d), dtype or self.data.dtype)
        rows = np.repeat(np.arange(n), self.row_nnz())
        X[rows, self.indices] = self.data
        return X

    def take_rows(self, idx: np.ndarray) -> "CSR":
        """New CSR holding rows ``idx``, in that order."""
        idx = np.asarray(idx, np.int64)
        counts = self.row_nnz()[idx]
        indptr = np.zeros(len(idx) + 1, np.int64)
        np.cumsum(counts, out=indptr[1:])
        starts = self.indptr[idx]
        # gather each selected row's span: offset within the row + row start
        flat = (np.repeat(starts - indptr[:-1], counts)
                + np.arange(int(indptr[-1]), dtype=np.int64))
        return CSR(self.data[flat], self.indices[flat], indptr,
                   (len(idx), self.shape[1]))

    def to_ell(self, k_max: int | None = None) -> "ELL":
        """Padded ELL planes, ``k_max`` wide (the widest row by default);
        raises if a row is wider than ``k_max``."""
        counts = self.row_nnz()
        widest = int(counts.max()) if len(counts) else 0
        if k_max is None:
            k_max = max(widest, 1)
        elif widest > k_max:
            raise ValueError(f"k_max={k_max} < widest row nnz {widest}")
        n, d = self.shape
        cols = np.zeros((n, k_max), np.int32)
        vals = np.zeros((n, k_max), np.float32)
        within = np.arange(self.nnz, dtype=np.int64) - np.repeat(self.indptr[:-1], counts)
        rows = np.repeat(np.arange(n), counts)
        cols[rows, within] = self.indices
        vals[rows, within] = self.data
        return ELL(cols, vals, (n, d))


@dataclass
class ELL:
    """Padded ELLPACK planes. Pad entries are ``(col=0, val=0.0)``; anything
    that must count entries uses :meth:`row_nnz` (vals != 0)."""

    cols: np.ndarray  # (n, k_max) int32
    vals: np.ndarray  # (n, k_max) float32
    shape: tuple[int, int]

    def __post_init__(self):
        self.cols = np.asarray(self.cols, np.int32)
        self.vals = np.asarray(self.vals, np.float32)
        if self.cols.shape != self.vals.shape or self.cols.ndim != 2:
            raise ValueError("cols/vals must be equal-shape (n, k_max) planes")
        if self.cols.shape[0] != self.shape[0]:
            raise ValueError("plane row count disagrees with shape")
        if self.cols.size and (self.cols.min() < 0 or self.cols.max() >= self.shape[1]):
            raise ValueError(f"column index out of range for d={self.shape[1]}")

    @property
    def k_max(self) -> int:
        """Entries stored per row."""
        return self.cols.shape[1]

    @property
    def nnz(self) -> int:
        """Live (non-zero) entries over all rows."""
        return int((self.vals != 0).sum())

    @property
    def nbytes(self) -> int:
        """Bytes of the two planes."""
        return self.cols.nbytes + self.vals.nbytes

    def row_nnz(self) -> np.ndarray:
        """(n,) live entries per row."""
        return (self.vals != 0).sum(axis=1).astype(np.int64)

    @classmethod
    def from_dense(cls, X: np.ndarray, k_max: int | None = None) -> "ELL":
        """The nonzeros of a dense (n, d) matrix as planes ``k_max`` wide."""
        return CSR.from_dense(X).to_ell(k_max)

    def to_dense(self, dtype=np.float32) -> np.ndarray:
        """The dense (n, d) matrix."""
        n, d = self.shape
        X = np.zeros((n, d), dtype)
        rows = np.repeat(np.arange(n), self.k_max).reshape(n, self.k_max)
        # += so the shared pad slot (0, 0) accumulates only zeros
        np.add.at(X, (rows, self.cols), self.vals)
        return X

    def to_csr(self) -> CSR:
        """The live (non-zero) entries as a CSR, pad entries dropped."""
        live = self.vals != 0
        counts = live.sum(axis=1)
        indptr = np.zeros(self.shape[0] + 1, np.int64)
        np.cumsum(counts, out=indptr[1:])
        return CSR(self.vals[live], self.cols[live], indptr, self.shape)

    def take_rows(self, idx: np.ndarray) -> "ELL":
        """The rows ``idx``, as a new ELL."""
        idx = np.asarray(idx, np.int64)
        return ELL(self.cols[idx], self.vals[idx], (len(idx), self.shape[1]))

    def matvec(self, w: np.ndarray) -> np.ndarray:
        """X @ w as a gather-dot."""
        return (self.vals * np.asarray(w)[self.cols]).sum(axis=1)


@dataclass
class EllPartitions:
    """Per-node stacked ELL planes for GADGET: node i's rows are
    ``cols[i], vals[i]`` with the first ``n_counts[i]`` valid. Made by
    ``repro_torch.data.svm_datasets.partition``; ``gadget_train`` takes it
    in place of a dense (m, n_i, d) array.

    ``row_block_counts`` (computed once per blk_d) feeds the static
    ``n_blocks_max`` bound of the prefetch schedule."""

    cols: np.ndarray  # (m, n_i, k_max) int32
    vals: np.ndarray  # (m, n_i, k_max) float32
    d: int            # feature dimension (the planes do not carry it)
    _block_counts: dict = field(default_factory=dict, repr=False, compare=False)

    @property
    def shape(self) -> tuple[int, int, int]:
        """(m, n_i, d), the shape of the dense partitions."""
        m, n_i, _ = self.cols.shape
        return (m, n_i, self.d)

    @property
    def nbytes(self) -> int:
        """Bytes of the two planes."""
        return self.cols.nbytes + self.vals.nbytes

    def row_block_counts(self, blk_d: int = DEFAULT_BUCKET_BLK_D) -> np.ndarray:
        """(m, n_i) distinct-d-block counts per row, cached per blk_d."""
        if blk_d not in self._block_counts:
            self._block_counts[blk_d] = row_block_counts(self.cols, self.vals, blk_d)
        return self._block_counts[blk_d]

    def block_bound(self, batch_size: int, blk_d: int = DEFAULT_BUCKET_BLK_D) -> int:
        """Static ``n_blocks_max`` cap for a batch_size-row minibatch drawn
        from any node, sound for every draw the trainer can make."""
        return minibatch_block_bound(self.cols, self.vals, batch_size, blk_d,
                                     d=self.d,
                                     counts=self.row_block_counts(blk_d))


def partition_rows(n: int, m: int, seed: int = 0) -> tuple[np.ndarray, np.ndarray, int]:
    """Shuffled near-equal split of n rows over m nodes.

    Returns ``(idx, counts, n_i)``: a permutation of ``arange(n)`` laid out so
    node i owns ``idx[i*n_i : i*n_i + counts[i]]``, per-node valid counts
    summing to exactly n, and the common padded length ``n_i = ceil(n/m)``.
    The first ``n % m`` nodes hold one extra row.
    """
    if n < m:
        raise ValueError(f"cannot partition {n} rows over {m} nodes")
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    q, r = divmod(n, m)
    counts = np.full(m, q, np.int64)
    counts[:r] += 1
    n_i = q + (1 if r else 0)
    # pad slots point at row perm[0]; callers zero them out
    idx = np.zeros(m * n_i, np.int64)
    offsets = np.concatenate([[0], np.cumsum(counts)[:-1]])
    for i in range(m):
        idx[i * n_i: i * n_i + counts[i]] = perm[offsets[i]: offsets[i] + counts[i]]
    return idx, counts, n_i


def _entry_blocks(cols: np.ndarray, vals: np.ndarray, blk_d: int,
                  sentinel: int) -> np.ndarray:
    """Per-entry d-block id with pad entries (val == 0) mapped to sentinel."""
    return np.where(vals != 0, cols // blk_d, sentinel)


def row_block_counts(cols: np.ndarray, vals: np.ndarray, blk_d: int) -> np.ndarray:
    """Distinct live d-blocks per row: ``(..., k)`` planes → ``(...,)`` int32.
    Pad entries (val = 0) count nothing."""
    cols = np.asarray(cols)
    if cols.shape[-1] == 0:
        return np.zeros(cols.shape[:-1], np.int32)
    blocks = np.sort(_entry_blocks(cols, np.asarray(vals), blk_d, -1), axis=-1)
    live = blocks >= 0
    first = live[..., :1]
    changed = (blocks[..., 1:] != blocks[..., :-1]) & live[..., 1:]
    return (first.sum(axis=-1) + changed.sum(axis=-1)).astype(np.int32)


def minibatch_block_bound(cols: np.ndarray, vals: np.ndarray, batch_size: int,
                          blk_d: int = DEFAULT_BUCKET_BLK_D, *,
                          d: int | None = None,
                          counts: np.ndarray | None = None) -> int:
    """Sound static cap on the distinct d-blocks any batch_size-row minibatch
    of any node can touch: ``max_i`` of the sum of the batch_size largest
    per-row distinct-block counts within node i, clamped to ``n_d_blocks``
    and ``batch_size·k``. Draws with replacement only shrink the union, so
    the top-B sum dominates every minibatch. Always ≥ 1.
    """
    cols = np.asarray(cols, np.int64)
    vals = np.asarray(vals)
    if counts is None:
        counts = row_block_counts(cols, vals, blk_d)
    counts = counts.reshape(len(counts), -1) if counts.ndim > 1 else counts[None, :]
    B = min(batch_size, counts.shape[1])
    top = -np.sort(-counts, axis=1)[:, :B]
    bound = int(top.sum(axis=1).max()) if counts.size else 0
    if d is None:
        d = int(cols.max()) + 1 if cols.size else 1
    n_d_blocks = -(-d // blk_d)
    k = cols.shape[-1]
    return max(1, min(bound, n_d_blocks, max(1, batch_size * k)))


def block_map(cols: np.ndarray, vals: np.ndarray, blk_d: int, n_d_blocks: int,
              n_blocks_max: int) -> np.ndarray:
    """Compact touched-block-id map of stacked minibatch planes: ``(m, B, k)``
    cols/vals → ``(m, n_blocks_max)`` int32, each row the node's distinct
    live d-block ids ascending, then the sentinel ``n_d_blocks``. Raises if a
    node touches more than ``n_blocks_max`` blocks (the device twin
    ``hinge_subgrad.sparse.ell_block_map`` drops the highest ids instead)."""
    cols = np.asarray(cols)
    m = cols.shape[0]
    blocks = _entry_blocks(cols.reshape(m, -1), np.asarray(vals).reshape(m, -1),
                           blk_d, n_d_blocks)
    out = np.full((m, n_blocks_max), n_d_blocks, np.int32)
    for i in range(m):
        live = np.unique(blocks[i])
        live = live[live < n_d_blocks]
        if len(live) > n_blocks_max:
            raise ValueError(
                f"node {i} touches {len(live)} blocks > n_blocks_max={n_blocks_max}")
        out[i, :len(live)] = live
    return out


@dataclass
class BlockBuckets:
    """Entries of stacked ``(m, B, k)`` minibatch planes sorted by d-block,
    with per-block entry slices: bucket j of node i holds entries
    ``cols[i, starts[i, j]:starts[i, j+1]]``, all in d-block
    ``block_ids[i, j]``. Empty slots carry the sentinel ``n_d_blocks`` and an
    empty slice; pad entries sort to the tail after the last live bucket.
    The layout that counts blocks per schedule; the kernels keep the planes
    unsorted."""

    block_ids: np.ndarray  # (m, n_blocks_max) int32, sentinel = n_d_blocks
    starts: np.ndarray     # (m, n_blocks_max + 1) int64 slice offsets
    cols: np.ndarray       # (m, B*k) int32 sorted by block id
    vals: np.ndarray       # (m, B*k) float32 sorted with cols
    blk_d: int
    n_d_blocks: int

    @property
    def n_blocks_max(self) -> int:
        """Slots of the map."""
        return self.block_ids.shape[1]

    def blocks_visited(self) -> np.ndarray:
        """(m,) live buckets per node: the blocks a touched-block schedule
        reads (sentinel slots alias one shared zero block)."""
        return (self.block_ids < self.n_d_blocks).sum(axis=1).astype(np.int64)


def bucket_by_block(cols: np.ndarray, vals: np.ndarray, blk_d: int, *,
                    d: int | None = None,
                    n_blocks_max: int | None = None) -> BlockBuckets:
    """Sort and bucket stacked ``(m, B, k)`` minibatch planes by d-block."""
    cols = np.asarray(cols, np.int32)
    vals = np.asarray(vals, np.float32)
    m = cols.shape[0]
    if d is None:
        d = int(cols.max()) + 1 if cols.size else 1
    n_d_blocks = -(-d // blk_d)
    flat_c, flat_v = cols.reshape(m, -1), vals.reshape(m, -1)
    blocks = _entry_blocks(flat_c, flat_v, blk_d, n_d_blocks)
    order = np.argsort(blocks, axis=1, kind="stable")
    sorted_b = np.take_along_axis(blocks, order, axis=1)
    if n_blocks_max is None:
        n_blocks_max = max(1, row_like_max(sorted_b, n_d_blocks))
    ids = np.full((m, n_blocks_max), n_d_blocks, np.int32)
    starts = np.zeros((m, n_blocks_max + 1), np.int64)
    for i in range(m):
        live, first = np.unique(sorted_b[i], return_index=True)
        keep = live < n_d_blocks
        live, first = live[keep], first[keep]
        if len(live) > n_blocks_max:
            raise ValueError(
                f"node {i} touches {len(live)} blocks > n_blocks_max={n_blocks_max}")
        ids[i, :len(live)] = live
        ends = np.append(first[1:], (sorted_b[i] < n_d_blocks).sum())
        starts[i, :len(live)] = first
        starts[i, len(live):] = ends[-1] if len(live) else 0
        starts[i, 1:len(live) + 1] = ends
    return BlockBuckets(ids, starts,
                        np.take_along_axis(flat_c, order, axis=1),
                        np.take_along_axis(flat_v, order, axis=1),
                        blk_d, n_d_blocks)


def row_like_max(sorted_blocks: np.ndarray, sentinel: int) -> int:
    """Max distinct live blocks over the leading axis of block-sorted ids."""
    live = sorted_blocks < sentinel
    first = live[:, :1]
    changed = (sorted_blocks[:, 1:] != sorted_blocks[:, :-1]) & live[:, 1:]
    per = first.sum(axis=1) + changed.sum(axis=1)
    return int(per.max()) if per.size else 0


def pad_query_planes(queries, rows: int, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Pad a list of ragged sparse queries into one fixed-shape ELL batch.

    ``queries``: up to ``rows`` items of ``(cols_i, vals_i)`` 1-D arrays (a
    query's nonzero features). Returns ``(cols, vals)`` planes of exactly
    ``(rows, k)``; entries beyond a query's nnz and rows beyond
    ``len(queries)`` carry the inert ``(0, 0.0)``. This is the one statement
    of the serving buckets' shapes, so the kernel sees one of a small fixed
    set of shapes. Raises if a query has more than ``k`` nonzeros (route it
    to a wider bucket rather than drop features)."""
    if len(queries) > rows:
        raise ValueError(f"{len(queries)} queries > bucket rows={rows}")
    cols = np.zeros((rows, k), np.int32)
    vals = np.zeros((rows, k), np.float32)
    for i, (c, v) in enumerate(queries):
        c = np.asarray(c, np.int32).reshape(-1)
        v = np.asarray(v, np.float32).reshape(-1)
        if c.shape != v.shape:
            raise ValueError(f"query {i}: cols/vals lengths disagree")
        if len(c) > k:
            raise ValueError(f"query {i} has {len(c)} nonzeros > bucket k={k}")
        cols[i, :len(c)] = c
        vals[i, :len(v)] = v
    return cols, vals


def frequency_remap(cols: np.ndarray, vals: np.ndarray, d: int
                    ) -> tuple[np.ndarray, np.ndarray]:
    """Relabel columns by descending document frequency (ties by old id).

    Returns ``(new_cols, perm)`` where ``perm[new] = old``: a weight vector
    learned in remapped space maps back as ``w_old = w_new[inv]`` with
    ``inv = argsort(perm)``. A pure relabelling, so margins, objectives and
    consensus are unchanged up to the permutation; hot columns get low ranks
    and share the leading d-blocks."""
    cols = np.asarray(cols)
    vals = np.asarray(vals)
    freq = np.bincount(cols.reshape(-1)[vals.reshape(-1) != 0], minlength=d)
    perm = np.argsort(-freq, kind="stable").astype(np.int64)   # perm[new] = old
    rank = np.empty(d, np.int64)
    rank[perm] = np.arange(d)
    # pad entries stay canonical (col=0, val=0) rather than inheriting rank[0]
    return np.where(vals != 0, rank[cols], 0).astype(np.int32), perm
