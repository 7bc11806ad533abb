"""Wrappers of the serving kernels ``dense_scores`` and ``ell_scores_prefetch``
(CUDA source: ``csrc/predict.cu``).

For tensors on the CPU each wrapper takes its plain PyTorch version; for
tensors on a CUDA device it checks device, dtype, shape and contiguity and
launches the kernel; anything else raises. A launch adds one to the
wrapper's ``launches``, and nothing else does.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.hinge_subgrad.ref import ell_predict_scores_ref
from repro_torch.kernels.hinge_subgrad.sparse import check_bitmap

__all__ = ["dense_scores", "dense_scores_plain", "dense_grid", "even_split", "nan_label",
           "ell_scores_prefetch", "ell_scores_prefetch_plain"]

_SOURCE = Path(__file__).resolve().parent / "csrc" / "predict.cu"
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"dense_scores": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
               "ell_scores_prefetch": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                       _I, _I, _I, _P]}


def nan_label(C: int) -> int:
    """The label of a row with a NaN among its ranked scores: the
    reference's pad-lane count ``128·⌈C/128⌉`` for C class rows, outside
    ``[0, C)``, which its ``dense_predict`` and ``ell_predict`` return."""
    return 128 * -(-C // 128)


def _argmax(S: torch.Tensor, n_classes: int) -> torch.Tensor:
    """First-occurrence argmax over the first ``n_classes`` classes, int32;
    a row with a NaN among them gets :func:`nan_label` of S's width."""
    head = S[:, :n_classes]
    labels = torch.argmax(head, dim=-1).to(torch.int32)
    return torch.where(torch.isnan(head).any(dim=-1), nan_label(S.shape[1]), labels)


def even_split(n: int, parts: int) -> list[tuple[int, int]]:
    """``dense_scores``' split of n items into ``parts`` contiguous ranges,
    the first ``n % parts`` one item longer: rows over the blocks of the
    grid, and a block's 16-byte units over its warps."""
    q, r = divmod(n, parts)
    starts = [i * q + min(i, r) for i in range(parts + 1)]
    return list(zip(starts[:-1], starts[1:]))


def dense_grid(B: int, n_sm: int) -> int:
    """Blocks of the ``dense_scores`` launch: one wave of one block per SM,
    and no block without a row."""
    return max(1, min(B, n_sm))


def dense_scores_plain(X: torch.Tensor, W: torch.Tensor, *,
                       n_classes: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch scores S = X Wᵀ and first-occurrence argmax over the
    first ``n_classes`` class rows (int32; ``nan_label(C)`` for a row with a
    NaN among them)."""
    S = X @ W.T
    return S, _argmax(S, n_classes)


def dense_scores(X: torch.Tensor, W: torch.Tensor, *,
                 n_classes: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused scores and argmax in one launch: X (B, d) queries against W (C, d)
    class weights → (scores (B, C) float32, labels (B,) int32), the labels
    being the first-occurrence argmax over classes ``c < n_classes``, and
    ``nan_label(C)`` for a row with a NaN among those classes."""
    if _build.on_cpu(X, W):
        return dense_scores_plain(X, W, n_classes=n_classes)
    B, d = X.shape
    C = W.shape[0]
    _build.check_tensor("X", X, (B, d))
    _build.check_tensor("W", W, (C, d))
    if not 1 <= n_classes <= C:
        raise ValueError(f"n_classes must lie in [1, {C}], got {n_classes}")
    S = torch.empty((B, C), dtype=torch.float32, device=X.device)
    labels = torch.empty((B,), dtype=torch.int32, device=X.device)
    with torch.cuda.device(X.device):
        n_sm = _build.sm_count(X.device.index)
        code = _build.load(_SOURCE, _SIGNATURES).dense_scores(
            X.data_ptr(), W.data_ptr(), S.data_ptr(), labels.data_ptr(),
            B, d, C, n_classes, nan_label(C), dense_grid(B, n_sm), _build.stream(X))
    _build.check(code, "dense_scores")
    dense_scores.launches += 1
    return S, labels


dense_scores.launches = 0


def ell_scores_prefetch_plain(cols: torch.Tensor, vals: torch.Tensor, W: torch.Tensor,
                              block_ids: torch.Tensor, *, blk_d: int, n_d_blocks: int,
                              n_classes: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch scores over the entries whose d-block is in the map,
    and the first-occurrence argmax over the first ``n_classes`` classes
    (``nan_label(C)`` for a row with a NaN among them)."""
    table = torch.zeros(n_d_blocks + 1, dtype=torch.bool, device=cols.device)
    table[block_ids.long().clamp(0, n_d_blocks)] = True
    table[n_d_blocks] = False  # the sentinel marks nothing
    kept = torch.where(table[(cols.long() // blk_d).clamp(0, n_d_blocks)], vals,
                       torch.zeros_like(vals))
    S = ell_predict_scores_ref(W, cols, kept)
    return S, _argmax(S, n_classes)


def ell_scores_prefetch(cols: torch.Tensor, vals: torch.Tensor, W: torch.Tensor,
                        block_ids: torch.Tensor, *, blk_d: int, n_d_blocks: int,
                        n_classes: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Touched-block scores and argmax for one padded-ELL query batch.

    cols/vals: (B, k) int32 / float32 planes (pad entries (0, 0) inert);
    W: (C, d) class weights, unpadded; ``block_ids``: (n_blocks_max,) int32
    batch-wide map of live d-blocks (blocks of ``blk_d`` columns), then the
    sentinel ``n_d_blocks``. An entry counts only if its block is in the map,
    as on the TPU: with a sound cap that is every live entry, with an
    undersized one the dropped blocks' entries are lost. Returns
    (scores (B, C) float32, labels (B,) int32), the labels the
    first-occurrence argmax over classes ``c < n_classes`` and
    ``nan_label(C)`` for a row with a NaN among them.
    """
    if _build.on_cpu(cols, vals, W, block_ids):
        return ell_scores_prefetch_plain(cols, vals, W, block_ids, blk_d=blk_d,
                                         n_d_blocks=n_d_blocks, n_classes=n_classes)
    B, k = cols.shape
    C, d = W.shape
    _build.check_tensor("cols", cols, (B, k), torch.int32)
    _build.check_tensor("vals", vals, (B, k))
    _build.check_tensor("W", W, (C, d))
    n_blocks_max = block_ids.shape[0] if block_ids.ndim == 1 else -1
    _build.check_tensor("block_ids", block_ids, (n_blocks_max,), torch.int32)
    if not 1 <= n_classes <= C:
        raise ValueError(f"n_classes must lie in [1, {C}], got {n_classes}")
    if blk_d < 1:
        raise ValueError(f"blk_d must be >= 1, got {blk_d}")
    check_bitmap(n_d_blocks, d, blk_d)
    S = torch.empty((B, C), dtype=torch.float32, device=W.device)
    labels = torch.empty((B,), dtype=torch.int32, device=W.device)
    with torch.cuda.device(W.device):
        code = _build.load(_SOURCE, _SIGNATURES).ell_scores_prefetch(
            cols.data_ptr(), vals.data_ptr(), W.data_ptr(), block_ids.data_ptr(),
            S.data_ptr(), labels.data_ptr(), B, k, d, C, n_classes, nan_label(C), n_blocks_max,
            blk_d, n_d_blocks, _build.stream(W))
    _build.check(code, "ell_scores_prefetch")
    ell_scores_prefetch.launches += 1
    return S, labels


ell_scores_prefetch.launches = 0
