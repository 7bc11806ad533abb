"""Wrapper of the dense serving kernel ``dense_scores`` (CUDA source:
``csrc/predict.cu``).

For tensors on the CPU the wrapper takes the plain PyTorch version; for
tensors on a CUDA device it checks device, dtype, shape and contiguity and
launches the kernel; anything else raises. A launch adds one to
``dense_scores.launches``, and nothing else does.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build

__all__ = ["dense_scores", "dense_scores_plain"]

_SOURCE = Path(__file__).resolve().parent / "csrc" / "predict.cu"
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"dense_scores": [_P, _P, _P, _P, _I, _I, _I, _I, _P]}


def dense_scores_plain(X: torch.Tensor, W: torch.Tensor, *,
                       n_classes: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch scores S = X Wᵀ and first-occurrence argmax over the
    first ``n_classes`` class rows (int32)."""
    S = X @ W.T
    labels = torch.argmax(S[:, :n_classes], dim=-1).to(torch.int32)
    return S, labels


def dense_scores(X: torch.Tensor, W: torch.Tensor, *,
                 n_classes: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused scores and argmax in one launch: X (B, d) queries against W (C, d)
    class weights → (scores (B, C) float32, labels (B,) int32), the labels
    being the first-occurrence argmax over classes ``c < n_classes``."""
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
        code = _build.load(_SOURCE, _SIGNATURES).dense_scores(
            X.data_ptr(), W.data_ptr(), S.data_ptr(), labels.data_ptr(),
            B, d, C, n_classes, _build.stream(X))
    _build.check(code, "dense_scores")
    dense_scores.launches += 1
    return S, labels


dense_scores.launches = 0
