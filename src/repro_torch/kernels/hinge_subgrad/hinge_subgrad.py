"""Wrappers of the dense Pegasos kernels: ``fleet_half_step``, and
``margins`` and ``grad_update``, each of the latter two for the whole fleet
in one launch (CUDA source: ``csrc/hinge_subgrad.cu``).

Each function here takes a plain PyTorch version (``*_plain``) for tensors
on the CPU, and launches its CUDA kernel for tensors on a CUDA device after
checking device, dtype, shape and contiguity; anything else raises. A launch
adds one to the wrapper's ``launches`` attribute, and nothing else does.

``scal`` is the pair ``(s0, s1) = (λα, α/B)`` with α = 1/(λt), as Python
floats holding float32 values (``ops.step_scalars`` forms them). The output
is ``(1 − s0)·w + s1·(coeffᵀX)`` with ``1 − s0`` rounded to float32, as the
reference computes it.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels import _build

__all__ = ["fleet_half_step", "margins", "grad_update", "fleet_cluster", "margins_cluster",
           "fleet_half_step_plain", "margins_plain", "grad_update_plain"]

_SOURCE = Path(__file__).resolve().parent / "csrc" / "hinge_subgrad.cu"
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "fleet_half_step": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _P],
    "margins": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "grad_update": [_P, _P, _P, _P, _I, _I, _I, _F, _F, _P],
}
# one block's shared memory holds fleet_half_step's (B,) partial margins and
# (B,) coefficients beside 16 floats of row pieces
MAX_FLEET_B = (227 * 1024 // 4 - 16) // 2
_CLUSTERS = (1, 2, 4, 8, 16)  # 16 is a non-portable cluster size on Hopper
_MAX_NODES = 65535  # the node axis of grad_update and the sparse kernels is the grid's y


def _lib() -> ctypes.CDLL:
    return _build.load(_SOURCE, _SIGNATURES)


def _f32_pair(scal) -> tuple[float, float]:
    s0, s1 = scal
    return float(np.float32(s0)), float(np.float32(s1))


def _one_minus(s0: float) -> float:
    return float(np.float32(1.0) - np.float32(s0))


# ------------------------------------------------------------ fleet_half_step

def fleet_cluster(m: int, n_sm: int) -> int:
    """Blocks of the thread-block cluster each node gets: the largest power
    of two up to 16 with m·CL <= the card's ``n_sm`` SMs, so every block has
    an SM of its own (1 when m > n_sm). 8 at the paper's m = 10 on 132 SMs,
    where clusters of 16 (160 blocks) measured slower."""
    return max([c for c in _CLUSTERS if m * c <= n_sm] or [1])


def fleet_half_step_plain(X: torch.Tensor, W: torch.Tensor, y: torch.Tensor,
                          row_mask: torch.Tensor, scal) -> torch.Tensor:
    """Plain PyTorch fleet half-step: per node i, m = y_i·(X_i w_i),
    coeff = 1[m<1]·y_i·row_mask, W_half_i = (1 − s0)w_i + s1·coeffᵀX_i."""
    s0, s1 = _f32_pair(scal)
    m = y * torch.einsum("mbd,md->mb", X, W)
    coeff = torch.where(m < 1.0, y, torch.zeros_like(y)) * row_mask
    g = torch.einsum("mb,mbd->md", coeff, X)
    return _one_minus(s0) * W + s1 * g


def fleet_half_step(X: torch.Tensor, W: torch.Tensor, y: torch.Tensor,
                    row_mask: torch.Tensor, scal) -> torch.Tensor:
    """GADGET steps (a)-(e) for all m nodes in one launch.

    X: (m, B, d) per-node minibatch tiles, W: (m, d), y: (m, B),
    row_mask: (B,) float validity of the rows, ``scal`` = (λα, α/B).
    Returns W_half (m, d). No ball projection (``ops.fleet_half_step`` does it).
    On CUDA each node runs as a cluster of ``fleet_cluster(m, SMs)`` blocks.
    """
    if _build.on_cpu(X, W, y, row_mask):
        return fleet_half_step_plain(X, W, y, row_mask, scal)
    return _launch_fleet(X, W, y, row_mask, scal,
                         fleet_cluster(X.shape[0], _build.sm_count(X.device.index)))


def _launch_fleet(X, W, y, row_mask, scal, cluster: int) -> torch.Tensor:
    """The kernel's launch on CUDA tensors with ``cluster`` blocks a node
    (one of 1, 2, 4, 8, 16); ``fleet_half_step`` passes ``fleet_cluster``'s."""
    if X.ndim != 3:
        raise ValueError(f"X must be (m, B, d), got shape {tuple(X.shape)}")
    m, B, d = X.shape
    _build.check_tensor("X", X, (m, B, d))
    _build.check_tensor("W", W, (m, d))
    _build.check_tensor("y", y, (m, B))
    _build.check_tensor("row_mask", row_mask, (B,))
    if not 1 <= B <= MAX_FLEET_B:
        raise ValueError(f"fleet_half_step takes 1 <= B <= {MAX_FLEET_B}, got B={B}")
    if cluster not in _CLUSTERS:
        raise ValueError(f"cluster must be one of {_CLUSTERS}, got {cluster}")
    s0, s1 = _f32_pair(scal)
    out = torch.empty_like(W)
    with torch.cuda.device(X.device):
        code = _lib().fleet_half_step(
            X.data_ptr(), W.data_ptr(), y.data_ptr(), row_mask.data_ptr(), out.data_ptr(),
            m, B, d, cluster, s0, s1, _build.stream(X))
    _build.check(code, "fleet_half_step")
    fleet_half_step.launches += 1
    return out


fleet_half_step.launches = 0


# -------------------------------------------------------------------- margins

def margins_cluster(rows: int, n_sm: int) -> int:
    """Blocks of the thread-block cluster each ``margins`` row gets on a card
    of ``n_sm`` SMs: the largest power of two up to 16 with at most two
    blocks an SM (16 at the unfused reuters fleet's 10 rows and at one row),
    1 from twice the SM count of rows up."""
    return fleet_cluster(rows, 2 * n_sm)


def margins_plain(X: torch.Tensor, W: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch margins y_i·(X_i w_i) per node: X (m, B, d), W (m, d),
    y (m, B) → (m, B); or one node's X (B, d), w (d,), y (B,) → (B,)."""
    if X.ndim == 2:
        return margins_plain(X[None], W[None], y[None])[0]
    return y * torch.bmm(X, W[:, :, None])[:, :, 0]


def margins(X: torch.Tensor, W: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """y_i·(X_i w_i) for the whole fleet in one launch: X (m, B, d), W (m, d),
    y (m, B) → (m, B). One node's X (B, d), w (d,), y (B,) → (B,) is the
    m = 1 case. On CUDA each row is a cluster of ``margins_cluster`` blocks."""
    if X.ndim == 2:
        return margins(X[None], W[None], y[None])[0]
    if _build.on_cpu(X, W, y):
        return margins_plain(X, W, y)
    if X.ndim != 3:
        raise ValueError(f"X must be (m, B, d) or (B, d), got shape {tuple(X.shape)}")
    m, B, d = X.shape
    return _launch_margins(X, W, y, margins_cluster(m * B, _build.sm_count(X.device.index)))


def _launch_margins(X, W, y, cluster: int) -> torch.Tensor:
    """The kernel's launch on CUDA tensors, ``cluster`` blocks a row (one of
    1, 2, 4, 8, 16); ``margins`` passes ``margins_cluster``'s."""
    m, B, d = X.shape
    _build.check_tensor("X", X, (m, B, d))
    _build.check_tensor("W", W, (m, d))
    _build.check_tensor("y", y, (m, B))
    if cluster not in _CLUSTERS:
        raise ValueError(f"cluster must be one of {_CLUSTERS}, got {cluster}")
    out = torch.empty((m, B), dtype=torch.float32, device=X.device)
    with torch.cuda.device(X.device):
        code = _lib().margins(X.data_ptr(), W.data_ptr(), y.data_ptr(), out.data_ptr(),
                              m, B, d, cluster, _build.stream(X))
    _build.check(code, "margins")
    margins.launches += 1
    return out


margins.launches = 0


# ---------------------------------------------------------------- grad_update

def grad_update_plain(X: torch.Tensor, W: torch.Tensor, coeff: torch.Tensor,
                      scal) -> torch.Tensor:
    """Plain PyTorch (1 − s0)·W_i + s1·(coeff_iᵀX_i) per node: X (m, B, d),
    W (m, d), coeff (m, B) → (m, d); or one node's X (B, d), w (d,),
    coeff (B,) → (d,)."""
    if X.ndim == 2:
        return grad_update_plain(X[None], W[None], coeff[None], scal)[0]
    s0, s1 = _f32_pair(scal)
    return _one_minus(s0) * W + s1 * torch.bmm(coeff[:, None, :], X)[:, 0]


def grad_update(X: torch.Tensor, W: torch.Tensor, coeff: torch.Tensor,
                scal) -> torch.Tensor:
    """(1 − s0)·W_i + s1·(coeff_iᵀX_i) for the whole fleet in one launch,
    ``scal`` = (λα, α/B): X (m, B, d), W (m, d), coeff (m, B) → (m, d). One
    node's X (B, d), w (d,), coeff (B,) → (d,) is the m = 1 case. On CUDA a
    thread owns one column; the fleet launch equals the per-node launches
    stacked, bit for bit."""
    if X.ndim == 2:
        return grad_update(X[None], W[None], coeff[None], scal)[0]
    if X.ndim != 3:
        raise ValueError(f"X must be (m, B, d) or (B, d), got shape {tuple(X.shape)}")
    m, B, d = X.shape
    if tuple(W.shape) != (m, d) or tuple(coeff.shape) != (m, B):
        raise ValueError(f"grad_update takes X (m, B, d), W (m, d) and coeff (m, B); got "
                         f"{tuple(X.shape)}, {tuple(W.shape)} and {tuple(coeff.shape)}")
    if _build.on_cpu(X, W, coeff):
        return grad_update_plain(X, W, coeff, scal)
    if m > _MAX_NODES or (B == 1 and m * d >= 2**31):
        raise ValueError(f"grad_update takes m <= {_MAX_NODES} nodes and, at B = 1, "
                         f"m·d < 2^31; got m={m}, d={d}")
    _build.check_tensor("X", X, (m, B, d))
    _build.check_tensor("W", W, (m, d))
    _build.check_tensor("coeff", coeff, (m, B))
    s0, s1 = _f32_pair(scal)
    out = torch.empty_like(W)
    with torch.cuda.device(X.device):
        code = _lib().grad_update(X.data_ptr(), W.data_ptr(), coeff.data_ptr(), out.data_ptr(),
                                  m, B, d, s0, s1, _build.stream(X))
    _build.check(code, "grad_update")
    grad_update.launches += 1
    return out


grad_update.launches = 0
