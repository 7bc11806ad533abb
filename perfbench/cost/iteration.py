"""Least work of one GADGET iteration and of its layers, from shapes and
the draws alone: each input byte read once, each output byte written once,
operations counted by what these inputs need.

The shapes: m nodes, weights of width d, a minibatch of B rows a node, rows
stored dense (d floats) or as k ELL entries (a column and a value each).
``nnz`` is the number of nonzeros in the iteration's collapsed (m, m)
mixing product, which the draws decide: a dense (m, m) GEMM would count
m*m, but the mix needs only these.
"""
from __future__ import annotations

import json
from pathlib import Path

import torch

F32 = 4
PEAKS = json.loads((Path(__file__).with_name("peaks.json")).read_text())


def peaks(kind: str) -> dict | None:
    """The published peaks of the card named ``kind``, or None."""
    for name, entry in PEAKS.items():
        if name == kind or name.split()[1] in kind.split():
            return entry
    return None


def least_seconds(work: dict, peak: dict) -> float:
    """The larger of operations over the f32 peak and bytes over the HBM peak."""
    return max(work["flops"] / peak["f32_flops_per_s"], work["bytes"] / peak["hbm_bytes_per_s"])


def _rows(m: int, B: int, d: int, k: int | None) -> tuple[int, int]:
    """Bytes of the minibatch rows and their labels, and the half-step's
    operations on them (margins and gradient: two multiply-adds an entry)."""
    entries = m * B * (d if k is None else k)
    row_bytes = F32 * entries * (1 if k is None else 2) + F32 * m * B
    return row_bytes, 4 * entries + m * B


def half_step(m: int, B: int, d: int, k: int | None) -> dict:
    """Steps (a)-(f): the rows, labels and W read, the projected W_half
    written; the margins, the gradient, the decay and update (3 an entry of
    W) and the projection (norm and scale, 3)."""
    row_bytes, row_flops = _rows(m, B, d, k)
    return {"bytes": row_bytes + 2 * F32 * m * d, "flops": row_flops + 6 * m * d}


def mix(m: int, d: int, nnz: float) -> dict:
    """The collapsed Push-Sum mix: n_i * W_half and the masses read, the
    product's nonzeros read, the mixed values and weights written;
    2 * nnz * (d + 1) operations."""
    return {"bytes": F32 * (2 * m * d + 2 * m + nnz), "flops": 2 * nnz * (d + 1)}


def projection(m: int, d: int) -> dict:
    """The ball projection after gossip (step h): the mixed W read and the
    projected W written; each row's norm and scale, 3 operations an entry."""
    return {"bytes": 2 * F32 * m * d, "flops": 3 * m * d}


def iteration(m: int, B: int, d: int, k: int | None, nnz: float) -> dict:
    """One whole iteration: W and W_sum read and written, the minibatch rows
    and labels read once, the mix's nonzeros read; the half-step's, the
    mix's, the renormalising divide's, the second projection's and the
    running sum's operations."""
    row_bytes, row_flops = _rows(m, B, d, k)
    flops = row_flops + 6 * m * d + 2 * nnz * (d + 1) + m * d + 3 * m * d + m * d
    return {"bytes": F32 * 4 * m * d + row_bytes + F32 * nnz, "flops": flops}


def mix_nnz(rounds: torch.Tensor) -> float:
    """Mean nonzeros of the collapsed products P = B_R^T ... B_1^T of
    (n, R, m, m) round stacks."""
    P = rounds[:, 0].transpose(-1, -2)
    for r in range(1, rounds.shape[1]):
        P = rounds[:, r].transpose(-1, -2) @ P
    return float((P != 0).sum()) / rounds.shape[0]
