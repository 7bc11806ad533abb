"""Push-Sum mixing in matrix form (Kempe, Dobra & Gehrke 2003).

Port of ``repro.core.push_sum``'s simulator-path mixing: one gossip round
is the linear map x' = Bᵀx applied to the (n, ...) values and the (n,)
mass weights, and R rounds fold into one matrix P = B_Rᵀ ⋯ B_1ᵀ. These are
plain matrix products, outside any kernel in the reference too.
:class:`PushSumState` is the node-stacked (values, weight) pair the host
simulator (``core.resilience.FaultySim``) gossips.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

__all__ = ["PushSumState", "tree_map", "mix_rounds", "collapse_rounds", "mix_collapsed"]


def tree_map(fn, tree: Any) -> Any:
    """``fn`` over every tensor leaf of nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


class PushSumState(NamedTuple):
    """Push-Sum mass: a values tree whose tensor leaves carry a leading node
    axis of size n, and the (n,) mass weights."""

    values: Any
    weight: torch.Tensor

    def estimate(self) -> Any:
        """Each node's current average estimate v / w."""
        w = self.weight

        def div(v):
            return v / w.reshape(w.shape + (1,) * (v.ndim - w.ndim)).to(v.dtype)

        return tree_map(div, self.values)


def mix_rounds(values: torch.Tensor, weight: torch.Tensor,
               B_rounds: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Apply R rounds x' = Bᵀx in order to (n, ...) values and (n,) weights.
    ``B_rounds``: (R, n, n)."""
    v, w = values, weight
    for B in B_rounds:
        v, w = B.T @ v, B.T @ w
    return v, w


def collapse_rounds(B_rounds: torch.Tensor) -> torch.Tensor:
    """Fold (..., R, n, n) round stacks into P = B_Rᵀ ⋯ B_1ᵀ, shape (..., n, n):
    ``mix_rounds(v, w, Bs) == (P @ v, P @ w)``. Leading axes are a batch
    (for example a chunk of iterations)."""
    n = B_rounds.shape[-1]
    P = torch.eye(n, dtype=B_rounds.dtype, device=B_rounds.device).expand(
        B_rounds.shape[:-3] + (n, n))
    for r in range(B_rounds.shape[-3]):
        P = B_rounds[..., r, :, :].transpose(-1, -2) @ P
    return P


def mix_collapsed(values: torch.Tensor, weight: torch.Tensor,
                  P: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Apply a collapsed round product: (P @ values, P @ weight)."""
    return P @ values, P @ weight
