"""Plain PyTorch oracles for the Pegasos hinge-subgradient step.

Port of ``repro.kernels.hinge_subgrad.ref``: margins = X w;
L = Xᵀ(1[margin<1]·y)/B; w' = (1 − λα)w + αL; projection onto the 1/√λ
ball; serving scores S = X Wᵀ. The ELL oracles compute the same over
padded-ELL planes (pad entries (col=0, val=0), pad rows y=0) as a
gather-dot and a scatter-add. These are the math the CUDA kernels are held
to, written directly in PyTorch with no kernel in the way.
"""
from __future__ import annotations

import torch

from repro_torch.core.svm_objective import project_ball

__all__ = ["half_step_ref", "fleet_half_step_ref", "ell_margins_ref",
           "ell_matvec_flat", "ell_fleet_half_step_ref", "predict_scores_ref",
           "predict_labels_ref", "ell_predict_scores_ref", "pegasos_step_ref"]


def half_step_ref(w: torch.Tensor, X: torch.Tensor, y: torch.Tensor, lam: float,
                  t: float, project: bool = True) -> torch.Tensor:
    """Pegasos half-step for one node, optional projection, no loss scalar."""
    margins = y * (X @ w)
    viol = (margins < 1.0).to(X.dtype)
    L = (X.T @ (viol * y)) / X.shape[0]
    alpha = 1.0 / (lam * t)
    w_half = (1.0 - lam * alpha) * w + alpha * L
    return project_ball(w_half, lam) if project else w_half


def fleet_half_step_ref(W: torch.Tensor, X: torch.Tensor, y: torch.Tensor, lam: float,
                        t: float, project: bool = True) -> torch.Tensor:
    """Steps (a)-(e) for all m nodes at once. X: (m, B, d), W: (m, d),
    y: (m, B) with padded rows carrying y=0."""
    B = X.shape[1]
    margins = y * torch.einsum("mbd,md->mb", X, W)
    coeff = torch.where(margins < 1.0, y, torch.zeros_like(y))
    L = torch.einsum("mb,mbd->md", coeff, X) / B
    alpha = 1.0 / (lam * t)
    W_half = (1.0 - lam * alpha) * W + alpha * L
    return project_ball(W_half, lam) if project else W_half


def ell_margins_ref(w: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
                    y: torch.Tensor) -> torch.Tensor:
    """y·(X w) over one node's (B, k) ELL minibatch planes."""
    return y * (vals * w[cols]).sum(dim=-1)


def ell_matvec_flat(w: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """X w for flat (N, k) ELL planes, as a gather-dot."""
    return (vals * w[cols]).sum(dim=-1)


def ell_fleet_half_step_ref(W: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
                            y: torch.Tensor, lam: float, t: float,
                            project: bool = True) -> torch.Tensor:
    """Steps (a)-(e) for all m nodes over (m, B, k) ELL minibatch planes:
    gather-dot margins against each node's w, then a scatter-add of the
    violator-weighted values. W: (m, d), y: (m, B)."""
    m, B, k = cols.shape
    idx = cols.reshape(m, B * k).long()
    margins = y * (vals * torch.gather(W, 1, idx).reshape(m, B, k)).sum(dim=-1)
    coeff = torch.where(margins < 1.0, y, torch.zeros_like(y))
    L = torch.zeros_like(W).scatter_add_(
        1, idx, (coeff[:, :, None] * vals).reshape(m, B * k)) / B
    alpha = 1.0 / (lam * t)
    W_half = (1.0 - lam * alpha) * W + alpha * L
    return project_ball(W_half, lam) if project else W_half


def predict_scores_ref(W: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """S = X Wᵀ. W: (C, d) class weights (C=1 for binary), X: (B, d)."""
    return X @ W.T


def predict_labels_ref(W: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """First-occurrence argmax_c S[b, c], int32."""
    return torch.argmax(predict_scores_ref(W, X), dim=-1).to(torch.int32)


def ell_predict_scores_ref(W: torch.Tensor, cols: torch.Tensor,
                           vals: torch.Tensor) -> torch.Tensor:
    """Scores of one (B, k) padded-ELL query batch as a gather-dot against
    every class row: S[b, c] = Σ_k vals[b,k]·W[c, cols[b,k]]. W: (C, d).
    Pad entries (val=0) are inert; an all-pad row scores 0 for every class."""
    return torch.einsum("bk,cbk->bc", vals, W[:, cols.long()])


def pegasos_step_ref(w: torch.Tensor, X: torch.Tensor, y: torch.Tensor, lam: float,
                     t: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (w_new (d,), mean hinge loss ()). X: (B, d); y: (B,) in {−1, +1}."""
    margins = y * (X @ w)
    viol = (margins < 1.0).to(X.dtype)
    L = (X.T @ (viol * y)) / X.shape[0]
    alpha = 1.0 / (lam * t)
    w_half = (1.0 - lam * alpha) * w + alpha * L
    loss = torch.clamp(1.0 - margins, min=0.0).mean()
    return project_ball(w_half, lam), loss
