"""Cutting-plane primal SVM solver (Joachims 2006 "structural formulation").
Port of ``repro.core.cutting_plane``.

The paper's Table 4 compares GADGET against SVM-Perf; this is that baseline's
algorithm at reproduction scale: iteratively add the most-violated aggregate
constraint c in {0,1}^n of

    min_w  (lam/2)|w|^2 + xi
    s.t.   forall c: (1/n) w^T sum_i c_i y_i x_i >= (1/n) sum_i c_i - xi

and solve the reduced master problem through its dual — a k-variable QP over
the simplex {alpha >= 0, sum alpha <= 1} with w = (1/lam) A^T alpha — by
projected gradient ascent (k stays small: tens of cuts).

Terminates when the true empirical risk is within ``tol`` of the cutting-
plane lower bound (the certificate from Joachims' analysis).

Both solvers run in tensor arithmetic on ``device`` (CUDA unless the caller
names the CPU), in the reference's dtypes: w, the dual and the risks in
float64, the cuts and their Gram matrix in the data's dtype (float32 for the
datasets). The reference's branches become selects, so a cut costs one host
sync (the gap test) and an SVM-SGD step none.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch._device import resolve_device

__all__ = ["CuttingPlaneResult", "cutting_plane_svm", "svm_sgd"]


class CuttingPlaneResult(NamedTuple):
    w: torch.Tensor   # (d,) float32
    n_cuts: int
    gap: float
    objective: float


def _project_capped_simplex(alpha: torch.Tensor) -> torch.Tensor:
    """Project onto {a >= 0, sum a <= 1}: the clipped vector when its sum is
    at most 1, else the Euclidean projection onto the simplex (Duchi et al.
    2008), selected on the device."""
    a = alpha.clamp_min(0.0)
    u = torch.sort(a, descending=True).values
    css = torch.cumsum(u, 0)
    k = torch.arange(a.numel(), device=a.device)
    # the condition holds at k = 0 (u_0 > u_0 − 1), so rho >= 0
    rho = torch.where(u * (k + 1).to(a.dtype) > css - 1.0, k, -1).max()
    theta = (css[rho] - 1.0) / (rho + 1).to(a.dtype)
    theta = torch.where(a.sum() > 1.0, theta, torch.zeros_like(theta))
    return (a - theta).clamp_min(0.0)


def cutting_plane_svm(X, y, lam: float, max_cuts: int = 60, tol: float = 1e-3,
                      inner_iters: int = 300, *,
                      device: torch.device | str | None = None) -> CuttingPlaneResult:
    """The cutting-plane SVM on X (n, d) and labels y (n,) in {−1, +1}
    (numpy arrays or tensors, float32 or float64). ``device``: CUDA unless
    given."""
    dev = resolve_device(device)
    X, y = torch.as_tensor(X).to(dev), torch.as_tensor(y).to(dev)
    n, d = X.shape
    X64, y64 = X.to(torch.float64), y.to(torch.float64)
    w = torch.zeros(d, dtype=torch.float64, device=dev)
    A: list[torch.Tensor] = []
    b: list[torch.Tensor] = []
    gap = torch.tensor(float("inf"), dtype=torch.float64)
    for _ in range(max_cuts):
        c = y64 * (X64 @ w) < 1.0
        A.append(((c.to(y.dtype) * y)[:, None] * X).sum(dim=0) / n)
        b.append(c.to(torch.float64).mean())

        Am = torch.stack(A)        # (k, d), the data's dtype
        bv = torch.stack(b)
        G = Am @ Am.T              # (k, k)
        L = (torch.linalg.eigvalsh(G).max() / lam).clamp_min(1e-12)
        G64, Am64 = G.to(torch.float64), Am.to(torch.float64)
        alpha = torch.full((len(b),), 1.0 / len(b), dtype=torch.float64, device=dev)
        for _ in range(inner_iters):
            grad = bv - G64 @ alpha / lam
            alpha = _project_capped_simplex(alpha + grad / L)
        w = Am64.T @ alpha / lam

        risk_true = (1.0 - y64 * (X64 @ w)).clamp_min(0.0).mean()
        risk_lb = (bv - Am64 @ w).max().clamp_min(0.0)
        gap = risk_true - risk_lb
        if float(gap) < tol:  # the cut's one host sync
            break
    obj = 0.5 * lam * (w @ w) + (1.0 - y64 * (X64 @ w)).clamp_min(0.0).mean()
    return CuttingPlaneResult(w=w.to(torch.float32), n_cuts=len(b), gap=float(gap),
                              objective=float(obj))


def svm_sgd(X, y, lam: float, n_epochs: int = 2, seed: int = 0, *,
            device: torch.device | str | None = None) -> torch.Tensor:
    """Bottou's SVM-SGD: one-example SGD on the regularized hinge objective,
    eta_t = 1 / (lam (t + t0)) — the paper's other online baseline. The
    example order is the reference's ``default_rng(seed).permutation``,
    drawn on the host. Returns w (d,) float32 on ``device`` (CUDA unless
    given)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    X, y = torch.as_tensor(X).to(dev), torch.as_tensor(y).to(dev)
    n, d = X.shape
    X64 = X.to(torch.float64)
    w = torch.zeros(d, dtype=torch.float64, device=dev)
    zero = torch.zeros((), dtype=y.dtype, device=dev)
    t0 = 1.0 / lam  # standard warm start heuristic
    t = 0
    for _ in range(n_epochs):
        for i in rng.permutation(n).tolist():
            t += 1
            eta = 1.0 / (lam * (t + t0))
            margin = y[i] * (X64[i] @ w)
            w = w * (1.0 - eta * lam)
            # the step's coefficient, in y's dtype, where the margin is violated, else 0
            w = w + torch.where(margin < 1.0, eta * y[i], zero) * X[i]
    return w.to(torch.float32)
