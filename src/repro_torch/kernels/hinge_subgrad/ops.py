"""Dispatch layer over the dense kernels: the Pegasos half-step for one node
or for the whole fleet, the Pegasos step with its loss, and fused serving
scores. Port of the dense part of ``repro.kernels.hinge_subgrad.ops``.

The step scalars ``α = 1/(λt)``, ``λα`` and ``α/B`` are formed in float32 as
the reference forms them, the violator coefficients of the unfused path and
the ball projection are plain PyTorch around the kernels, as in the
reference. The kernels stream X from device memory and have no tile limit,
so unlike the reference there is no padding to (8, 128) blocks, no
128-lane class padding, and no VMEM cut-over from the fused fleet kernel
to the two-kernel path.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.svm_objective import project_ball
from repro_torch.kernels.hinge_subgrad import hinge_subgrad as K
from repro_torch.kernels.hinge_subgrad import predict as P

__all__ = ["step_scalars", "padded_row_mask", "local_half_step", "fleet_half_step",
           "pegasos_step", "dense_predict", "launch_cost"]


def step_scalars(lam: float, t: int, B: int) -> tuple[float, float]:
    """``(λα, α/B)`` with α = 1/(λt), each operation rounded to float32."""
    lam32 = np.float32(lam)
    alpha = np.float32(1.0) / (lam32 * np.float32(t))
    return float(lam32 * alpha), float(alpha / np.float32(B))


def padded_row_mask(n_padded: int, n_valid: int,
                    device: torch.device | str | None = None) -> torch.Tensor:
    """(n_padded,) bool mask of the real minibatch rows.

    Padded rows carry y=0, so their violator coefficient 1[m<1]·y is 0 with
    no mask at all; anything that counts or sums rows (the hinge loss of
    ``pegasos_step``, the coefficient masking of the fleet kernel) ANDs with
    this mask.
    """
    return torch.arange(n_padded, device=device) < n_valid


def local_half_step(w: torch.Tensor, X: torch.Tensor, y: torch.Tensor, *,
                    lam: float, t: int, project: bool = True) -> torch.Tensor:
    """GADGET step (e)+(f) for one node: ``margins`` and ``grad_update``
    launches with the violator coefficients between them, then the optional
    ball projection. w: (d,), X: (B, d), y: (B,)."""
    B = X.shape[0]
    m = K.margins(X, w, y)
    coeff = torch.where(m < 1.0, y, torch.zeros_like(y))
    w_half = K.grad_update(X, w, coeff, step_scalars(lam, t, B))
    return project_ball(w_half, lam) if project else w_half


def fleet_half_step(W: torch.Tensor, X: torch.Tensor, y: torch.Tensor, *,
                    lam: float, t: int, project: bool = True,
                    row_mask: torch.Tensor | None = None) -> torch.Tensor:
    """GADGET steps (a)-(e) for all m nodes in one ``fleet_half_step`` launch,
    then the optional per-row ball projection. W: (m, d), X: (m, B, d),
    y: (m, B); ``row_mask`` (B,) float, all rows valid when omitted."""
    B = X.shape[1]
    if row_mask is None:
        row_mask = torch.ones((B,), dtype=torch.float32, device=X.device)
    W_half = K.fleet_half_step(X, W, y, row_mask, step_scalars(lam, t, B))
    return project_ball(W_half, lam) if project else W_half


def pegasos_step(w: torch.Tensor, X: torch.Tensor, y: torch.Tensor, *,
                 lam: float, t: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel-backed Pegasos step → (projected w_new (d,), mean hinge loss)."""
    B = X.shape[0]
    m = K.margins(X, w, y)
    coeff = torch.where(m < 1.0, y, torch.zeros_like(y))
    loss = torch.clamp(1.0 - m, min=0.0).sum() / B
    w_half = K.grad_update(X, w, coeff, step_scalars(lam, t, B))
    return project_ball(w_half, lam), loss


def dense_predict(W: torch.Tensor, X: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused serving scores and argmax in one ``dense_scores`` launch.

    W: (d,) binary weights or (C, d) one-vs-rest class matrix; X: (B, d).
    Binary → ((B,) margins, (B,) float32 labels in {−1, +1}, +1 at margin 0);
    multiclass → ((B, C) scores, (B,) int32 first-occurrence argmax).
    """
    if W.ndim not in (1, 2):
        raise ValueError(f"W must be (d,) or (C, d), got shape {tuple(W.shape)}")
    binary = W.ndim == 1
    W2 = W.reshape(1, -1) if binary else W
    scores, labels = P.dense_scores(X, W2, n_classes=W2.shape[0])
    if binary:
        s = scores[:, 0]
        return s, torch.where(s >= 0.0, 1.0, -1.0).to(torch.float32)
    return scores, labels


def launch_cost(kind: str, *, m: int = 1, B: int = 0, d: int = 0, C: int = 1) -> dict:
    """Per-call cost of one dense entry point, from shapes alone.

    Returns ``{"launches", "bytes", "flops"}``. Bytes count each input read
    from device memory once and each output written once (float32 and
    int32 both 4 bytes), whatever a kernel reads again from cache; flops
    count a multiply-add as 2. This is the byte model behind the kernels'
    bandwidth bounds. Kinds: ``margins``, ``grad_update``,
    ``local_half_step`` (the two launches of the unfused node step),
    ``fleet_half_step`` (always one launch: the port has no tile limit) and
    ``dense_predict``.
    """
    if kind == "margins":
        return {"launches": 1, "bytes": 4 * (B * d + d + 2 * B),
                "flops": 2 * B * d + B}
    if kind == "grad_update":
        return {"launches": 1, "bytes": 4 * (B * d + 2 * d + B),
                "flops": 2 * B * d + 3 * d}
    if kind == "local_half_step":
        a, b = launch_cost("margins", B=B, d=d), launch_cost("grad_update", B=B, d=d)
        return {key: a[key] + b[key] for key in a}
    if kind == "fleet_half_step":
        return {"launches": 1, "bytes": 4 * (m * B * d + 2 * m * d + m * B + B),
                "flops": m * (4 * B * d + B + 3 * d)}
    if kind == "dense_predict":
        return {"launches": 1, "bytes": 4 * (B * d + C * d + B * C + B),
                "flops": 2 * B * C * d}
    raise ValueError(f"unknown kernel kind {kind!r}")
