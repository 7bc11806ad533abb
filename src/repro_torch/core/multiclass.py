"""Multi-class GADGET SVM (the paper's §5 extension to multi-class SVMs).
Port of ``repro.core.multiclass``.

One-vs-rest over the binary solver: class c has its own weight vector,
trained on (x, +1 if y = c else −1), and prediction is argmax_c ⟨w_c, x⟩.
All classes train in one run: the per-node (m, C, d) weights ride through
the local Pegasos half-step and the Push-Sum rounds (Push-Vector over the
stacked classes), so the gossip is shared. Training is plain tensor
arithmetic, as in the reference (no Pallas kernel there either); the R
rounds are ``Bs[r].T @ flat`` over :class:`~repro_torch.core.push_sum.PushSumSim`
matrices.

Draws follow the reference's key chain bit for bit (``core.counter_rng``;
``split(key)[i]`` is ``fold_in(key, i)``): each chunk of ``check_every``
iterations takes ``key, sub = split(key)``, its steps ``split(sub, n)``, a
step's nodes ``split(k, m)`` and a node's ids ``randint(kk, (B,), 0, n_i)``.

:func:`predict_multiclass` scores through ``ops.dense_predict``: the
``dense_scores`` kernel (B8) on CUDA tensors, its plain version on CPU
tensors; ``use_kernels=False`` is the plain argmax.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import counter_rng as crng
from repro_torch.core import svm_objective as obj
from repro_torch.core.gadget import GadgetConfig
from repro_torch.core.push_sum import PushSumSim
from repro_torch.kernels.hinge_subgrad import ops as hinge_ops

__all__ = ["MulticlassResult", "gadget_train_multiclass", "predict_multiclass"]


class MulticlassResult(NamedTuple):
    W: torch.Tensor            # (m, C, d) per-node per-class weights
    w_consensus: torch.Tensor  # (C, d)
    iters: int


def _half_step_all_classes(W, Xb, yb, lam: float, t: int, project: bool):
    """W (m, C, d); one shared minibatch a node, Xb (m, B, d) and integer
    labels yb (m, B), drives every class's binary problem."""
    C = W.shape[1]
    classes = torch.arange(C, device=W.device)
    y_bin = torch.where(yb[:, None, :] == classes[None, :, None], 1.0, -1.0)  # (m, C, B)
    margins = y_bin * torch.bmm(W, Xb.transpose(1, 2))                     # (m, C, B)
    viol = (margins < 1.0).to(Xb.dtype)
    L = torch.bmm(viol * y_bin, Xb) / Xb.shape[1]                           # (m, C, d)
    lam32 = np.float32(lam)
    alpha = np.float32(1.0) / (lam32 * np.float32(t))
    W_half = float(np.float32(1.0) - lam32 * alpha) * W + float(alpha) * L
    return obj.project_ball(W_half, lam) if project else W_half


def _chunk_ids(sub, n: int, m: int, B: int, n_i: int, device) -> torch.Tensor:
    """(n, m, B) ids of a chunk's n steps from the chunk key ``sub``."""
    ar = lambda k: torch.arange(k, dtype=torch.int64, device=device)  # noqa: E731
    k_step = crng.fold_in(sub, ar(n)[:, None, None])     # split(sub, n)[s]
    k_node = crng.fold_in(k_step, ar(m)[None, :, None])  # split(k, m)[i]
    return crng.randint(k_node, ar(B)[None, None, :], n_i)


def gadget_train_multiclass(X_parts, y_parts, n_classes: int,
                            cfg: GadgetConfig = GadgetConfig(), *,
                            device: torch.device | str | None = None) -> MulticlassResult:
    """X_parts: (m, n_i, d); y_parts: (m, n_i) integer labels in [0, C).
    ``device``: CUDA unless given."""
    dev = resolve_device(device)
    X = torch.as_tensor(X_parts).to(device=dev, dtype=torch.float32)
    y = torch.as_tensor(y_parts).to(device=dev, dtype=torch.int64)
    m, n_i, d = X.shape
    C, B, R = int(n_classes), cfg.batch_size, cfg.gossip_rounds
    sim = PushSumSim(m, cfg.topology, seed=cfg.seed)
    key = crng.prng_key(cfg.seed)
    node = torch.arange(m, device=dev)[:, None]
    W = torch.zeros((m, C, d), dtype=torch.float32, device=dev)
    t = 1
    it = 0
    while it < cfg.max_iters:
        n = min(cfg.check_every, cfg.max_iters - it)
        B_stack = torch.from_numpy(np.stack([
            np.stack([sim.matrix(it + s * R + r) for r in range(R)])
            for s in range(n)]).astype(np.float32)).to(dev)
        key, sub = crng.fold_in(key, 0), crng.fold_in(key, 1)  # key, sub = split(key)
        ids = _chunk_ids(sub, n, m, B, n_i, dev)
        W_prev = W
        for s in range(n):
            W_half = _half_step_all_classes(W, X[node, ids[s]], y[node, ids[s]], cfg.lam, t,
                                            cfg.project_before_gossip)
            flat = W_half.reshape(m, C * d)
            for r in range(R):
                flat = B_stack[s, r].T @ flat
            W = flat.reshape(m, C, d)
            t += 1
        it += n
        eps = float(torch.linalg.vector_norm((W - W_prev).reshape(m, -1), dim=1).max())
        if eps < cfg.epsilon:
            break
    return MulticlassResult(W=W, w_consensus=W.mean(dim=0), iters=it)


def predict_multiclass(w_consensus, X, *, use_kernels: bool | None = None) -> torch.Tensor:
    """argmax_c ⟨w_c, x⟩ per row, int32. None or True: ``ops.dense_predict``
    (the B8 kernel on CUDA tensors, its plain version on CPU tensors);
    False: the plain argmax."""
    if use_kernels is None or use_kernels:
        _, labels = hinge_ops.dense_predict(w_consensus, X)
        return labels
    return torch.argmax(X @ w_consensus.T, dim=-1).to(torch.int32)
