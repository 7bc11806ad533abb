"""Centralised Pegasos (Shalev-Shwartz, Singer & Srebro 2007). Port of
``repro.core.pegasos``.

The paper's "Centralized" baseline (Table 3): the primal estimated
sub-gradient solver on the whole dataset on one node. The minibatch size k
does not affect the convergence guarantee.

Minibatch ids are the reference's draws bit for bit:
``randint(fold_in(PRNGKey(seed), t), (k,), 0, n)`` through
``core.counter_rng``, all T iterations' ids drawn on the device at once.
Each step is ``svm_objective.pegasos_update``, plain PyTorch as the
reference's is (its ``pegasos_train`` reaches no Pallas kernel). The loop
runs on the device with no host sync; the objective is computed only at
``trace_every`` steps.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch._device import resolve_device
from repro_torch.core import counter_rng as crng
from repro_torch.core import svm_objective as obj

__all__ = ["PegasosResult", "pegasos_train", "pegasos_objective_trace"]


class PegasosResult(NamedTuple):
    w: torch.Tensor           # final weight vector (d,)
    w_avg: torch.Tensor       # iterate average (the vector Theorem 2 bounds)
    objective: torch.Tensor   # primal objective, (T,) with NaN off the trace steps, or ()


def _batch_ids(seed: int, n_iters: int, n: int, k: int, device: torch.device) -> torch.Tensor:
    """(T, k) int64 row ids of iterations 1 … T: the reference's
    ``randint(fold_in(PRNGKey(seed), t), (k,), 0, n)``."""
    t = torch.arange(1, n_iters + 1, dtype=torch.int64, device=device)
    key = crng.fold_in(crng.prng_key(seed), t[:, None])
    return crng.randint(key, torch.arange(k, dtype=torch.int64, device=device)[None, :], n)


def pegasos_train(X, y, lam: float, n_iters: int, batch_size: int = 1, seed: int = 0,
                  trace_every: int = 0, *,
                  device: torch.device | str | None = None) -> PegasosResult:
    """T Pegasos iterations over X (n, d) and labels y (n,) in {−1, +1}
    (numpy arrays or tensors); records the primal objective every
    ``trace_every`` steps (0: only the final objective). ``device``: CUDA
    unless given."""
    dev = resolve_device(device)
    X = torch.as_tensor(X).to(device=dev, dtype=torch.float32)
    y = torch.as_tensor(y).to(device=dev, dtype=torch.float32)
    n, d = X.shape
    ids = _batch_ids(seed, n_iters, n, batch_size, dev)
    w = torch.zeros((d,), dtype=torch.float32, device=dev)
    w_sum = torch.zeros_like(w)
    trace = (torch.full((n_iters,), float("nan"), device=dev) if trace_every else None)
    for t in range(1, n_iters + 1):
        rows = ids[t - 1]
        w = obj.pegasos_update(w, X[rows], y[rows], lam, t)
        w_sum = w_sum + w
        if trace_every and t % trace_every == 0:
            trace[t - 1] = obj.primal_objective(w, X, y, lam)
    objective = trace if trace_every else obj.primal_objective(w, X, y, lam)
    return PegasosResult(w=w, w_avg=w_sum / n_iters, objective=objective)


def pegasos_objective_trace(result: PegasosResult) -> torch.Tensor:
    """The objective trace without its NaN (unrecorded) entries."""
    tr = result.objective
    return tr[~torch.isnan(tr)] if tr.ndim else tr[None]
