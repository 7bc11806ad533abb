"""Snapshot export: versioned serving checkpoints and int8 quantization.

A port of the checkpoint half of ``repro.serve.snapshot`` (the port imports
nothing of ``repro``), writing the same manifests and arrays, so an export
of either package serves in the other:

  * :class:`Snapshot`: one servable model state, ``(iteration, w,
    objective)``. A trained run's is the reference's final ring entry,
    ``Snapshot(res.iters, w_consensus, objective_trace[-1])``.
  * :func:`to_checkpoint` / :func:`from_checkpoint`: a snapshot as a
    ``repro_torch.checkpoint`` step whose manifest ``extra`` carries the
    versioned serving schema (kind, format, dtype, shape, iteration,
    objective), optionally with an embedded train state (``train_W`` /
    ``train_W_sum`` leaves).
  * :func:`quantize_int8` / :func:`dequantize_int8`: symmetric per-class-row
    int8 weights with one float32 scale per row, 4× smaller at rest.

Decoding a training run's snapshot ring and reading an embedded train state
back come with the port's anytime export.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch import checkpoint as ckpt

__all__ = ["Snapshot", "to_checkpoint", "from_checkpoint", "quantize_int8",
           "dequantize_int8", "SERVE_KIND", "SERVE_FORMAT_VERSION"]

SERVE_KIND = "gadget_svm_model"
SERVE_FORMAT_VERSION = 1


def _host(x) -> np.ndarray:
    """A numpy array of a train state's ``W`` / ``W_sum`` (a tensor is
    copied to the host)."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@dataclass(frozen=True)
class Snapshot:
    """One servable model state: the consensus weights at ``iteration`` and
    the primal objective they achieved. ``w`` is (d,) for the paper's binary
    SVM or (C, d) for the one-vs-rest multiclass extension."""

    iteration: int
    w: np.ndarray
    objective: float

    @property
    def d(self) -> int:
        """Feature dimension of the snapshotted weights (last axis of w)."""
        return self.w.shape[-1]

    @property
    def n_classes(self) -> int:
        """1 for a binary (d,) snapshot, C for a multiclass (C, d) one."""
        return 1 if self.w.ndim == 1 else self.w.shape[0]


# ------------------------------------------------------------- quantization


def quantize_int8(w: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Symmetric int8 quantization with one f32 scale per class row.

    ``w``: (d,) or (C, d) → ``(q, scale)`` with ``q`` int8 of the same shape
    and ``scale`` shaped () / (C,) such that ``q ≈ round(w / scale)`` clipped
    to ±127. Max-abs scaling keeps dequantization error ≤ scale/2 per weight.
    """
    w = np.asarray(w, np.float32)
    W2 = w[None] if w.ndim == 1 else w
    scale = (np.maximum(np.abs(W2).max(axis=1), 1e-30) / 127.0).astype(np.float32)
    q = np.clip(np.rint(W2 / scale[:, None]), -127, 127).astype(np.int8)
    if w.ndim == 1:
        return q[0], scale[0]
    return q, scale


def dequantize_int8(q: np.ndarray, scale: np.ndarray) -> np.ndarray:
    """Inverse of :func:`quantize_int8` (up to the ≤ scale/2 rounding)."""
    q = np.asarray(q)
    scale = np.asarray(scale, np.float32)
    if q.ndim == 1:
        return q.astype(np.float32) * scale
    return q.astype(np.float32) * scale[:, None]


# -------------------------------------------------------------- checkpoints


def to_checkpoint(snap: Snapshot, root: str, *, quantize: str | None = None,
                  step: int | None = None, keep: int = 3,
                  lam: float | None = None, train_state=None,
                  trace: dict | None = None, point: bool = True) -> str:
    """Export one snapshot as a servable checkpoint under ``root``.

    ``quantize``: ``None`` ships f32 weights; ``"int8"`` ships the int8 +
    scale pair of :func:`quantize_int8` (dtype-faithful on restore). The
    manifest's ``extra`` carries the serving schema (kind, format version,
    dtype, shape, iteration, objective, and ``lam`` when given), so
    :func:`from_checkpoint` rebuilds the restore tree without out-of-band
    knowledge. ``step`` defaults to the snapshot's iteration.

    ``train_state``: any object with ``iteration``, ``W`` and ``W_sum``
    (arrays or tensors of one shape); it rides along as ``train_W`` /
    ``train_W_sum`` leaves and a ``train_state`` manifest record, as the
    reference's ``TrainState`` does. ``trace`` (a ``TraceContext.to_extra()``
    dict) is stored under ``extra["trace"]``. ``point=False`` leaves the
    ``LATEST`` pointer to the caller (see ``repro_torch.checkpoint.save``).
    """
    if quantize not in (None, "int8"):
        raise ValueError(f"unknown quantize mode {quantize!r}")
    if quantize == "int8":
        q, scale = quantize_int8(snap.w)
        tree = {"w": q, "scale": np.asarray(scale, np.float32)}
    else:
        tree = {"w": np.asarray(snap.w, np.float32)}
    extra = {
        "kind": SERVE_KIND,
        "serve_format": SERVE_FORMAT_VERSION,
        "dtype": "int8" if quantize == "int8" else "float32",
        "d": int(snap.d),
        "n_classes": int(snap.n_classes),
        "binary": snap.w.ndim == 1,
        "iteration": int(snap.iteration),
        "objective": float(snap.objective),
    }
    if lam is not None:
        extra["lam"] = float(lam)
    if trace is not None:
        extra["trace"] = dict(trace)
    if train_state is not None:
        W = _host(train_state.W)
        W_sum = _host(train_state.W_sum)
        if W.shape != W_sum.shape:
            raise ValueError(
                f"train_state W/W_sum shapes differ: {W.shape} vs {W_sum.shape}")
        tree["train_W"] = W
        tree["train_W_sum"] = W_sum
        extra["train_state"] = {
            "iteration": int(train_state.iteration),
            "shape": list(W.shape),
            "dtype": str(W.dtype),
        }
    return ckpt.save(root, snap.iteration if step is None else step, tree,
                     keep=keep, extra=extra, point=point)


def from_checkpoint(root: str, step: int | None = None) -> tuple[np.ndarray, dict]:
    """Load a servable checkpoint back to f32 weights.

    Returns ``(w, extra)``; int8 exports are dequantized here. Rejects
    checkpoints that are not serving exports or carry a newer format
    version, with the manifest contents in the error."""
    manifest = ckpt.read_manifest(root, step)
    extra = manifest.get("extra") or {}
    if extra.get("kind") != SERVE_KIND:
        raise ValueError(
            f"checkpoint under {root} is not a serving export "
            f"(manifest extra: {extra!r}) — write it with serve.snapshot.to_checkpoint")
    if extra.get("serve_format", 0) > SERVE_FORMAT_VERSION:
        raise ValueError(
            f"serving checkpoint format {extra['serve_format']} is newer than "
            f"this build understands ({SERVE_FORMAT_VERSION})")
    d, C, binary = extra["d"], extra["n_classes"], extra["binary"]
    w_shape = (d,) if binary else (C, d)
    if extra["dtype"] == "int8":
        like = {"w": np.zeros(w_shape, np.int8),
                "scale": np.zeros(() if binary else (C,), np.float32)}
    else:
        like = {"w": np.zeros(w_shape, np.float32)}
    like.update(_train_like(extra))
    tree = ckpt.restore(root, like, step)
    if extra["dtype"] == "int8":
        return dequantize_int8(tree["w"], tree["scale"]), extra
    return np.asarray(tree["w"]), extra


def _train_like(extra: dict) -> dict:
    """Template leaves for an embedded train state (empty when absent):
    ``restore`` checks the whole treedef, so a serving load of a checkpoint
    that carries a train state must name its leaves too."""
    ts = extra.get("train_state")
    if not ts:
        return {}
    shape, dtype = tuple(ts["shape"]), np.dtype(ts["dtype"])
    return {"train_W": np.zeros(shape, dtype),
            "train_W_sum": np.zeros(shape, dtype)}
