"""Anytime snapshot export: ring decoding, versioned serving checkpoints,
int8 quantization.

A port of ``repro.serve.snapshot`` (the port imports nothing of ``repro``),
writing the same manifests and arrays, so an export of either package
serves in the other:

  * :class:`Snapshot`: one servable model state, ``(iteration, w,
    objective)``; :func:`snapshots_from` / :func:`latest` decode a
    training run's anytime ring (``gadget_train(..., snapshot_every=K)``)
    into ordered snapshots, the final iterate last.
  * :func:`to_checkpoint` / :func:`from_checkpoint`: a snapshot as a
    ``repro_torch.checkpoint`` step whose manifest ``extra`` carries the
    versioned serving schema (kind, format, dtype, shape, iteration,
    objective), optionally with an embedded train state (``train_W`` /
    ``train_W_sum`` leaves).
  * :func:`train_state_from_checkpoint` / :func:`latest_train_state`: the
    embedded :class:`~repro_torch.core.gadget.TrainState`, for a trainer
    to resume from its last published model.
  * :func:`quantize_int8` / :func:`dequantize_int8`: symmetric per-class-row
    int8 weights with one float32 scale per row, 4× smaller at rest.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch import checkpoint as ckpt
from repro_torch.core.gadget import SnapshotRing, TrainState

__all__ = ["Snapshot", "snapshots_from", "latest", "to_checkpoint", "from_checkpoint",
           "train_state_from_checkpoint", "latest_train_state", "quantize_int8",
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


def _ring_of(source) -> SnapshotRing:
    ring = getattr(source, "snapshots", source)
    if not isinstance(ring, SnapshotRing):
        raise ValueError(
            "no snapshots attached — train with gadget_train(..., "
            "snapshot_every=K) to record the anytime ring")
    return ring


def snapshots_from(source) -> list[Snapshot]:
    """Decode a training result's ring into ordered snapshots.

    ``source``: a ``GadgetResult`` (its ``.snapshots``) or a
    :class:`~repro_torch.core.gadget.SnapshotRing`. Oldest first; when the
    ring wrapped only the latest ``slots`` periodic snapshots survive. The
    final iterate is always last, appended when the run did not end on a
    snapshot iteration (when K exceeds the iterations, it is the only one)."""
    ring = _ring_of(source)
    n_valid = min(ring.count, ring.slots)
    out = [
        Snapshot(int(ring.iterations[j % ring.slots]),
                 np.asarray(ring.W[j % ring.slots]),
                 float(ring.objectives[j % ring.slots]))
        for j in range(ring.count - n_valid, ring.count)
    ]
    if not out or out[-1].iteration != ring.final_iteration:
        out.append(Snapshot(int(ring.final_iteration), np.asarray(ring.final_w),
                            float(ring.final_objective)))
    return out


def latest(source) -> Snapshot:
    """The newest servable state (the final iterate)."""
    return snapshots_from(source)[-1]


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

    ``train_state``: a :class:`~repro_torch.core.gadget.TrainState` (or any
    object with ``iteration``, ``W`` and ``W_sum``, arrays or tensors of one
    shape); it rides along as ``train_W`` / ``train_W_sum`` leaves and a
    ``train_state`` manifest record, enough for
    :func:`train_state_from_checkpoint` to rebuild the per-node state. ``trace`` (a ``TraceContext.to_extra()``
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


def train_state_from_checkpoint(root: str, step: int | None = None) -> TrainState:
    """The :class:`~repro_torch.core.gadget.TrainState` embedded in a
    checkpoint (``W`` and ``W_sum`` as numpy arrays).

    Raises ``ValueError`` when the checkpoint is not a serving export or
    carries no train state: resuming needs the per-node state, not only the
    consensus weights."""
    manifest = ckpt.read_manifest(root, step)
    extra = manifest.get("extra") or {}
    if extra.get("kind") != SERVE_KIND:
        raise ValueError(
            f"checkpoint under {root} is not a serving export "
            f"(manifest extra: {extra!r})")
    ts = extra.get("train_state")
    if not ts:
        raise ValueError(
            f"checkpoint step {manifest.get('step')} under {root} carries no "
            "train state — publish with TrainPublisher(save_train_state=True) "
            "or to_checkpoint(..., train_state=...) to enable crash-resume")
    d, C, binary = extra["d"], extra["n_classes"], extra["binary"]
    w_shape = (d,) if binary else (C, d)
    if extra["dtype"] == "int8":
        like = {"w": np.zeros(w_shape, np.int8),
                "scale": np.zeros(() if binary else (C,), np.float32)}
    else:
        like = {"w": np.zeros(w_shape, np.float32)}
    like.update(_train_like(extra))
    tree = ckpt.restore(root, like, step)
    return TrainState(iteration=int(ts["iteration"]),
                      W=tree["train_W"], W_sum=tree["train_W_sum"])


def latest_train_state(root: str) -> TrainState | None:
    """The latest embedded train state, or None on a cold start (no
    checkpoint yet, no published step, or a latest step without train
    state), so a restarting publisher can fall back to a fresh run."""
    step = ckpt.read_latest(root)
    if step is None:
        return None
    try:
        return train_state_from_checkpoint(root, step)
    except (ValueError, FileNotFoundError):
        # not a serving export, no embedded state, or the step rotated away
        return None
