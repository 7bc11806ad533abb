"""SvmServer: the snapshot-and-serve engine over the fused predict kernels.

A port of ``repro.serve.engine`` (the port imports nothing of ``repro``).
The server loads a model (a live :class:`~repro_torch.serve.snapshot.Snapshot`
or a versioned checkpoint, f32 or int8 + scale) and answers queries two
ways:

  * :meth:`SvmServer.score`: dense (B, d) batches through ``ops.dense_predict``
    (the ``dense_scores`` kernel), one launch per batch;
  * :meth:`SvmServer.score_sparse`: padded-ELL (B, k) batches through
    ``ops.ell_predict`` (the ``ell_scores_prefetch`` kernel): the batch's
    touched-block map is built on the host (``formats.block_map``), and
    the planes and the map are uploaded for one launch per batch.

The served weight planes are device tensors (CUDA unless ``device`` names
another); the host copy :attr:`SvmServer.W` stays numpy, as in the
reference. PyTorch has no jit cache, so the server keeps the set of the
shapes it has served under the reference's keys (``("dense", B)`` and
``("ell", B, k, cap)``); ``stats()["distinct_shapes"]`` is its size, the
number the bucketed batcher's ≤ ``len(buckets)`` guarantee is held to, and
it stays flat across hot swaps, which replace the weight plane only.

:meth:`SvmServer.watch` + :meth:`SvmServer.maybe_reload` are the consuming
half of the train-to-serve loop: between drains the server polls the
checkpoint root's ``LATEST`` pointer and hot-swaps when it moved, forward
on a publish, backward on a rollback (``checkpoint.point_latest``); a step
that fails to load ``reload_quarantine`` times is quarantined.

:func:`make_mesh_scorer` is the batch-parallel scorer over a
:class:`~repro_torch.core.mesh.Mesh` of processes: every rank scores its
slice of the batch with ``dense_scores`` and the slices are all-gathered.
"""
from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import checkpoint as ckpt
from repro_torch._device import resolve_device
from repro_torch.core.mesh import Mesh
from repro_torch.kernels.hinge_subgrad import ops as hinge_ops
from repro_torch.kernels.hinge_subgrad import ref as hinge_ref
from repro_torch.serve import snapshot as snap_mod
from repro_torch.serve.batcher import Bucket
from repro_torch.sparse.formats import DEFAULT_BUCKET_BLK_D, block_map
from repro_torch.telemetry import trace as tmtr
from repro_torch.telemetry.registry import Registry

__all__ = ["SvmServer", "make_mesh_scorer"]

# Counters every server keeps on its registry (as ``serve.<key>`` series);
# stats() reads them back under these exact keys.
_STAT_KEYS = ("queries", "batches", "sparse_batches", "blocks_visited",
              "dense_block_equivalent", "cap_overflows", "swaps",
              "reload_errors", "quarantined", "plane_swaps")


class SvmServer:
    """Load-once, score-many serving engine for GADGET SVM models.

    ``W``: (d,) binary weights or (C, d) one-vs-rest class matrix (numpy).
    ``device``: where the weight planes live and the kernels
    run; CUDA unless the caller names another (raises without a card).
    ``use_kernels``: None or True scores through ``ops`` (the kernel on a
    CUDA device, its plain version on the CPU); False is the caller's
    request for the ``ref`` oracles. ``meta`` carries the checkpoint's
    manifest ``extra`` when loaded from disk. ``registry``: where the
    ``serve.*`` counters and the per-call kernel accounting land, private
    per server by default.
    """

    def __init__(self, W, *, meta: dict | None = None,
                 blk_d: int = DEFAULT_BUCKET_BLK_D,
                 use_kernels: bool | None = None,
                 reload_quarantine: int = 3,
                 registry: Registry | None = None,
                 device: str | torch.device | None = None):
        W = np.asarray(W, np.float32)
        if W.ndim not in (1, 2):
            raise ValueError(f"W must be (d,) or (C, d), got {W.shape}")
        if reload_quarantine < 1:
            raise ValueError(
                f"reload_quarantine must be >= 1, got {reload_quarantine}")
        self.device = resolve_device(device)
        self.W = W
        self.binary = W.ndim == 1
        self.d = int(W.shape[-1])
        self.n_classes = 1 if self.binary else int(W.shape[0])
        self.meta = dict(meta or {})
        self.blk_d = int(blk_d)
        self.n_d_blocks = -(-self.d // self.blk_d)
        self.use_kernels = use_kernels is None or bool(use_kernels)
        self.reload_quarantine = int(reload_quarantine)
        # Weight planes the server can step between: "f32" is the model,
        # "int8" (built on first use) its quantize→dequantize image. Same
        # shape and dtype, so switching planes changes no served shape.
        self._W_dev = self._upload(W)
        self._planes: dict[str, torch.Tensor] = {"f32": self._W_dev}
        self._plane = "f32"
        self._shapes: set[tuple] = set()
        self._watch_root: str | None = None
        self._watch_step: int | None = None
        self._reload_failures: dict[int, int] = {}
        # (step, swap ctx) awaiting its first scoring call
        self._pending_first_score: tuple[int, tmtr.TraceContext] | None = None
        self.registry = registry if registry is not None else Registry()

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.require(a, requirements=["C", "W"])).to(self.device)

    def _count(self, key: str, n: int = 1) -> None:
        self.registry.counter(f"serve.{key}").inc(n)

    # ------------------------------------------------------------- loading

    @classmethod
    def from_snapshot(cls, snap: snap_mod.Snapshot, **kw) -> "SvmServer":
        """Serve a live training snapshot (no disk round-trip)."""
        meta = {"iteration": snap.iteration, "objective": snap.objective}
        return cls(snap.w, meta=meta, **kw)

    @classmethod
    def load(cls, root: str, step: int | None = None, **kw) -> "SvmServer":
        """Restore a ``serve.snapshot.to_checkpoint`` export (f32 or int8;
        quantized weights are dequantized once here, scoring runs f32)."""
        w, extra = snap_mod.from_checkpoint(root, step)
        return cls(w, meta=extra, **kw)

    @classmethod
    def watch(cls, root: str, **kw) -> "SvmServer":
        """Serve the checkpoint the root's ``LATEST`` pointer designates and
        keep watching it: :meth:`maybe_reload` polls the pointer and
        hot-swaps when the published version moves."""
        step = ckpt.read_latest(root)
        if step is None:
            raise FileNotFoundError(f"no complete checkpoints under {root}")
        t0 = time.monotonic()
        w, extra = snap_mod.from_checkpoint(root, step)
        srv = cls(w, meta=extra, **kw)
        srv._watch_root = root
        srv._watch_step = step
        # the initial install is a swap too, the first serve-side lineage stage
        srv._emit_swap_span(step, time.monotonic() - t0, extra=extra)
        return srv

    # ------------------------------------------------------------ hot swap

    def swap_weights(self, W, *, meta: dict | None = None) -> None:
        """Replace the served model in place. ``W`` must have the current
        model's shape (a shape change is a different model: build a new
        server); the served shapes, and so ``distinct_shapes``, do not move.
        ``meta`` replaces :attr:`meta` when given. While the int8 plane
        exists it is rebuilt from the new weights, so a swap while degraded
        serves the new weights' int8 image."""
        W = np.asarray(W, np.float32)
        if W.shape != self.W.shape:
            raise ValueError(
                f"hot swap must preserve the weight shape {self.W.shape} "
                f"(a new shape is a new model), got {W.shape}")
        self.W = W
        had_int8 = "int8" in self._planes
        self._planes = {"f32": self._upload(W)}
        if had_int8:
            self._planes["int8"] = self._build_int8_plane()
        self._W_dev = self._planes[self._plane]
        if meta is not None:
            self.meta = dict(meta)
        self._count("swaps")

    def maybe_reload(self) -> int | None:
        """Poll the watched root once; hot-swap if ``LATEST`` moved.

        Returns the newly installed step, or None when the pointer is
        unchanged. Any failure mid-reload counts ``reload_errors`` and keeps
        serving the current model. A step that fails ``reload_quarantine``
        times is quarantined: no more retries (counted once in
        ``quarantined``) while the pointer stays on it; the next different
        step gets a fresh chance."""
        if self._watch_root is None:
            raise RuntimeError(
                "server is not watching a checkpoint root — construct it "
                "with SvmServer.watch(root)")
        try:
            step = ckpt.read_latest(self._watch_root)
        except Exception:
            self._count("reload_errors")
            return None
        if step is None or step == self._watch_step:
            return None
        fails = self._reload_failures.get(step, 0)
        if fails >= self.reload_quarantine:
            return None
        t0 = time.monotonic()
        try:
            w, extra = snap_mod.from_checkpoint(self._watch_root, step)
            self.swap_weights(w, meta=extra)
        except Exception as e:
            self._count("reload_errors")
            self._reload_failures[step] = fails + 1
            quarantined = fails + 1 == self.reload_quarantine
            if quarantined:
                self._count("quarantined")
            self._emit_swap_span(step, time.monotonic() - t0, extra=None,
                                 error=("quarantined" if quarantined
                                        else f"{type(e).__name__}: {e}"))
            return None
        self._watch_step = step
        self._reload_failures.pop(step, None)
        self._emit_swap_span(step, time.monotonic() - t0, extra=extra)
        return step

    def _emit_swap_span(self, step: int, seconds: float, *,
                        extra: dict | None, error: str | None = None) -> None:
        """Emit the lineage ``serve.swap`` span for one reload attempt, linked
        through the manifest's ``extra["trace"]`` (re-read when the load
        failed); nothing for an untraced checkpoint. A successful swap arms
        the one-shot ``serve.first_score`` event."""
        trace = (extra or {}).get("trace")
        if trace is None:
            try:
                manifest = ckpt.read_manifest(self._watch_root, step)
                trace = (manifest.get("extra") or {}).get("trace")
            except Exception:
                return
        parent = tmtr.TraceContext.from_extra(trace)
        if parent is None:
            return
        ctx = parent.child()
        tmtr.emit_span(self.registry, "serve.swap", ctx, seconds,
                       version=step, error=error)
        if error is None:
            self._pending_first_score = (step, ctx)

    def _note_first_score(self) -> None:
        """Fire the pending ``serve.first_score`` lineage event, if armed."""
        if self._pending_first_score is None:
            return
        step, ctx = self._pending_first_score
        self._pending_first_score = None
        tmtr.emit_event(self.registry, "serve.first_score", ctx.child(),
                        version=step)

    @property
    def quarantined_steps(self) -> list[int]:
        """Checkpoint steps the watcher has given up retrying (sorted)."""
        return sorted(s for s, n in self._reload_failures.items()
                      if n >= self.reload_quarantine)

    # ------------------------------------------------- degradation ladder

    def _build_int8_plane(self) -> torch.Tensor:
        """The int8-quantize→dequantize image of the current weights, what
        an int8 export of this model would serve."""
        q, scale = snap_mod.quantize_int8(self.W)
        return self._upload(snap_mod.dequantize_int8(q, scale))

    @property
    def plane(self) -> str:
        """The weight plane being served (``"f32"`` or ``"int8"``)."""
        return self._plane

    @property
    def degraded(self) -> bool:
        """True while the server is on a degraded (non-f32) weight plane."""
        return self._plane != "f32"

    def set_plane(self, name: str) -> None:
        """Serve from the named weight plane: ``"int8"`` installs the
        quantize→dequantize image of the current weights (built the first
        time), ``"f32"`` restores full precision. The served shapes do not
        change, so ``distinct_shapes`` stays flat."""
        if name not in ("f32", "int8"):
            raise ValueError(f"unknown weight plane {name!r} "
                             "(expected 'f32' or 'int8')")
        if name == "int8" and "int8" not in self._planes:
            self._planes["int8"] = self._build_int8_plane()
        if name != self._plane:
            self._count("plane_swaps")
        self._plane = name
        self._W_dev = self._planes[name]
        self.registry.gauge("serve.degraded").set(float(self.degraded))

    # ------------------------------------------------------------- scoring

    def _class_matrix(self) -> torch.Tensor:
        return self._W_dev.reshape(self.n_classes, self.d)

    def _oracle(self, scores: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        labels = torch.argmax(scores, dim=-1).to(torch.int32)
        return hinge_ops._finish_predict(scores, labels, self.binary)

    def score(self, X) -> tuple[np.ndarray, np.ndarray]:
        """Dense batch: X (B, d) → (scores, labels) — binary ((B,), ±1 f32),
        multiclass ((B, C), int32 argmax). One kernel launch per call."""
        X = np.asarray(X, np.float32)
        B, d = X.shape
        if d != self.d:
            raise ValueError(f"query d={d} != model d={self.d}")
        self._shapes.add(("dense", B))
        Xt = self._upload(X)
        if self.use_kernels:
            scores, labels = hinge_ops.dense_predict(self._W_dev, Xt)
        else:
            scores, labels = self._oracle(hinge_ref.predict_scores_ref(self._class_matrix(), Xt))
        self._count("queries", B)
        self._count("batches")
        self._note_first_score()
        if self.use_kernels:
            hinge_ops.record_launch("dense_predict", registry=self.registry,
                                    B=B, d=d, C=self.n_classes)
        return scores.cpu().numpy(), labels.cpu().numpy()

    def score_sparse(self, cols, vals, *, n_blocks_max: int | None = None
                     ) -> tuple[np.ndarray, np.ndarray]:
        """Sparse ELL batch: (B, k) padded planes → (scores, labels).

        ``n_blocks_max`` is the map width (per-bucket through the batcher);
        defaults to the structural ``min(B·k, n_d_blocks)``. The touched-block
        map is built on the host over the actual batch and padded with
        sentinels to that width. A batch touching more blocks than the cap
        is still served correctly: the map widens to the live count rounded
        up to an 8-multiple (a bounded number of extra shapes), counted in
        ``stats()["cap_overflows"]``, the signal to re-calibrate."""
        cols = np.asarray(cols, np.int32)
        vals = np.asarray(vals, np.float32)
        B, k = cols.shape
        if k == 0:
            cols = np.zeros((B, 1), np.int32)
            vals = np.zeros((B, 1), np.float32)
            k = 1
        cap = hinge_ops.resolve_block_cap(B, k, n_d_blocks=self.n_d_blocks,
                                          n_blocks_max=n_blocks_max)
        live = len(np.unique(cols[vals != 0] // self.blk_d))
        if live > cap:
            cap = min(-(-live // 8) * 8, self.n_d_blocks)
            self._count("cap_overflows")
        bm = block_map(cols[None], vals[None], self.blk_d, self.n_d_blocks, cap)[0]
        self._shapes.add(("ell", B, k, cap))
        cols_t, vals_t = self._upload(cols), self._upload(vals)
        if self.use_kernels:
            scores, labels = hinge_ops.ell_predict(self._W_dev, cols_t, vals_t,
                                                   blk_d=self.blk_d, block_ids=self._upload(bm))
        else:
            scores, labels = self._oracle(
                hinge_ref.ell_predict_scores_ref(self._class_matrix(), cols_t, vals_t))
        self._count("queries", B)
        self._count("batches")
        self._count("sparse_batches")
        self._note_first_score()
        self._count("blocks_visited", live)
        self._count("dense_block_equivalent", self.n_d_blocks)
        if self.use_kernels:
            hinge_ops.record_launch("ell_predict", registry=self.registry,
                                    blocks_visited=live, B=B, k=k,
                                    C=self.n_classes, blk_d=self.blk_d,
                                    n_blocks_max=cap)
        return scores.cpu().numpy(), labels.cpu().numpy()

    def scorer_for(self, bucket: Bucket | None = None):
        """The ``score_fn(bucket, cols, vals)`` a batcher drains with: each
        batch is scored with its own bucket's ``n_blocks_max``, or with
        ``bucket``'s when one is given."""
        def score_fn(b: Bucket, cols, vals):
            cap = (bucket or b).n_blocks_max
            return self.score_sparse(cols, vals, n_blocks_max=cap)
        return score_fn

    # --------------------------------------------------------------- stats

    def stats(self) -> dict:
        """Serving counters: queries / batches served, ``distinct_shapes``
        (the number of shapes served), ``swaps`` / ``reload_errors`` /
        ``quarantined`` from the watch path, the sparse blocks-visited
        accounting against a dense sweep, and the weight plane's state
        (``degraded`` 0/1, ``plane``, ``plane_swaps``). A view over
        :attr:`registry`'s ``serve.*`` counters."""
        s = {k: int(self.registry.value(f"serve.{k}")) for k in _STAT_KEYS}
        s["distinct_shapes"] = len(self._shapes)
        s["blocks_visited_ratio"] = (
            s["blocks_visited"] / s["dense_block_equivalent"]
            if s["dense_block_equivalent"] else float("nan"))
        s["degraded"] = int(self.degraded)
        s["plane"] = self._plane
        return s


def make_mesh_scorer(W, *, mesh=None, use_kernels: bool | None = None,
                     device: torch.device | str | None = None):
    """Batch-parallel serving over a mesh of processes: W replicated on every
    rank, the queries split across the ranks.

    Returns ``scorer(X) -> (scores, labels)``. Every rank passes the same
    global (B, d) batch; rank r scores rows [r·B/n, (r+1)·B/n) through
    ``ops.dense_predict`` (the ``dense_scores`` kernel on CUDA, one launch;
    ``use_kernels=False`` the plain scores and argmax) and the slices are
    all-gathered, so every rank returns the whole batch's result, as the
    reference's sharded scorer. W: (d,) binary or (C, d) classes. B must
    divide by the mesh's size (pad with zero rows; they score 0). ``mesh``:
    by default the world as one axis ``"batch"``; ``device``: CUDA unless
    given."""
    dev = resolve_device(device)
    if mesh is None:
        mesh = Mesh({"batch": dist.get_world_size()})
    W_dev = (W if isinstance(W, torch.Tensor) else torch.from_numpy(np.asarray(W, np.float32))
             ).to(device=dev, dtype=torch.float32).contiguous()
    use_kernels = use_kernels is None or bool(use_kernels)
    binary = W_dev.ndim == 1
    n = mesh.world

    def scorer(X):
        X = torch.as_tensor(X).to(device=dev, dtype=torch.float32)
        B = X.shape[0]
        if B % n:
            raise ValueError(f"batch of {B} rows does not split over {n} ranks; pad it "
                             "with zero rows")
        rows = B // n
        Xl = X[mesh.rank * rows:(mesh.rank + 1) * rows].contiguous()
        if use_kernels:
            scores, labels = hinge_ops.dense_predict(W_dev, Xl)
        else:
            S = hinge_ref.predict_scores_ref(W_dev[None] if binary else W_dev, Xl)
            scores, labels = hinge_ops._finish_predict(
                S, torch.argmax(S, dim=-1).to(torch.int32), binary)
        return (torch.cat(mesh.all_gather(scores.contiguous())),
                torch.cat(mesh.all_gather(labels.contiguous())))

    return scorer
