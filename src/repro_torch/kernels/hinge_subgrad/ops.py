"""Dispatch layer over the kernels: the Pegasos half-step for one node or
for the whole fleet, dense or over padded-ELL planes, the Pegasos step with
its loss, fused serving scores over dense or padded-ELL query batches, and
the launch accounting on a telemetry registry (``launch_cost``,
``record_launch``). Port of ``repro.kernels.hinge_subgrad.ops``.

The step scalars ``α = 1/(λt)``, ``λα`` and ``α/B`` are formed in float32 as
the reference forms them; the violator coefficients, the touched-block map
and the ball projection are plain PyTorch around the kernels, as they are
jnp in the reference (both sparse schedules' coefficients are part of their
kernels here, and the prefetch schedule's map and fold into W too:
``sparse.ell_grad_update_fused``; serving keeps the map). The kernels stream their
inputs from device memory and have no tile limit, so unlike the reference
there is no padding to (8, 128) blocks, no 128-lane class padding, no zero
landing block after W, and no VMEM cut-over from the fused fleet kernel to
the two-kernel path. ``resolve_ell_schedule`` keeps the
reference's arithmetic all the same, so the port picks the same sparse
kernel pair and ``blk_d`` as the reference at every shape.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.svm_objective import project_ball
from repro_torch.kernels.hinge_subgrad import hinge_subgrad as K
from repro_torch.kernels.hinge_subgrad import predict as P
from repro_torch.kernels.hinge_subgrad import sparse as S
from repro_torch.kernels.hinge_subgrad.sparse import ell_block_map
from repro_torch.sparse.formats import DEFAULT_BUCKET_BLK_D
from repro_torch.telemetry import registry as tmr

__all__ = ["step_scalars", "padded_row_mask", "local_half_step", "fleet_half_step",
           "unfused_fleet_half_step", "ell_fleet_half_step", "ell_block_map",
           "resolve_ell_schedule", "pegasos_step", "dense_predict", "ell_predict",
           "resolve_block_cap", "launch_cost", "record_launch", "DEFAULT_BLK_D_SPARSE",
           "ELL_ONEHOT_BUDGET", "ELL_PREFETCH_BLK_D", "HALF_STEP_KINDS"]

# The reference's sweep block width and its per-program one-hot budget: they
# no longer shape a kernel here, but they decide, through
# resolve_ell_schedule, which kernel pair runs and at which blk_d.
DEFAULT_BLK_D_SPARSE = 512
ELL_ONEHOT_BUDGET = 4 * 1024 * 1024
# block width of the touched-block (prefetch) schedule, the formats' bucket width
ELL_PREFETCH_BLK_D = DEFAULT_BUCKET_BLK_D
# The kinds (``launch_cost``'s) a call of each half-step route launches: the
# dispatch below follows it, the trainer accounts by it. Above MAX_FLEET_B the
# fused route's ``fleet_half_step`` cost counts its margins + grad_update.
HALF_STEP_KINDS = {"fused": ("fleet_half_step",), "unfused": ("margins", "grad_update"),
                   "prefetch": ("ell_grad_update_fused",),
                   "sweep": ("ell_margins_coeff", "ell_grad_update")}


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
    y: (m, B); ``row_mask`` (B,) float, all rows valid when omitted.

    Above ``hinge_subgrad.MAX_FLEET_B`` rows (the fused kernel's cap, read
    at each call), on every device, it is
    :func:`unfused_fleet_half_step` (a masked row gets y = 0, so its
    coefficient is 0 as the fused kernel's mask makes it)."""
    B = X.shape[1]
    if B > K.MAX_FLEET_B:
        y_masked = y if row_mask is None else y * row_mask
        return unfused_fleet_half_step(W, X, y_masked, lam=lam, t=t, project=project)
    if row_mask is None:
        row_mask = torch.ones((B,), dtype=torch.float32, device=X.device)
    W_half = K.fleet_half_step(X, W, y, row_mask, step_scalars(lam, t, B))
    return project_ball(W_half, lam) if project else W_half


def unfused_fleet_half_step(W: torch.Tensor, X: torch.Tensor, y: torch.Tensor, *,
                            lam: float, t: int, project: bool = True) -> torch.Tensor:
    """GADGET steps (e)+(f) for all m nodes as the reference's vmapped
    ``local_half_step``: one ``margins`` launch for the fleet, the violator
    coefficients, one ``grad_update`` launch for the fleet, then the
    optional per-row ball projection. W: (m, d), X: (m, B, d), y: (m, B)."""
    B = X.shape[1]
    coeff = torch.where(K.margins(X, W, y) < 1.0, y, torch.zeros_like(y))
    W_half = K.grad_update(X, W, coeff, step_scalars(lam, t, B))
    return project_ball(W_half, lam) if project else W_half


def _ell_blk_d(d_pad: int, Bk: int) -> int:
    blk = min(DEFAULT_BLK_D_SPARSE, d_pad)
    while blk > 128 and Bk * blk * 4 > ELL_ONEHOT_BUDGET:
        blk = max(128, blk // 2 // 128 * 128)
    return blk


def resolve_ell_schedule(schedule: str, *, B: int, k: int, d: int,
                         n_blocks_max: int | None = None,
                         blk_d: int | None = None) -> tuple[str, int, int]:
    """Pin an ELL schedule request to concrete ``(schedule, blk_d, n_blocks_max)``,
    by the reference's arithmetic (its (8, 128) padding of B and k included).

    ``schedule``: "sweep", "prefetch" or "auto". Auto picks prefetch exactly
    when its worst-case w-lane footprint ``n_blocks_max · ELL_PREFETCH_BLK_D``
    is below the sweep's padded width, which needs a data-derived
    ``n_blocks_max`` (``formats.minibatch_block_bound``) to ever fire: the
    fallback cap ``min(B·k, n_d_blocks)`` carries no information.
    n_blocks_max is clamped to that structural cap either way.
    """
    if schedule not in ("auto", "prefetch", "sweep"):
        raise ValueError(f"unknown ELL schedule {schedule!r}")
    kp = -(-max(k, 1) // 128) * 128
    Bp = -(-B // 8) * 8
    sweep_blk = _ell_blk_d(-(-d // 128) * 128, Bp * kp)
    if schedule == "sweep":
        return "sweep", (blk_d or sweep_blk), 0
    pref_blk = blk_d or ELL_PREFETCH_BLK_D
    n_d_blocks = -(-d // pref_blk)
    cap = max(1, min(n_blocks_max or B * max(k, 1), B * max(k, 1), n_d_blocks))
    if schedule == "prefetch":
        return "prefetch", pref_blk, cap
    sweep_lanes = (-(-d // sweep_blk)) * sweep_blk
    if cap * pref_blk < sweep_lanes:
        return "prefetch", pref_blk, cap
    return "sweep", sweep_blk, 0


def ell_fleet_half_step(W: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
                        y: torch.Tensor, *, lam: float, t: int, project: bool = True,
                        schedule: str = "auto", n_blocks_max: int | None = None,
                        blk_d: int | None = None) -> torch.Tensor:
    """Sparse GADGET steps (a)-(e) for the whole fleet over ELL planes, then
    the optional per-row ball projection.

    W: (m, d); cols/vals: (m, B, k) gathered minibatch planes (int32 and
    float32; pad entries (0, 0), pad rows y=0); y: (m, B). By schedule (see
    :func:`resolve_ell_schedule`):

    * ``"sweep"``: ``ell_margins_coeff``, which writes the violator
      coefficients beside the margins, then ``ell_grad_update``, which
      writes the decayed and updated W itself.
    * ``"prefetch"``: ``ell_grad_update_fused``, which builds the
      touched-block map (the static ``n_blocks_max`` from
      ``formats.minibatch_block_bound``), the margins and violator
      coefficients, and the fold into the decayed W itself: the same bits
      as :func:`ell_block_map`, ``ell_margins_prefetch_coeff`` and
      ``ell_grad_update_prefetch_fold`` in turn.
    * ``"auto"``: prefetch exactly when it is cheaper in w-lanes.

    k = 0 planes are widened to one inert (0, 0) entry per row.
    """
    m, B, k = cols.shape
    d = W.shape[1]
    if k == 0:
        cols = torch.zeros((m, B, 1), dtype=torch.int32, device=cols.device)
        vals = torch.zeros((m, B, 1), dtype=torch.float32, device=vals.device)
        k = 1
    schedule, blk_d, n_blocks_max = resolve_ell_schedule(
        schedule, B=B, k=k, d=d, n_blocks_max=n_blocks_max, blk_d=blk_d)
    s0, s1 = step_scalars(lam, t, B)
    if schedule == "prefetch":
        W_half = S.ell_grad_update_fused(cols, vals, W, y, (s0, s1), blk_d=blk_d,
                                         n_d_blocks=-(-d // blk_d), n_blocks_max=n_blocks_max)
    else:
        # pad rows carry y=0, so their coefficient is 0 although margin 0 < 1
        _, coeff = S.ell_margins_coeff(cols, vals, W, y)
        W_half = S.ell_grad_update(cols, vals, W, coeff, (s0, s1), blk_d=blk_d)
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


def _as_class_matrix(W: torch.Tensor) -> tuple[torch.Tensor, bool]:
    if W.ndim not in (1, 2):
        raise ValueError(f"W must be (d,) or (C, d), got shape {tuple(W.shape)}")
    return (W.reshape(1, -1), True) if W.ndim == 1 else (W, False)


def _finish_predict(scores: torch.Tensor, labels: torch.Tensor,
                    binary: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """Binary → ((B,) margins, (B,) float32 labels in {−1, +1}, +1 at margin
    0); multiclass → the kernel's ((B, C) scores, (B,) int32 labels)."""
    if binary:
        s = scores[:, 0]
        return s, torch.where(s >= 0.0, 1.0, -1.0).to(torch.float32)
    return scores, labels


def resolve_block_cap(B: int, k: int, *, n_d_blocks: int,
                      n_blocks_max: int | None = None) -> int:
    """The one statement of the touched-block map width: the requested cap
    (or the no-information ``B·k``) clamped to the structural limits. The
    serving engine's shape key and host-side map width must agree with
    ``ell_predict``'s internal computation — both call this."""
    return max(1, min(n_blocks_max or B * k, B * k, n_d_blocks))


def dense_predict(W: torch.Tensor, X: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused serving scores and argmax in one ``dense_scores`` launch.

    W: (d,) binary weights or (C, d) one-vs-rest class matrix; X: (B, d).
    Binary → ((B,) margins, (B,) float32 labels in {−1, +1}, +1 at margin 0);
    multiclass → ((B, C) scores, (B,) int32 first-occurrence argmax).
    """
    W2, binary = _as_class_matrix(W)
    scores, labels = P.dense_scores(X, W2, n_classes=W2.shape[0])
    return _finish_predict(scores, labels, binary)


def ell_predict(W: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor, *,
                n_blocks_max: int | None = None, blk_d: int | None = None,
                block_ids: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Sparse serving scores and argmax over one padded-ELL query batch, in
    one ``ell_scores_prefetch`` launch.

    W: (d,) or (C, d); cols/vals: (B, k) int32 / float32 query planes (pad
    entries (0, 0) and all-pad rows inert: a pad row scores 0 for every
    class and labels +1 / class 0). ``block_ids`` (n_blocks_max,) int32 is a
    host-computed map (``formats.block_map`` with m = 1, the serving
    engine's path); by default the map is built on the planes' device
    (:func:`ell_block_map`) at the width :func:`resolve_block_cap` gives
    ``n_blocks_max``. Only entries whose d-block is in the map count. A
    batch with k = 0 is widened to one inert entry per row. Returns
    ``(scores, labels)`` shaped and typed as :func:`dense_predict`'s.
    """
    W2, binary = _as_class_matrix(W)
    C, d = W2.shape
    B, k = cols.shape
    if k == 0:  # an all-empty batch: widen to one inert entry (shapes nonzero)
        cols = torch.zeros((B, 1), dtype=torch.int32, device=cols.device)
        vals = torch.zeros((B, 1), dtype=torch.float32, device=vals.device)
        k = 1
    blk_d = blk_d or ELL_PREFETCH_BLK_D
    n_d_blocks = -(-d // blk_d)
    if block_ids is None:
        cap = resolve_block_cap(B, k, n_d_blocks=n_d_blocks, n_blocks_max=n_blocks_max)
        block_ids = ell_block_map(cols[None], vals[None], blk_d=blk_d, n_d_blocks=n_d_blocks,
                                  n_blocks_max=cap)[0]
    scores, labels = P.ell_scores_prefetch(cols, vals, W2, block_ids, blk_d=blk_d,
                                           n_d_blocks=n_d_blocks, n_classes=C)
    return _finish_predict(scores, labels, binary)


def launch_cost(kind: str, *, m: int = 1, B: int = 0, d: int = 0, C: int = 1,
                k: int = 0, n_blocks_max: int = 0, blk_d: int = 0) -> dict:
    """Per-call cost of one kernel entry point, from shapes alone.

    Returns ``{"launches", "bytes", "flops"}``. Bytes count each input
    element the function needs read from device memory once and each output
    written once (float32 and int32 both 4 bytes), whatever a kernel reads
    again from cache; flops count a multiply-add as 2. This is the byte
    model behind the kernels' bandwidth bounds. Kinds: ``margins`` and
    ``grad_update`` (each over m nodes), ``local_half_step`` (the two
    launches of the unfused node step), ``fleet_half_step`` (one launch up to
    ``hinge_subgrad.MAX_FLEET_B`` rows), ``dense_predict``, ``ell_predict`` (a (B, k) query batch: the
    planes, the ``B·k·C`` gathered weights, the (n_blocks_max,) map and the
    outputs; ``blocks_visited`` is the map's width), and the sparse
    kernels over (m, B, k) planes:
    ``ell_margins`` and ``ell_margins_prefetch`` (a gather reads the
    ``m·B·k`` entries of W it needs, not all of W), ``ell_margins_coeff``
    and ``ell_margins_prefetch_coeff`` (as their margins entries, and the
    ``m·B`` coefficients written), ``ell_grad_update``
    (all of W read and W_half written), ``ell_grad_update_prefetch``
    (the buckets G, ``m·n_blocks_max·blk_d``, written) and
    ``ell_grad_update_prefetch_fold`` (the entries and the map read, all of
    W read and W_half written) and ``ell_grad_update_fused`` (the entries
    and the labels read, all of W read and W_half written: no map, margins
    or coefficients leave the kernel; the margins' and the fold's
    operations). ``fleet_half_step`` above
    ``hinge_subgrad.MAX_FLEET_B`` rows is its two-launch route: ``margins``
    plus ``grad_update``.
    """
    entries = m * B * k
    if kind in ("ell_margins", "ell_margins_coeff", "ell_margins_prefetch",
                "ell_margins_prefetch_coeff"):
        map_elems = m * n_blocks_max if "prefetch" in kind else 0
        outputs = m * B if kind.endswith("_coeff") else 0
        return {"launches": 1, "bytes": 4 * (3 * entries + 2 * m * B + map_elems + outputs),
                "flops": 2 * entries + m * B}
    if kind == "ell_grad_update":
        return {"launches": 1, "bytes": 4 * (2 * entries + m * B + 2 * m * d),
                "flops": 2 * entries + 3 * m * d}
    if kind == "ell_grad_update_prefetch":
        return {"launches": 1,
                "bytes": 4 * (2 * entries + m * B + m * n_blocks_max * (1 + blk_d)),
                "flops": 2 * entries}
    if kind == "ell_grad_update_prefetch_fold":
        return {"launches": 1,
                "bytes": 4 * (2 * entries + m * B + m * n_blocks_max + 2 * m * d),
                "flops": 2 * entries + 3 * m * d}
    if kind == "ell_grad_update_fused":
        return {"launches": 1, "bytes": 4 * (2 * entries + m * B + 2 * m * d),
                "flops": 4 * entries + m * B + 3 * m * d}
    if kind == "margins":
        return {"launches": 1, "bytes": 4 * m * (B * d + d + 2 * B),
                "flops": m * (2 * B * d + B)}
    if kind == "grad_update":
        return {"launches": 1, "bytes": 4 * m * (B * d + 2 * d + B),
                "flops": m * (2 * B * d + 3 * d)}
    if kind == "local_half_step":
        a, b = launch_cost("margins", B=B, d=d), launch_cost("grad_update", B=B, d=d)
        return {key: a[key] + b[key] for key in a}
    if kind == "fleet_half_step" and B > K.MAX_FLEET_B:
        a, b = launch_cost("margins", m=m, B=B, d=d), launch_cost("grad_update", m=m, B=B, d=d)
        return {key: a[key] + b[key] for key in a}
    if kind == "fleet_half_step":
        return {"launches": 1, "bytes": 4 * (m * B * d + 2 * m * d + m * B + B),
                "flops": m * (4 * B * d + B + 3 * d)}
    if kind == "dense_predict":
        return {"launches": 1, "bytes": 4 * (B * d + C * d + B * C + B),
                "flops": 2 * B * C * d}
    if kind == "ell_predict":
        return {"launches": 1,
                "bytes": 4 * (2 * B * k + B * k * C + n_blocks_max + B * C + B),
                "flops": 2 * B * k * C, "blocks_visited": n_blocks_max}
    raise ValueError(f"unknown kernel kind {kind!r}")


def record_launch(kind: str, n: int = 1, *, registry=None,
                  blocks_visited: float | None = None, **shape) -> dict:
    """Account ``n`` executions of a kernel entry point on the registry.

    Increments ``kernel.launches`` / ``kernel.bytes`` / ``kernel.flops``
    (and ``kernel.blocks_visited`` for block-scheduled kinds — pass
    ``blocks_visited`` to override the static cap with a measured live
    count), all labeled ``kernel=<kind>``, using :func:`launch_cost` for the
    per-call numbers. Host-side bookkeeping only; returns the per-call cost
    dict. Callers account at their boundary (the serving engine per score
    call)."""
    reg = tmr.default_registry() if registry is None else registry
    cost = launch_cost(kind, **shape)
    reg.counter("kernel.launches", kernel=kind).inc(n * cost["launches"])
    reg.counter("kernel.bytes", kernel=kind).inc(n * cost["bytes"])
    reg.counter("kernel.flops", kernel=kind).inc(n * cost["flops"])
    bv = cost.get("blocks_visited") if blocks_visited is None else blocks_visited
    if bv is not None:
        reg.counter("kernel.blocks_visited", kernel=kind).inc(n * bv)
    return cost
