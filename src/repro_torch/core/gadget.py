"""GADGET SVM — Gossip-bAseD sub-GradiEnT solver (paper Algorithm 2).

Port of ``repro.core.gadget.gadget_train`` and ``gadget_train_stream`` for
dense (m, n_i, d) partitions and for padded-ELL partitions
(``EllPartitions``). Every node i holds a horizontal partition and a weight
vector ŵ_i; one iteration t:

  (a-c)  sample a local minibatch, L̂_i = mean_{violators} y·x under ŵ_i
  (d)    α_t = 1/(λt)
  (e)    w̃_i = (1 − λα_t)ŵ_i + α_t L̂_i
  (f)    [optional] project w̃_i onto the 1/√λ ball
  (g)    ŵ_i ← PushSum(B, w̃_i)
  (h)    [optional] project again

With ``cfg.fused`` (the default) steps (a)-(e) for all m nodes are one
``fleet_half_step`` launch (two, ``margins`` and ``grad_update``, above the
kernel's minibatch cap) and the R Push-Sum rounds are one collapsed (m, m)
product; ``fused=False`` runs ``margins`` and ``grad_update``, each one
launch for the fleet (the reference vmaps them over the nodes), and the R
rounds in order. On ELL partitions steps (a)-(e) are always fleet-wide
(``ops.ell_fleet_half_step``: per ``cfg.sparse_schedule`` the sweep's two
launches or the touched-block schedule's one), and ``fused`` selects only
the mixing. A run picks its format and half-step route once, at its start
(``_partitions``); ``ops.HALF_STEP_KINDS`` names each route's kernels.
Push-Sum pushes n_i·w̃_i with mass n_i, so the consensus is the
data-weighted mean Σ n_i ŵ_i / N, also under non-uniform ``n_counts``.

``cfg.faults`` (a :class:`~repro_torch.core.faults.FaultPlan`) fails links
and crashes nodes: each iteration's clean (R, m, m) rounds pass through
``faults.apply_faults`` under the iteration's failure masks, and are then
collapsed (fused) or mixed in order. A deterministic topology under faults
therefore walks its round cycle, not its product cycle, and dead rows are
frozen after the renormalising divide. An inert plan is no plan.

The loop is eager PyTorch. Each chunk of iterations (``cfg.check_every``
in :func:`gadget_train`, ``segment_iters`` in :func:`gadget_train_stream`)
draws its randomness at once, runs its iterations, and syncs the host once
for the ε, objective, mass and non-finite readings. The anytime export
(``snapshot_every``) and the telemetry ring (``telemetry=``) write device
tensors at iterations the host knows, so they add no sync inside a chunk;
they are read back when the run ends. The reference runs the same loop as
one jitted ``lax.while_loop``.

:func:`gadget_train_reference` keeps the reference's host-loop oracle: the
same draws, always unfused, a deterministic topology's matrices uploaded
every iteration and two blocking syncs an ε-check. ``transfer_stats``
counts what each loop really does (matrix uploads, host syncs).
:func:`make_gadget_mesh_step` runs one node a process on a
:class:`~repro_torch.core.mesh.Mesh`: the local half-step, then Push-Sum
rounds as point-to-point exchanges.

Randomness comes from a draw source (:class:`GeneratorDraws` by default,
:class:`RecordedDraws` to replay given draws). The port's own draws are
the reference's ``jax.random`` streams, reproduced bit for bit by a
Threefry-2x32 in int64 tensor ops (``core.counter_rng``) and keyed on the
global iteration as the reference keys them, so the draws of iteration t
do not depend on how the run is chunked, streamed or resumed, nor on the
device.
"""
from __future__ import annotations

import functools
import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import faults as flt
from repro_torch.core import svm_objective as obj
from repro_torch.core import topology as topo
from repro_torch.core import counter_rng as crng
from repro_torch.core.faults import FaultPlan
from repro_torch.core.mesh import Mesh
from repro_torch.core.push_sum import (PushSumState, collapse_rounds, exponential_schedule,
                                       mix_collapsed, mix_rounds, push_sum_round)
from repro_torch.kernels.hinge_subgrad import ops
from repro_torch.kernels.hinge_subgrad import ref as hinge_ref
from repro_torch.sparse.formats import minibatch_block_bound
from repro_torch.telemetry import registry as tmr
from repro_torch.telemetry import trace as tmtr
from repro_torch.telemetry import train as tmt
from repro_torch.telemetry.ranges import region

__all__ = ["GadgetConfig", "GadgetResult", "NonFiniteWeightsError", "SegmentResult",
           "SnapshotRing", "TrainState", "DrawPlan", "GeneratorDraws", "RecordedDraws",
           "gadget_train", "gadget_train_stream", "gadget_train_reference",
           "make_gadget_mesh_step", "transfer_stats", "reset_transfer_stats",
           "DEFAULT_SNAPSHOT_SLOTS"]

# default capacity of the anytime-export ring, as the reference's
DEFAULT_SNAPSHOT_SLOTS = 8

# Host-device traffic of the training loops: ``matrix_uploads`` counts
# host-to-device copies of mixing matrices, ``host_syncs`` the blocking
# device-to-host reads of the ε-check and the traces. gadget_train uploads a
# deterministic topology's cycle once and syncs once per ε-chunk (the stream
# once per segment); gadget_train_reference uploads every iteration and
# syncs twice per ε-check, as the reference's host loop.
transfer_stats = {"matrix_uploads": 0, "host_syncs": 0}


def reset_transfer_stats() -> None:
    transfer_stats["matrix_uploads"] = 0
    transfer_stats["host_syncs"] = 0


class NonFiniteWeightsError(FloatingPointError):
    """The consensus weight plane went non-finite during training.

    Raised by :func:`gadget_train` and :func:`gadget_train_stream` when the
    guard, checked at the chunk cadence, finds NaN/Inf in the consensus
    weights, and by ``TrainPublisher`` when asked to publish such a plane.
    ``iteration`` is the last completed iteration when the guard fired;
    ``context`` names the stage that refused. Each raise from training
    increments the ``train.nonfinite`` counter on the default registry.
    """

    def __init__(self, iteration: int, context: str = "training"):
        super().__init__(
            f"non-finite consensus weight plane at iteration {iteration} "
            f"({context}) — training diverged; refusing to treat NaN/Inf "
            f"weights as a servable model")
        self.iteration = int(iteration)
        self.context = context


class GadgetConfig(NamedTuple):
    """Hyperparameters of one GADGET run, with the reference's names and
    defaults. ``sparse_schedule`` ("auto", "prefetch" or "sweep") picks the
    sparse kernel pair on ELL partitions and is ignored on dense ones.
    ``faults``: a :class:`~repro_torch.core.faults.FaultPlan` or None."""

    lam: float = 1e-4            # λ — SVM regularization
    batch_size: int = 1          # local examples per sub-gradient estimate
    gossip_rounds: int = 4       # Push-Sum rounds per iteration (R)
    topology: str = "exponential"
    project_before_gossip: bool = True   # paper step (f)
    project_after_gossip: bool = True    # paper step (h)
    epsilon: float = 1e-3        # anytime stopping tolerance
    check_every: int = 100       # ε-check / trace cadence
    max_iters: int = 5000
    seed: int = 0                # seeds the default GeneratorDraws
    fused: bool = True           # one fleet launch + one collapsed mix
    sparse_schedule: str = "auto"  # ELL kernel pair: auto | prefetch | sweep
    faults: FaultPlan | None = None


class SnapshotRing(NamedTuple):
    """Anytime-export ring: the last ``slots`` consensus snapshots taken
    every ``every`` iterations, plus the final iterate, read back to the host
    when the run ends. Snapshot j (1-based, at iteration j·every) lives in
    slot ``(j − 1) % slots``; ``count`` is the number taken (> slots: the
    ring wrapped). ``repro_torch.serve.snapshot.snapshots_from`` decodes it."""

    every: int
    W: np.ndarray             # (slots, d) consensus weights per snapshot
    iterations: np.ndarray    # (slots,) int32 iteration index (0 = never used)
    objectives: np.ndarray    # (slots,) primal objective of each snapshot
    count: int                # snapshots taken in total (may exceed slots)
    final_w: np.ndarray       # (d,) consensus at termination
    final_iteration: int
    final_objective: float

    @property
    def slots(self) -> int:
        return self.W.shape[0]


class GadgetResult(NamedTuple):
    """What :func:`gadget_train` returns; fields as in the reference, for
    dense and ELL partitions alike."""

    W: torch.Tensor              # (m, d) final per-node weights
    w_consensus: torch.Tensor    # (d,) data-weighted network average
    iters: int
    epsilon: float               # max_i ‖Δŵ_i‖ over the last ε-check chunk
    objective_trace: np.ndarray  # (n_checks,) primal objective of the consensus
    time_trace: np.ndarray       # (n_checks,) iteration index per check
    eps_trace: np.ndarray        # (n_checks,) max_i ‖Δŵ_i‖ per check
    W_avg: torch.Tensor | None = None  # (m, d) per-node iterate averages
    snapshots: SnapshotRing | None = None  # anytime export (snapshot_every=K)
    # (n_checks,) minimum per-iteration Push-Sum mass retention per chunk:
    # 1 (to float rounding) on a perfect network and under link-mode faults,
    # < 1 under message-mode leakage
    mass_trace: np.ndarray | None = None
    telemetry: tmt.TrainTrace | None = None  # decoded trace ring (telemetry=...)


class SegmentResult(NamedTuple):
    """One :func:`gadget_train_stream` segment: what a live publisher needs
    to export a servable model mid-training. ``W`` and ``W_sum`` stay on the
    run's device; ``w_consensus`` is the host (d,) float32 consensus."""

    iteration: int           # global iterations completed
    W: torch.Tensor          # (m, d) per-node weights after the segment
    w_consensus: np.ndarray  # (d,) float32 consensus at the segment boundary
    objective: float         # primal objective of w_consensus
    epsilon: float           # max_i ‖Δŵ_i‖ across the segment
    done: bool               # ε-converged or cfg.max_iters reached
    W_sum: torch.Tensor | None = None  # (m, d) running iterate sum (resumable state)
    mass: float = float("nan")  # least per-iteration Push-Sum mass in the segment
    telemetry: tmt.SegmentTelemetry | None = None
    trace: tmtr.TraceContext | None = None  # the segment's lineage root (trace=True)


class TrainState(NamedTuple):
    """Resumable trainer state at a segment boundary: ``iteration`` completed
    global iterations, the (m, d) per-node weights and their running sum.
    ``gadget_train_stream(..., resume=...)`` continues from it; because
    every draw is keyed on the global iteration, the resumed trajectory is
    the uninterrupted one bit for bit. ``W`` and ``W_sum`` may be tensors or
    numpy arrays (``serve.snapshot.train_state_from_checkpoint`` gives
    numpy)."""

    iteration: int
    W: torch.Tensor
    W_sum: torch.Tensor


class DrawPlan(NamedTuple):
    """What a draw source must produce for one run. With ``faults`` the
    mixing comes as (R, m, m) clean rounds even when fused, and the source
    also gives failure masks (``fails``)."""

    m: int
    batch_size: int
    rounds: int
    topology: str
    fused: bool
    counts: torch.Tensor         # (m,) int64 valid rows per node, on the run's device
    faults: FaultPlan | None = None


def _arange(n: int, device: torch.device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int64, device=device)


class GeneratorDraws:
    """The port's own draws: the reference's ``jax.random`` draws bit for
    bit (``core.counter_rng``), each keyed on the global iteration, so
    iteration t's draws are the same in any chunking and on any device.
    From ``data_key, mix_key = split(PRNGKey(seed))``:

    * minibatch ids ``randint(split(fold_in(data_key, t), m)[i], (B,), 0,
      counts[i])`` (the reference's ``_batch_ids``);
    * the random topology's targets ``randint(fold_in(fold_in(mix_key, t),
      r), (m,), 0, m − 1)``, shifted past i
      (``topology.random_neighbor_matrix_device``), R one-neighbour rounds
      an iteration, folded into one product when fused and fault-free;
    * failure masks as ``faults.keyed_fail_masks``.

    Deterministic topologies draw no mixing (the trainer indexes the
    uploaded cycle).
    """

    def __init__(self, seed: int):
        self.seed = int(seed)
        key = crng.prng_key(self.seed)
        self._keys = (crng.fold_in(key, 0), crng.fold_in(key, 1))  # data_key, mix_key
        self._on: dict[torch.device, tuple] = {}

    def take(self, t0: int, n: int, plan: DrawPlan):
        """Draws of iterations t0 … t0+n−1: ids (n, m, B) int64 and the mixing
        (n, m, m) fused and fault-free, (n, R, m, m) rounds otherwise, or None.

        Both streams go through each Threefry pass together (fold in t,
        fold in the node or round, split, bits): four passes a chunk."""
        device = plan.counts.device
        m, B, R = plan.m, plan.batch_size, plan.rounds
        if device not in self._on:  # the streams' keys, uploaded once
            self._on[device] = tuple(torch.tensor(words, dtype=torch.int64, device=device)[:, None]
                                     for words in zip(*self._keys))
        streams = 2 if plan.topology == "random" else 1
        # key of (stream, t): (streams, n)
        k1, k2 = crng.fold_in(tuple(k[:streams] for k in self._on[device]),
                              _arange(n, device)[None, :] + t0)
        # key of (t, node) for the ids and of (t, round) for the mixing, flat;
        # each draws B ids or m targets
        inner = ((m, B), (R, m))[:streams]
        key = crng.fold_in(
            tuple(torch.cat([k[s][:, None].expand(n, size).reshape(-1).repeat_interleave(draws)
                             for s, (size, draws) in enumerate(inner)]) for k in (k1, k2)),
            torch.cat([_arange(size, device).repeat(n).repeat_interleave(draws)
                       for size, draws in inner]))
        index = torch.cat([_arange(draws, device).repeat(n * size) for size, draws in inner])
        span = plan.counts[None, :, None].expand(n, m, B).reshape(-1)
        if streams == 2:
            span = torch.cat([span, torch.full((n * R * m,), m - 1, dtype=torch.int64,
                                               device=device)])
        flat = crng.randint(key, index, span)
        ids = flat[:n * m * B].view(n, m, B)
        if streams == 1:
            return ids, None
        targets = flat[n * m * B:].view(n, R, m)
        Bs = topo.random_neighbor_matrix_device(m, targets=targets)
        if not plan.fused or plan.faults is not None:
            return ids, Bs
        with region("gadget.collapse"):
            return ids, collapse_rounds(Bs)

    def fails(self, t0: int, n: int, plan: DrawPlan) -> torch.Tensor:
        """Failure masks of iterations t0 … t0+n−1, (n, R, m, m) bool."""
        return flt.keyed_fail_masks(plan.faults, t0, n, plan.rounds, plan.m,
                                    plan.counts.device)


class RecordedDraws:
    """Replays given draws: ``ids`` (T, m, B) minibatch row ids and ``mix``,
    either (T, R, m, m) round stacks (collapsed here for a fused run) or,
    for a fused fault-free run, (T, m, m) collapsed products, or None for a
    deterministic topology's own cycle. With ``fails`` (T, R, m, m) bool
    failure masks (faulted runs) ``mix`` holds clean rounds. Row t−1 holds
    iteration t's draws."""

    def __init__(self, ids, mix=None, fails=None):
        self.ids = torch.as_tensor(np.array(ids), dtype=torch.int64)
        self.mix = None if mix is None else torch.as_tensor(np.array(mix),
                                                            dtype=torch.float32)
        self.fail = None if fails is None else torch.as_tensor(np.array(fails),
                                                               dtype=torch.bool)
        self._on: dict[torch.device, tuple] = {}

    def _device(self, device: torch.device) -> tuple:
        if device not in self._on:
            self._on[device] = tuple(None if a is None else a.to(device)
                                     for a in (self.ids, self.mix, self.fail))
        return self._on[device]

    def take(self, t0: int, n: int, plan: DrawPlan):
        """The recorded draws of iterations t0 … t0+n−1 on the run's device."""
        m, B, R = plan.m, plan.batch_size, plan.rounds
        T = self.ids.shape[0]
        if self.ids.shape[1:] != (m, B) or t0 - 1 + n > T:
            raise ValueError(f"recorded ids {tuple(self.ids.shape)} do not cover "
                             f"iterations {t0}..{t0 + n - 1} of a ({m}, {B}) run")
        rounds_only = plan.faults is not None or self.fail is not None or not plan.fused
        if self.mix is None:
            if plan.topology == "random":
                raise ValueError("the random topology needs recorded mixing matrices")
        else:
            want = [(T, R, m, m)] + ([] if rounds_only else [(T, m, m)])
            if tuple(self.mix.shape) not in want:
                kind = ("faulted" if self.fail is not None
                        else "fused" if plan.fused else "unfused")
                raise ValueError(f"recorded mix must have shape {' or '.join(map(str, want))} "
                                 f"for a {kind} run, got {tuple(self.mix.shape)}")
        ids, mix, _ = self._device(plan.counts.device)
        s = slice(t0 - 1, t0 - 1 + n)
        mix = None if mix is None else mix[s]
        if mix is not None and plan.fused and plan.faults is None and mix.ndim == 4:
            with region("gadget.collapse"):
                mix = collapse_rounds(mix)  # recorded rounds of a fault-free fused run
        return ids[s], mix

    def fails(self, t0: int, n: int, plan: DrawPlan) -> torch.Tensor:
        """The recorded failure masks of iterations t0 … t0+n−1."""
        if self.fail is None:
            raise ValueError("a faulted run needs recorded failure masks (fails=)")
        want = (self.ids.shape[0], plan.rounds, plan.m, plan.m)
        if tuple(self.fail.shape) != want:
            raise ValueError(f"recorded fails must have shape {want}, got "
                             f"{tuple(self.fail.shape)}")
        return self._device(plan.counts.device)[2][t0 - 1:t0 - 1 + n]


class _Partitions:
    """A run's (m, n_i, ·) data planes and (m, n_i) labels on the device in
    one format, with the minibatch gather, the half-step on the run's route
    (``route``, a key of ``ops.HALF_STEP_KINDS``; ``launch_shape`` its
    ``ops.launch_cost`` shape) and the masked primal objective."""

    def __init__(self, planes: tuple, y: torch.Tensor, d: int):
        (self.m, self.n_i), self.d = y.shape, d
        self.planes, self.y = planes, y
        self.flat = tuple(P.reshape(self.m * self.n_i, -1) for P in planes)
        self.y_flat = y.reshape(self.m * self.n_i)
        self.rows = torch.arange(self.m, device=y.device)[:, None]

    def gather(self, ids):
        """Every node's minibatch rows ``ids`` (m, B): ``(planes, yb)``."""
        yb = self.y[self.rows, ids]
        return tuple(P[self.rows, ids] for P in self.planes), yb

    def objective(self, w, lam: float, valid, total):
        return self.primal(w, *self.flat, self.y_flat, lam, valid, total)


class _Dense(_Partitions):
    """Dense (m, n_i, d) partitions. Fused: ``ops.fleet_half_step``, one
    launch for the fleet (two above the kernel's minibatch cap, a cut-over
    made and costed in ``ops``); else ``ops.unfused_fleet_half_step``."""

    primal = staticmethod(obj.primal_objective_masked)

    def __init__(self, X: torch.Tensor, y: torch.Tensor, cfg: GadgetConfig):
        if X.ndim != 3 or y.shape != X.shape[:2]:
            raise ValueError(f"need X (m, n_i, d) and y (m, n_i), got "
                             f"{tuple(X.shape)} and {tuple(y.shape)}")
        super().__init__((X,), y, X.shape[2])
        self.row_mask = torch.ones((cfg.batch_size,), dtype=torch.float32, device=y.device)
        self.route = "fused" if cfg.fused else "unfused"
        self.half_step = self._fused if cfg.fused else self._unfused
        self.launch_shape = dict(m=self.m, B=cfg.batch_size, d=self.d)

    def _fused(self, W, Xb, yb, **step):
        return ops.fleet_half_step(W, *Xb, yb, row_mask=self.row_mask, **step)

    def _unfused(self, W, Xb, yb, **step):
        return ops.unfused_fleet_half_step(W, *Xb, yb, **step)


class _Ell(_Partitions):
    """ELL partitions, the ``(cols int32, vals float32)`` pair of (m, n_i, k)
    planes. The half-step is fleet-wide whether fused or not:
    ``ops.ell_fleet_half_step`` on the schedule, ``blk_d`` and map width
    resolved here once, from the planes' static block bound."""

    primal = staticmethod(obj.primal_objective_masked_ell)

    def __init__(self, X_parts, y: torch.Tensor, cfg: GadgetConfig):
        cols = X_parts.cols
        cols = cols if isinstance(cols, torch.Tensor) else torch.from_numpy(np.asarray(cols))
        cols = cols.to(device=y.device, dtype=torch.int32).contiguous()
        vals = _as_f32(X_parts.vals, y.device)
        if cols.ndim != 3 or vals.shape != cols.shape or y.shape != cols.shape[:2]:
            raise ValueError(f"need ELL planes (m, n_i, k) and y (m, n_i), got cols "
                             f"{tuple(cols.shape)}, vals {tuple(vals.shape)}, y {tuple(y.shape)}")
        super().__init__((cols, vals), y, int(X_parts.d))
        B, bound = cfg.batch_size, None
        if cfg.sparse_schedule != "sweep":  # the sweep reads no block bound
            bound = (X_parts.block_bound(B) if hasattr(X_parts, "block_bound")  # cached
                     else minibatch_block_bound(np.asarray(X_parts.cols),
                                                np.asarray(X_parts.vals), B, d=self.d))
        k = max(cols.shape[2], 1)  # ops widens k = 0 planes to one inert entry a row
        self.route, self.blk_d, self.n_blocks_max = ops.resolve_ell_schedule(
            cfg.sparse_schedule, B=B, k=k, d=self.d, n_blocks_max=bound)
        self.launch_shape = dict(m=self.m, B=B, k=k, d=self.d, n_blocks_max=self.n_blocks_max,
                                 blk_d=self.blk_d)

    def half_step(self, W, Xb, yb, **step):
        return ops.ell_fleet_half_step(W, *Xb, yb, schedule=self.route,
                                       n_blocks_max=self.n_blocks_max, blk_d=self.blk_d, **step)


def _partitions(X_parts, y_parts, cfg: GadgetConfig, device: torch.device) -> _Partitions:
    """The run's partitions on the device and their half-step route: the
    trainer's one test of the format. X_parts is dense (m, n_i, d), or ELL
    duck-typed on ``.cols``, ``.vals`` and ``.d`` (the reference's
    ``EllPartitions`` trains too)."""
    y = _as_f32(y_parts, device)
    if hasattr(X_parts, "cols") and hasattr(X_parts, "vals"):
        return _Ell(X_parts, y, cfg)
    return _Dense(_as_f32(X_parts, device), y, cfg)


def _partition_counts(m: int, n_i: int, n_counts) -> np.ndarray:
    if n_counts is None:
        return np.full((m,), n_i, np.int64)
    counts = np.asarray(n_counts)
    if counts.shape != (m,):
        raise ValueError(f"n_counts must have shape ({m},), got {counts.shape}")
    if np.any(counts < 1) or np.any(counts > n_i):
        raise ValueError(f"n_counts must lie in [1, {n_i}]")
    return counts.astype(np.int64)


def _as_f32(a, device: torch.device) -> torch.Tensor:
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))
    return t.to(device=device, dtype=torch.float32).contiguous()


def _validate_topology(cfg: GadgetConfig) -> None:
    if cfg.topology not in topo.TOPOLOGIES:
        raise ValueError(f"unknown topology {cfg.topology!r}")


def _resolve_faults(cfg: GadgetConfig, m: int) -> GadgetConfig:
    """Validate and normalise cfg.faults against the m-node fleet; a plan
    with no drops and no dead nodes becomes None (the fault-free path, bit
    for bit)."""
    if cfg.faults is None:
        return cfg
    plan = flt.validate_plan(cfg.faults, m)
    if plan.drop_prob == 0.0 and not plan.dead_nodes:
        return cfg._replace(faults=None)
    return cfg._replace(faults=plan)


def _validate_snapshotting(snapshot_every, snapshot_slots) -> int:
    if snapshot_every is None:
        return 0
    if int(snapshot_every) < 1:
        raise ValueError(f"snapshot_every must be >= 1, got {snapshot_every}")
    if int(snapshot_slots) < 1:
        raise ValueError(f"snapshot_slots must be >= 1, got {snapshot_slots}")
    return int(snapshot_every)


def _mixing_cycle(cfg: GadgetConfig, m: int, device: torch.device) -> torch.Tensor:
    """The deterministic topology's per-iteration mixing cycle, uploaded once:
    collapsed products (period, m, m) when fused, else the (period, R, m, m)
    rounds each iteration consumes. Iteration t uses entry (t−1) % period."""
    R = cfg.gossip_rounds
    if cfg.fused:
        cycle = topo.build_product_stack(cfg.topology, m, R)
    else:
        stack = topo.build_matrix_stack(cfg.topology, m)
        T = stack.shape[0]
        period = topo.product_period(cfg.topology, m, R)
        cycle = np.stack([stack[(k * R + np.arange(R)) % T] for k in range(period)])
    return torch.from_numpy(cycle).to(device)


@functools.lru_cache(maxsize=64)
def _gossip_bytes_per_iter(topology: str, m: int, R: int, d: int) -> int:
    """Gossip payload bytes one iteration moves: R rounds × live off-diagonal
    links a round × (d weights + 1 mass) × 4 bytes; the random protocol
    pushes to one neighbour a node a round. Feeds ``train.gossip_bytes``."""
    if topology == "random":
        links = float(m)
    else:
        stack = np.asarray(topo.build_matrix_stack(topology, m))
        offdiag = (stack != 0).sum(axis=(1, 2)) - (
            np.diagonal(stack, axis1=1, axis2=2) != 0).sum(axis=1)
        links = float(offdiag.mean())
    return int(round(R * links * (d + 1) * 4))


class _Run:
    """One training run's data, draw plan and step on the device, shared by
    :func:`gadget_train` and :func:`gadget_train_stream`."""

    def __init__(self, X_parts, y_parts, cfg: GadgetConfig, n_counts, device, draws):
        self.dev = resolve_device(device)
        self.data = data = _partitions(X_parts, y_parts, cfg, self.dev)
        m, n_i, self.m, self.d = data.m, data.n_i, data.m, data.d
        self.cfg = cfg = _resolve_faults(cfg, m)
        counts_i = torch.from_numpy(_partition_counts(m, n_i, n_counts)).to(self.dev)
        self.counts_f = counts_i.to(torch.float32)
        self.total = self.counts_f.sum()
        self.valid = (torch.arange(n_i, device=self.dev)[None, :] < counts_i[:, None]).reshape(-1)
        self.plan = DrawPlan(m, cfg.batch_size, cfg.gossip_rounds, cfg.topology, cfg.fused,
                             counts_i, cfg.faults)
        self.draws = GeneratorDraws(cfg.seed) if draws is None else draws
        self.dead = (flt.dead_mask(cfg.faults, m, self.dev)
                     if cfg.faults is not None and cfg.faults.dead_nodes else None)
        self._cycle = None  # a deterministic topology's uploaded per-iteration cycle
        self._stack = None  # its uploaded round matrices, under faults
        self._host_stack = None  # its round matrices on the host, for the host loop

    def consensus_of(self, W: torch.Tensor) -> torch.Tensor:
        return (W * self.counts_f[:, None]).sum(dim=0) / self.total

    def objective_of(self, w: torch.Tensor) -> torch.Tensor:
        return self.data.objective(w, self.cfg.lam, self.valid, self.total)

    def _clean_rounds(self, t0: int, n: int) -> torch.Tensor:
        """A deterministic topology's clean rounds of iterations t0 … t0+n−1,
        (n, R, m, m), indexed on the device from its uploaded matrix cycle."""
        if self._stack is None:
            self._stack = torch.from_numpy(
                topo.build_matrix_stack(self.cfg.topology, self.m)).to(self.dev)
            transfer_stats["matrix_uploads"] += 1
        R, T = self.cfg.gossip_rounds, self._stack.shape[0]
        idx = ((_arange(n, self.dev)[:, None] + (t0 - 1)) * R + _arange(R, self.dev)) % T
        return self._stack[idx]

    def _uploaded_rounds(self, t0: int, n: int) -> torch.Tensor:
        """The host loop's rounds of iterations t0 … t0+n−1, (n, R, m, m): a
        deterministic topology's R matrices built on the host and uploaded
        one iteration at a time, each upload counted."""
        if self._host_stack is None:
            self._host_stack = topo.build_matrix_stack(self.cfg.topology, self.m)
        R, T = self.cfg.gossip_rounds, self._host_stack.shape[0]
        rounds = []
        for t in range(t0, t0 + n):
            idx = ((t - 1) * R + np.arange(R)) % T
            rounds.append(torch.from_numpy(self._host_stack[idx]).to(self.dev))
            transfer_stats["matrix_uploads"] += 1
        return torch.stack(rounds)

    def _step(self, ids, W, Bs, t: int):
        """Steps (a)-(h) for all m nodes at iteration t; ``Bs`` the collapsed
        (m, m) product (fused) or the (R, m, m) rounds. Returns the new
        weights and the post-mix mass weights."""
        cfg = self.cfg
        with region("gadget.step"):
            with region("gadget.gather"):
                Xb, yb = self.data.gather(ids)
            with region("gadget.half_step"):
                W_half = self.data.half_step(W, Xb, yb, lam=cfg.lam, t=t,
                                             project=cfg.project_before_gossip)
            mix = mix_collapsed if cfg.fused else mix_rounds
            pushed = W_half * self.counts_f[:, None]
            with region("gadget.mix"):
                vals, wts = mix(pushed, self.counts_f, Bs)
            W_new = vals / wts[:, None]
            if cfg.project_after_gossip:
                with region("gadget.projection"):
                    W_new = obj.project_ball(W_new, cfg.lam)
            if self.dead is not None:
                # crashed nodes neither train nor receive: frozen bit for bit
                # after the mix's renormalising divide
                W_new = torch.where(self.dead[:, None], W, W_new)
        return W_new, wts

    def chunk(self, W, W_sum, t0: int, n: int, rings=None, count_drops: bool = False,
              upload_rounds: bool = False):
        """Iterations t0 … t0+n−1 from ``(W, W_sum)``, with no host sync.
        Returns ``(W, W_sum, masses (n,), drops)``: ``drops`` the (n, m)
        per-sender faulted-message counts when ``count_drops`` and faults are
        on, else None. ``rings`` (a :class:`_Rings`) records at its
        iterations. ``upload_rounds``: a deterministic topology's rounds
        come from :meth:`_uploaded_rounds` (the host loop), not from the
        cycle uploaded once."""
        cfg, plan = self.cfg, self.plan
        with region("gadget.trainer"):
            with region("gadget.draws"):
                ids, mix = self.draws.take(t0, n, plan)
            if mix is None and upload_rounds:
                mix = self._uploaded_rounds(t0, n)
            drops = None
            if cfg.faults is not None:
                clean = mix if mix is not None else self._clean_rounds(t0, n)
                with region("gadget.draws"):
                    fails = self.draws.fails(t0, n, plan)
                with region("gadget.faults"):
                    faulty = flt.apply_faults(clean, fails, cfg.faults, dead=self.dead)
                if cfg.fused:
                    with region("gadget.collapse"):
                        mix = collapse_rounds(faulty)
                else:
                    mix = faulty
                if count_drops:
                    drops = flt.count_drops_node(clean, fails, cfg.faults, dead=self.dead)
            elif mix is None and self._cycle is None:
                self._cycle = _mixing_cycle(cfg, self.m, self.dev)
                transfer_stats["matrix_uploads"] += 1
            masses = []
            for k in range(n):
                t = t0 + k
                Bs = mix[k] if mix is not None else self._cycle[(t - 1) % self._cycle.shape[0]]
                W, wts = self._step(ids[k], W, Bs, t)
                W_sum = W_sum + W
                mass = wts.sum() / self.total
                masses.append(mass)
                if rings is not None:
                    rings.after(self, t, W, wts, mass, None if drops is None else drops[k])
            return W, W_sum, torch.stack(masses), drops

    def record_iterations(self, n_iters: int) -> None:
        """Registry accounting for ``n_iters`` finished iterations:
        ``train.iterations``, ``train.gossip_bytes`` and the kernel launches
        of the run's half-step route. Host bookkeeping only."""
        if n_iters <= 0:
            return
        cfg = self.cfg
        reg = tmr.default_registry()
        reg.counter("train.iterations").inc(n_iters)
        reg.counter("train.gossip_bytes").inc(
            n_iters * _gossip_bytes_per_iter(cfg.topology, self.m, cfg.gossip_rounds, self.d))
        for kind in ops.HALF_STEP_KINDS[self.data.route]:
            ops.record_launch(kind, n_iters, registry=reg, **self.data.launch_shape)


class _Rings:
    """The anytime-export ring and the telemetry ring as device tensors,
    written at iterations the host knows (slot = count % slots), so they
    add no sync; :meth:`snapshots` and :meth:`trace` read them back."""

    def __init__(self, run: _Run, snap_every: int, snap_slots: int,
                 tele: tmt.TrainTelemetry | None):
        dev, d, m = run.dev, run.d, run.m
        self.snap_every, self.tele = snap_every, tele
        self.count_drops = tele is not None and run.cfg.faults is not None
        if snap_every:
            self.snap_W = torch.zeros((snap_slots, d), dtype=torch.float32, device=dev)
            self.snap_obj = torch.full((snap_slots,), float("nan"), device=dev)
            self.snap_it = np.zeros((snap_slots,), np.int32)
            self.snap_count = 0
        if tele is not None:
            S = tele.slots
            # disagreement, window mass min and max, objective per record
            self.scal = torch.full((S, 4), float("nan"), device=dev)
            self.tdr = torch.zeros((S,), dtype=torch.int64, device=dev)
            self.ti = np.zeros((S,), np.int32)
            self.tc = 0
            if tele.per_node:
                self.ndis = torch.full((S, m), float("nan"), device=dev)
                self.nmass = torch.full((S, m), float("nan"), device=dev)
                self.ndrop = torch.zeros((S, m), dtype=torch.int64, device=dev)
            self.win_mass: list[torch.Tensor] = []
            self.win_drops: list[torch.Tensor] = []

    def after(self, run: _Run, t: int, W, wts, mass, drops) -> None:
        """Record what iteration t's rings take (``drops`` its (m,) counts)."""
        if self.snap_every and t % self.snap_every == 0:
            slot = self.snap_count % self.snap_W.shape[0]
            w_cons = run.consensus_of(W)
            self.snap_W[slot] = w_cons
            self.snap_obj[slot] = run.objective_of(w_cons)
            self.snap_it[slot] = t
            self.snap_count += 1
        if self.tele is None:
            return
        self.win_mass.append(mass)
        if drops is not None:
            self.win_drops.append(drops)
        if t % self.tele.every:
            return
        slot = self.tc % self.tele.slots
        w_cons = run.consensus_of(W)
        node_dis = torch.linalg.vector_norm(W - w_cons[None, :], dim=1)
        win = torch.stack(self.win_mass)
        self.scal[slot] = torch.stack([node_dis.max(), win.min(), win.max(),
                                       run.objective_of(w_cons)])
        if self.win_drops:
            window = torch.stack(self.win_drops).sum(dim=0)
            self.tdr[slot] = window.sum()
            if self.tele.per_node:
                self.ndrop[slot] = window
        if self.tele.per_node:
            self.ndis[slot] = node_dis
            self.nmass[slot] = wts / run.counts_f
        self.ti[slot] = t
        self.tc += 1
        self.win_mass, self.win_drops = [], []

    def snapshots(self, w_cons: np.ndarray, iters: int, final_objective: float) -> SnapshotRing:
        return SnapshotRing(every=self.snap_every, W=self.snap_W.cpu().numpy(),
                            iterations=self.snap_it.copy(),
                            objectives=self.snap_obj.cpu().numpy(), count=self.snap_count,
                            final_w=w_cons, final_iteration=iters,
                            final_objective=final_objective)

    def trace(self, iters: int, final_disagreement: float) -> tmt.TrainTrace:
        scal = self.scal.cpu().numpy()
        per_node = self.tele.per_node
        return tmt.decode_ring(self.tele.every, self.tele.slots, self.tc, self.ti,
                               scal[:, 0], scal[:, 1], scal[:, 2], scal[:, 3],
                               self.tdr.cpu().numpy(), iters, final_disagreement,
                               node_disagreement=self.ndis.cpu().numpy() if per_node else None,
                               node_mass=self.nmass.cpu().numpy() if per_node else None,
                               node_drops=self.ndrop.cpu().numpy() if per_node else None)


def _zero_iteration_result(X_parts, y_parts, cfg, device, snap_every, snapshot_slots,
                           tele_cfg) -> GadgetResult:
    """The initial state (``cfg.max_iters <= 0``), with an empty ring and an
    empty trace when asked for, as the reference returns them."""
    dev = resolve_device(device)
    data = _partitions(X_parts, y_parts, cfg, dev)
    m, d = data.m, data.d
    trace = None
    if tele_cfg:
        # W = 0 everywhere: disagreement is exactly 0, nothing recorded
        empty_i, empty_f = np.zeros((0,), np.int64), np.zeros((0,), np.float64)
        empty_nf = np.zeros((0, m), np.float64)
        trace = tmt.TrainTrace(
            every=tele_cfg.every, iterations=empty_i, disagreement=empty_f,
            mass_min=empty_f, mass_max=empty_f, objective=empty_f, drops=empty_i,
            final_iteration=0, final_disagreement=0.0,
            node_disagreement=empty_nf if tele_cfg.per_node else None,
            node_mass=empty_nf if tele_cfg.per_node else None,
            node_drops=empty_nf.astype(np.int64) if tele_cfg.per_node else None)
        tmt.publish_trace(trace)
    ring = None
    if snap_every:
        # w = 0 scores every margin 0, so the masked primal objective is 1
        ring = SnapshotRing(every=snap_every,
                            W=np.zeros((int(snapshot_slots), d), np.float32),
                            iterations=np.zeros((int(snapshot_slots),), np.int32),
                            objectives=np.full((int(snapshot_slots),), np.nan, np.float32),
                            count=0, final_w=np.zeros((d,), np.float32),
                            final_iteration=0, final_objective=1.0)
    zeros = torch.zeros((m, d), dtype=torch.float32, device=dev)
    empty = np.zeros((0,), np.float32)
    return GadgetResult(W=zeros, w_consensus=zeros[0].clone(), iters=0,
                        epsilon=float("inf"), objective_trace=empty,
                        time_trace=empty.astype(np.int32), eps_trace=empty,
                        W_avg=zeros.clone(), snapshots=ring, mass_trace=empty,
                        telemetry=trace)


def _nonfinite(iteration: int) -> NonFiniteWeightsError:
    tmr.default_registry().counter("train.nonfinite").inc()
    return NonFiniteWeightsError(iteration)


class _Segment(NamedTuple):
    """One segment of :func:`_segments`: the state after it and its readings."""

    iteration: int
    n_active: int
    W: torch.Tensor
    W_sum: torch.Tensor
    w_host: np.ndarray  # (d,) float32 consensus
    epsilon: float
    objective: float
    mass: float
    done: bool
    stats: tmt.SegmentTelemetry | None
    seconds: float
    start: float  # time.time() at the segment's start: the torch profiler's clock


def _segments(run: _Run, seg: int, W, W_sum, t: int, rings: _Rings | None = None,
              segment_stats: bool = False):
    """The one training loop of :func:`gadget_train` and
    :func:`gadget_train_stream`: segments of ``seg`` iterations from
    iteration ``t`` and ``(W, W_sum)``, one host sync each, until ε <
    ``cfg.epsilon`` or ``cfg.max_iters``. ``rings`` record inside the
    segments; ``segment_stats`` adds each segment's
    :class:`~repro_torch.telemetry.train.SegmentTelemetry`. Raises
    :class:`NonFiniteWeightsError` at a non-finite consensus. Each segment
    is one ``gadget.segment`` profiler range, closed before the ``yield``."""
    cfg = run.cfg
    count_drops = cfg.faults is not None and (
        rings.count_drops if rings is not None else segment_stats)
    while True:
        seg_t0, start = time.monotonic(), time.time()
        with region("gadget.segment"):
            n_active = max(0, min(seg, cfg.max_iters - t + 1))
            W_prev, drops, masses = W, None, None
            if n_active:
                W, W_sum, masses, drops = run.chunk(W, W_sum, t, n_active, rings,
                                                    count_drops=count_drops)
                t += n_active
            with region("gadget.check"):
                if n_active:
                    mass = masses.min()
                    if n_active < seg:
                        # the reference scans whole chunks and counts an idle
                        # tail iteration as full mass
                        mass = torch.clamp(mass, max=1.0)
                else:
                    mass = torch.ones((), device=run.dev)
                w_cons = run.consensus_of(W)
                scalars = [torch.linalg.vector_norm(W - W_prev, dim=1).max(),
                           run.objective_of(w_cons), mass]
                if segment_stats:
                    nan = torch.full((), float("nan"), device=run.dev)
                    scalars += [torch.linalg.vector_norm(W - w_cons[None, :], dim=1).max(),
                                nan if masses is None else masses.min(),
                                nan if masses is None else masses.max(),
                                torch.zeros((), device=run.dev) if drops is None
                                else drops.sum()]
                readings = torch.cat([w_cons.to(torch.float64),
                                      torch.stack([s.to(torch.float64) for s in scalars])])
            with region("gadget.sync"):
                host = readings.cpu().numpy()  # the segment's one host sync
            transfer_stats["host_syncs"] += 1
            seconds = time.monotonic() - seg_t0
            w_host, vals = host[:run.d].astype(np.float32), host[run.d:]
            iteration = t - 1
            if not np.all(np.isfinite(w_host)):
                raise _nonfinite(iteration)
            run.record_iterations(n_active)
            stats = None
            if segment_stats:
                stats = tmt.SegmentTelemetry(disagreement=float(vals[3]),
                                             mass_min=float(vals[4]), mass_max=float(vals[5]),
                                             objective=float(vals[1]), drops=int(vals[6]))
            eps = float(vals[0])
            done = eps < cfg.epsilon or iteration >= cfg.max_iters
            segment = _Segment(iteration, n_active, W, W_sum, w_host, eps,
                               float(np.float32(vals[1])), float(np.float32(vals[2])), done,
                               stats, seconds, start)
        yield segment
        if done:
            return


def gadget_train(X_parts, y_parts, cfg: GadgetConfig = GadgetConfig(), *,
                 n_counts=None, device: torch.device | str | None = None,
                 draws: GeneratorDraws | RecordedDraws | None = None,
                 snapshot_every: int | None = None,
                 snapshot_slots: int = DEFAULT_SNAPSHOT_SLOTS,
                 telemetry: tmt.TrainTelemetry | None = None) -> GadgetResult:
    """GADGET over m simulated nodes on one device.

    X_parts: (m, n_i, d) dense partitions as a numpy array or tensor, or ELL
    partitions (``repro_torch.sparse.EllPartitions`` or any object with
    (m, n_i, k) ``.cols`` and ``.vals`` planes and ``.d``); y_parts: (m, n_i)
    labels. ``n_counts`` (m,): per-node valid-row counts of
    partitions padded to a common n_i; padded rows must carry y=0, are never
    sampled, carry no Push-Sum mass and are left out of the consensus and
    the objective. ``device``: CUDA unless given. ``draws``: the randomness
    source, ``GeneratorDraws(cfg.seed)`` unless given.

    ``snapshot_every=K``: every K-th iteration records (iteration, consensus
    w, objective) into a ring of ``snapshot_slots`` entries, returned with
    the final iterate as ``result.snapshots`` (decode with
    ``repro_torch.serve.snapshot.snapshots_from``). ``telemetry`` (a
    :class:`~repro_torch.telemetry.train.TrainTelemetry`): the trace ring of
    consensus disagreement, windowed Push-Sum mass extrema, objective and
    fault drops every ``telemetry.every`` iterations, decoded into
    ``result.telemetry`` and mirrored onto the default registry. Neither
    changes the trajectory.
    """
    _validate_topology(cfg)
    tele_cfg = tmt.validate_telemetry(telemetry)
    snap_every = _validate_snapshotting(snapshot_every, snapshot_slots)
    if cfg.max_iters <= 0:  # zero-iteration call: the initial state
        return _zero_iteration_result(X_parts, y_parts, cfg, device, snap_every,
                                      snapshot_slots, tele_cfg)
    run = _Run(X_parts, y_parts, cfg, n_counts, device, draws)
    cfg = run.cfg
    rings = (_Rings(run, snap_every, int(snapshot_slots), tele_cfg)
             if snap_every or tele_cfg else None)
    W = torch.zeros((run.m, run.d), dtype=torch.float32, device=run.dev)
    readings = []  # (objective, iteration, ε, mass) per chunk
    for g in _segments(run, min(cfg.check_every, cfg.max_iters), W, torch.zeros_like(W), 1,
                       rings):
        readings.append((g.objective, g.iteration, g.epsilon, g.mass))
    W, W_sum, iters, eps = g.W, g.W_sum, g.iteration, g.epsilon
    obj_tr, it_tr, eps_tr, mass_tr = zip(*readings)
    w_cons = run.consensus_of(W)
    snapshots = trace = None
    if snap_every:
        snapshots = rings.snapshots(w_cons.cpu().numpy(), iters,
                                    float(run.objective_of(w_cons)))
    if tele_cfg:
        final_dis = float(torch.linalg.vector_norm(W - w_cons[None, :], dim=1).max())
        trace = rings.trace(iters, final_dis)
        tmt.publish_trace(trace)
    return GadgetResult(
        W=W,
        w_consensus=w_cons,
        iters=iters,
        epsilon=eps,
        objective_trace=np.asarray(obj_tr, np.float32),
        time_trace=np.asarray(it_tr, np.int32),
        eps_trace=np.asarray(eps_tr, np.float32),
        W_avg=W_sum / max(iters, 1),
        snapshots=snapshots,
        mass_trace=np.asarray(mass_tr, np.float32),
        telemetry=trace,
    )


def gadget_train_stream(X_parts, y_parts, cfg: GadgetConfig = GadgetConfig(), *,
                        segment_iters: int, n_counts=None,
                        device: torch.device | str | None = None,
                        draws: GeneratorDraws | RecordedDraws | None = None,
                        resume: TrainState | None = None,
                        telemetry: tmt.TrainTelemetry | None = None,
                        trace: bool = False, trace_link: str | None = None,
                        trace_registry=None):
    """Generator twin of :func:`gadget_train`: yields a :class:`SegmentResult`
    every ``segment_iters`` iterations, the live train-to-serve tap
    (``repro_torch.serve.publisher`` runs it in a background thread).

    The trajectory is :func:`gadget_train`'s bit for bit: both run one
    loop (``_segments``), and every draw is keyed on the global iteration.
    ``segment_iters`` plays the part of ``cfg.check_every``: the stream ends
    after the segment where ε < ``cfg.epsilon`` or ``cfg.max_iters`` is
    reached (its result has ``done=True``). One host sync per segment. Data
    conventions, ``device`` and ``draws`` as :func:`gadget_train`.

    ``resume`` (a :class:`TrainState`, e.g. from
    ``serve.snapshot.train_state_from_checkpoint``) continues a run from its
    last completed iteration; the resumed trajectory is the uninterrupted
    one bit for bit. ``telemetry`` attaches a
    :class:`~repro_torch.telemetry.train.SegmentTelemetry` to every segment
    (boundary disagreement and objective, mass extrema and fault drops over
    the segment's active iterations) and mirrors it onto the default
    registry; ``every`` and ``slots`` do not apply. ``trace=True`` starts
    one causal trace per segment: a ``train.segment`` span on
    ``trace_registry`` (default: the default registry), whose context rides
    out on ``SegmentResult.trace``; ``trace_link`` (a prior run's trace id)
    is stamped on the first segment's span as ``resumed_from_trace``.
    """
    _validate_topology(cfg)
    tele_cfg = tmt.validate_telemetry(telemetry)
    if int(segment_iters) < 1:
        raise ValueError(f"segment_iters must be >= 1, got {segment_iters}")
    if cfg.max_iters <= 0:
        raise ValueError("gadget_train_stream needs cfg.max_iters > 0 "
                         "(use gadget_train for the zero-iteration case)")
    seg = int(segment_iters)
    run = _Run(X_parts, y_parts, cfg, n_counts, device, draws)
    cfg = run.cfg
    if resume is not None:
        W = _as_f32(resume.W, run.dev)
        W_sum = _as_f32(resume.W_sum, run.dev)
        if W.shape != (run.m, run.d) or W_sum.shape != (run.m, run.d):
            raise ValueError(f"resume state shape {tuple(W.shape)}/{tuple(W_sum.shape)} "
                             f"does not match the ({run.m}, {run.d}) fleet")
        if int(resume.iteration) < 0:
            raise ValueError(f"resume iteration must be >= 0, got {resume.iteration}")
        t = int(resume.iteration) + 1
    else:
        W = torch.zeros((run.m, run.d), dtype=torch.float32, device=run.dev)
        W_sum = torch.zeros_like(W)
        t = 1
    first_segment = True
    for g in _segments(run, seg, W, W_sum, t, segment_stats=tele_cfg is not None):
        if g.stats is not None:
            reg = tmr.default_registry()
            reg.gauge("train.final_disagreement").set(g.stats.disagreement)
            reg.gauge("train.objective").set(g.stats.objective)
            if np.isfinite(g.stats.mass_min):
                reg.gauge("train.mass_min").set(g.stats.mass_min)
                reg.gauge("train.mass_max").set(g.stats.mass_max)
            reg.counter("train.fault_drops").inc(g.stats.drops)
        seg_ctx = None
        if trace:
            # one fresh trace per segment: the lineage root the publisher and
            # the server hang their spans off (via SegmentResult.trace)
            seg_ctx = tmtr.TraceContext.new()
            attrs = {"iteration": g.iteration, "objective": g.objective,
                     "epsilon": g.epsilon, "done": g.done}
            if first_segment and trace_link:
                attrs["resumed_from_trace"] = trace_link
            tmtr.emit_span(trace_registry if trace_registry is not None
                           else tmr.default_registry(),
                           "train.segment", seg_ctx, g.seconds, start=g.start, **attrs)
        first_segment = False
        yield SegmentResult(iteration=g.iteration, W=g.W, w_consensus=g.w_host,
                            objective=g.objective, epsilon=g.epsilon, done=g.done,
                            W_sum=g.W_sum, mass=g.mass, telemetry=g.stats, trace=seg_ctx)


# ---------------------------------------------------------------------------
# Host-loop reference (seed semantics): the parity oracle
# ---------------------------------------------------------------------------


class _HostSnapshots:
    """The host loop's anytime ring: each snapshot read back as it is taken
    (a blocking sync), slot for slot the device ring."""

    def __init__(self, every: int, slots: int, d: int):
        self.every, self.slots, self.count = every, slots, 0
        self.W = np.zeros((slots, d), np.float32)
        self.iterations = np.zeros((slots,), np.int32)
        self.objectives = np.full((slots,), np.nan, np.float32)

    def after(self, run: _Run, t: int, W, wts, mass, drops) -> None:
        if t % self.every:
            return
        w_snap = run.consensus_of(W)
        slot = self.count % self.slots
        self.W[slot] = w_snap.cpu().numpy()
        self.iterations[slot] = t
        self.objectives[slot] = float(run.objective_of(w_snap))
        self.count += 1

    def ring(self, run: _Run, w_cons: torch.Tensor, iters: int) -> SnapshotRing:
        return SnapshotRing(every=self.every, W=self.W, iterations=self.iterations,
                            objectives=self.objectives, count=self.count,
                            final_w=w_cons.cpu().numpy(), final_iteration=iters,
                            final_objective=float(run.objective_of(w_cons)))


def gadget_train_reference(X_parts, y_parts, cfg: GadgetConfig = GadgetConfig(), *,
                           n_counts=None, snapshot_every: int | None = None,
                           snapshot_slots: int = DEFAULT_SNAPSHOT_SLOTS,
                           device: torch.device | str | None = None,
                           draws: GeneratorDraws | RecordedDraws | None = None) -> GadgetResult:
    """The reference's host loop, seed semantics: :func:`gadget_train`'s
    unfused chunks on the same draws, differing only in their transfers: a
    deterministic topology's R round matrices are built on the host and
    uploaded one iteration at a time, and every ε-check is two blocking
    syncs (ε, then the objective with the chunk's least mass). Dense and
    ELL partitions, faults, ``n_counts``, ``device`` and ``draws`` as
    :func:`gadget_train`. ``snapshot_every=K`` fills the anytime ring on the
    host, slot for slot the device ring."""
    _validate_topology(cfg)
    snap_every = _validate_snapshotting(snapshot_every, snapshot_slots)
    run = _Run(X_parts, y_parts, cfg._replace(fused=False), n_counts, device, draws)
    cfg = run.cfg
    snaps = _HostSnapshots(snap_every, snapshot_slots, run.d) if snap_every else None
    W = torch.zeros((run.m, run.d), dtype=torch.float32, device=run.dev)
    W_sum = torch.zeros_like(W)
    obj_trace, time_trace, eps_trace, mass_trace = [], [], [], []
    eps = float("inf")
    it = 0
    while it < cfg.max_iters:
        chunk = min(cfg.check_every, cfg.max_iters - it)
        W_prev = W
        W, W_sum, masses, _ = run.chunk(W, W_sum, it + 1, chunk, snaps, upload_rounds=True)
        it += chunk
        eps = float(torch.linalg.vector_norm(W - W_prev, dim=1).max())  # blocking sync
        transfer_stats["host_syncs"] += 1
        w_cons = run.consensus_of(W)
        objective, mass = torch.stack([run.objective_of(w_cons), masses.min()]).tolist()
        transfer_stats["host_syncs"] += 1  # the objective is a second blocking sync
        obj_trace.append(objective)
        time_trace.append(it)
        eps_trace.append(eps)
        mass_trace.append(mass)
        if eps < cfg.epsilon:
            break
    w_cons = run.consensus_of(W)
    return GadgetResult(
        W=W,
        w_consensus=w_cons,
        iters=it,
        epsilon=eps,
        objective_trace=np.asarray(obj_trace, np.float32),
        time_trace=np.asarray(time_trace, np.int32),
        eps_trace=np.asarray(eps_trace, np.float32),
        W_avg=W_sum / max(it, 1),
        snapshots=snaps.ring(run, w_cons, it) if snaps is not None else None,
        mass_trace=np.asarray(mass_trace, np.float32),
    )


# ---------------------------------------------------------------------------
# Mesh path: one GADGET iteration a process
# ---------------------------------------------------------------------------


def make_gadget_mesh_step(cfg: GadgetConfig, axis_sizes: dict[str, int],
                          sparse_block_bound: int | None = None, *, mesh=None,
                          use_kernels: bool | None = None):
    """One node's GADGET step for a mesh of processes, one node a rank.

    Returns ``step(w, X_local, y_local, t, key)``: the local Pegasos
    half-step, then ``cfg.gossip_rounds`` Push-Sum rounds over the
    one-peer exponential schedule of ``axis_sizes`` (none on a one-node
    mesh), then the optional projection. ``key`` is a ``counter_rng`` key
    pair of Python ints and the ids, drawn on the host, are
    ``randint(key, (B,), 0, n_local)``, so the
    reference's ``split(fold_in(PRNGKey(0), t), m)[rank]`` draws its ids.

    ``X_local``: the rank's dense (n_local, d) rows, run through
    ``ops.local_half_step`` (``margins`` then ``grad_update``), or a
    ``(cols, vals)`` pair of its (n_local, k) ELL planes, run through
    ``ops.ell_fleet_half_step`` as a one-node fleet with
    ``cfg.sparse_schedule`` and ``sparse_block_bound`` (derive it from the
    full planes, ``formats.minibatch_block_bound``). ``use_kernels=False``
    takes the plain PyTorch half-steps instead.

    ``cfg.faults`` masks the sends: in round k at iteration t each rank
    draws its fail bit ``bernoulli(fold_in(round_fail_key(plan, t, k),
    rank), p)`` on the host, a dead rank or a dead partner fails, and dead
    ranks are frozen. ``plan.dead_nodes`` are linear indices over
    ``axis_sizes`` (row-major, dict order); an id out of range raises here.
    ``mesh``: a :class:`~repro_torch.core.mesh.Mesh` over ``axis_sizes``,
    by default one built here on the world group (none for a one-node mesh
    without faults)."""
    use_kernels = True if use_kernels is None else bool(use_kernels)
    sched = exponential_schedule(axis_sizes)
    R = cfg.gossip_rounds if sched else 0  # a one-node mesh has no neighbours
    n_total = 1
    for n_ax in axis_sizes.values():
        n_total *= int(n_ax)
    faults = None
    if cfg.faults is not None:
        faults = flt.validate_plan(cfg.faults, n_total)
        if faults.drop_prob == 0.0 and not faults.dead_nodes:
            faults = None  # an inert plan: the unmasked path, bit for bit
    dead_ids = frozenset(faults.dead_nodes) if faults is not None else frozenset()
    if mesh is not None and dict(mesh.axis_sizes) != {str(a): int(n) for a, n in axis_sizes.items()}:
        raise ValueError(f"mesh axes {mesh.axis_sizes} are not {axis_sizes}")
    if mesh is None and (R or faults is not None):
        mesh = Mesh(axis_sizes)

    def half_step(w, X_local, y_local, ids, t: int):
        if isinstance(X_local, tuple):
            cols_l, vals_l = X_local
            Cb, Vb, yb = cols_l[ids][None], vals_l[ids][None], y_local[ids][None]
            if use_kernels:
                return ops.ell_fleet_half_step(w[None], Cb, Vb, yb, lam=cfg.lam, t=t,
                                               project=cfg.project_before_gossip,
                                               schedule=cfg.sparse_schedule,
                                               n_blocks_max=sparse_block_bound)[0]
            return hinge_ref.ell_fleet_half_step_ref(w[None], Cb, Vb, yb, cfg.lam,
                                                     torch.tensor(t, dtype=torch.float32),
                                                     project=cfg.project_before_gossip)[0]
        Xb, yb = X_local[ids], y_local[ids]
        if use_kernels:
            return ops.local_half_step(w, Xb, yb, lam=cfg.lam, t=t,
                                       project=cfg.project_before_gossip)
        # float32 step scalars, as the reference's traced t makes them
        return hinge_ref.half_step_ref(w, Xb, yb, cfg.lam, torch.tensor(t, dtype=torch.float32),
                                       project=cfg.project_before_gossip)

    def step(w: torch.Tensor, X_local, y_local: torch.Tensor, t, key) -> torch.Tensor:
        t = int(t)
        n_local = (X_local[0] if isinstance(X_local, tuple) else X_local).shape[0]
        # a few ids: drawn on the host, one upload
        ids = torch.tensor([crng.randint(key, i, n_local) for i in range(cfg.batch_size)],
                           dtype=torch.int64).to(w.device)
        w_half = half_step(w, X_local, y_local, ids, t)
        state = PushSumState(values=(w_half,),
                             weight=torch.ones((), dtype=torch.float32, device=w.device))
        lin = mesh.rank if mesh is not None else 0
        dead = lin in dead_ids
        for k in range(R):
            rnd = sched[k % len(sched)]
            if faults is None:
                state = push_sum_round(state, rnd, mesh=mesh)
                continue
            fail = bool(crng.bernoulli(crng.fold_in(flt.round_fail_key(faults, t, k), lin), 0,
                                       faults.drop_prob))
            fail = fail or dead or mesh.partner(rnd.axis, rnd.hop) in dead_ids
            state = push_sum_round(state, rnd, fault=(fail, dead, faults.drop), mesh=mesh)
        (w_new,) = state.estimate()
        if cfg.project_after_gossip:
            w_new = obj.project_ball(w_new, cfg.lam)
        if faults is not None and dead:
            w_new = w  # crashed nodes are frozen
        return w_new

    return step
