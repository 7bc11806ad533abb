"""GADGET SVM — Gossip-bAseD sub-GradiEnT solver (paper Algorithm 2).

Port of ``repro.core.gadget.gadget_train`` for dense (m, n_i, d) partitions
and for padded-ELL partitions (``EllPartitions``). Every node i holds a
horizontal partition and a weight vector ŵ_i; one iteration t:

  (a-c)  sample a local minibatch, L̂_i = mean_{violators} y·x under ŵ_i
  (d)    α_t = 1/(λt)
  (e)    w̃_i = (1 − λα_t)ŵ_i + α_t L̂_i
  (f)    [optional] project w̃_i onto the 1/√λ ball
  (g)    ŵ_i ← PushSum(B, w̃_i)
  (h)    [optional] project again

With ``cfg.fused`` (the default) steps (a)-(e) for all m nodes are one
``fleet_half_step`` launch and the R Push-Sum rounds are one collapsed
(m, m) product; ``fused=False`` runs ``margins`` and ``grad_update``, each
one launch for the fleet (the reference vmaps them over the nodes), and the
R rounds in order. On ELL partitions steps (a)-(e) are always
fleet-wide (``ops.ell_fleet_half_step``: two launches, the sweep or the
touched-block pair per ``cfg.sparse_schedule``), and ``fused`` selects only
the mixing. Push-Sum pushes n_i·w̃_i with mass n_i, so the
consensus is the data-weighted mean Σ n_i ŵ_i / N, also under non-uniform
``n_counts``.

The loop is eager PyTorch. Each ε-check chunk of ``cfg.check_every``
iterations draws its randomness at once, runs its iterations, and syncs the
host once for the ε, objective, mass and non-finite readings. The reference
runs the same loop as one jitted ``lax.while_loop``.

Randomness comes from a draw source (:class:`GeneratorDraws` by default,
:class:`RecordedDraws` to replay given draws): torch cannot reproduce the
reference's ``jax.random`` streams, so parity tests replay the reference's
own minibatch ids and mixing matrices.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import svm_objective as obj
from repro_torch.core import topology as topo
from repro_torch.core.push_sum import collapse_rounds, mix_collapsed, mix_rounds
from repro_torch.kernels.hinge_subgrad import ops
from repro_torch.sparse.formats import minibatch_block_bound

__all__ = ["GadgetConfig", "GadgetResult", "NonFiniteWeightsError", "DrawPlan",
           "GeneratorDraws", "RecordedDraws", "gadget_train"]


class NonFiniteWeightsError(FloatingPointError):
    """The consensus weight plane went non-finite during training.

    Raised by :func:`gadget_train` when the guard, checked at the ε-check
    cadence, finds NaN/Inf in the consensus weights. ``iteration`` is the
    last completed iteration when the guard fired; ``context`` names the
    stage that refused.
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
    ``faults`` must stay None in this port (fault injection is a later
    slice)."""

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
    faults: object | None = None


class GadgetResult(NamedTuple):
    """What :func:`gadget_train` returns; fields as in the reference, for
    dense and ELL partitions alike. ``snapshots`` and ``telemetry`` stay
    None until the port's anytime-export slice."""

    W: torch.Tensor              # (m, d) final per-node weights
    w_consensus: torch.Tensor    # (d,) data-weighted network average
    iters: int
    epsilon: float               # max_i ‖Δŵ_i‖ over the last ε-check chunk
    objective_trace: np.ndarray  # (n_checks,) primal objective of the consensus
    time_trace: np.ndarray       # (n_checks,) iteration index per check
    eps_trace: np.ndarray        # (n_checks,) max_i ‖Δŵ_i‖ per check
    W_avg: torch.Tensor | None = None  # (m, d) per-node iterate averages
    snapshots: None = None       # anytime export: a later slice
    # (n_checks,) minimum per-iteration Push-Sum mass retention per chunk
    mass_trace: np.ndarray | None = None
    telemetry: None = None       # training telemetry: a later slice


class DrawPlan(NamedTuple):
    """What a draw source must produce for one run."""

    m: int
    batch_size: int
    rounds: int
    topology: str
    fused: bool
    counts: torch.Tensor         # (m,) int64 valid rows per node, on the run's device


class GeneratorDraws:
    """The port's own draws, from a ``torch.Generator`` on the run's device.

    Minibatch ids are uniform over each node's first ``counts[i]`` rows. The
    random topology draws R one-neighbour matrices per iteration (folded
    into one product when fused); deterministic topologies draw no mixing
    (the trainer indexes the uploaded cycle).
    """

    def __init__(self, seed: int):
        self.seed = int(seed)
        self._gen: torch.Generator | None = None

    def take(self, t0: int, n: int, plan: DrawPlan):
        """Draws of iterations t0 … t0+n−1: ids (n, m, B) int64 and the mixing
        (n, m, m) fused, (n, R, m, m) unfused, or None."""
        device = plan.counts.device
        if self._gen is None:
            self._gen = torch.Generator(device=device)
            self._gen.manual_seed(self.seed)
        raw = torch.randint(0, 1 << 62, (n, plan.m, plan.batch_size),
                            generator=self._gen, device=device)
        ids = raw % plan.counts[:, None]
        if plan.topology != "random":
            return ids, None
        Bs = topo.random_neighbor_matrix_device(plan.m, generator=self._gen,
                                                batch=(n, plan.rounds))
        return ids, collapse_rounds(Bs) if plan.fused else Bs


class RecordedDraws:
    """Replays given draws: ``ids`` (T, m, B) minibatch row ids and ``mix``,
    either (T, m, m) collapsed products (fused runs) or (T, R, m, m) round
    stacks (unfused runs), or None for a deterministic topology's own
    cycle. Row t−1 holds iteration t's draws."""

    def __init__(self, ids, mix=None):
        self.ids = torch.as_tensor(np.array(ids), dtype=torch.int64)
        self.mix = None if mix is None else torch.as_tensor(np.array(mix),
                                                            dtype=torch.float32)
        self._on: dict[torch.device, tuple] = {}

    def take(self, t0: int, n: int, plan: DrawPlan):
        """The recorded draws of iterations t0 … t0+n−1 on the run's device."""
        m, B, R = plan.m, plan.batch_size, plan.rounds
        T = self.ids.shape[0]
        if self.ids.shape[1:] != (m, B) or t0 - 1 + n > T:
            raise ValueError(f"recorded ids {tuple(self.ids.shape)} do not cover "
                             f"iterations {t0}..{t0 + n - 1} of a ({m}, {B}) run")
        if self.mix is None:
            if plan.topology == "random":
                raise ValueError("the random topology needs recorded mixing matrices")
        else:
            want = (T, m, m) if plan.fused else (T, R, m, m)
            if tuple(self.mix.shape) != want:
                raise ValueError(f"recorded mix must have shape {want} for a "
                                 f"{'fused' if plan.fused else 'unfused'} run, "
                                 f"got {tuple(self.mix.shape)}")
        device = plan.counts.device
        if device not in self._on:
            self._on[device] = (self.ids.to(device),
                                None if self.mix is None else self.mix.to(device))
        ids, mix = self._on[device]
        s = slice(t0 - 1, t0 - 1 + n)
        return ids[s], None if mix is None else mix[s]


def _refuse_later_slices(cfg: GadgetConfig, snapshot_every, telemetry) -> None:
    if cfg.faults is not None:
        raise NotImplementedError("cfg.faults comes with the port's fault slice")
    if snapshot_every is not None:
        raise NotImplementedError("snapshot_every comes with the port's anytime-export slice")
    if telemetry is not None:
        raise NotImplementedError("telemetry comes with the port's anytime-export slice")


def _unpack_partitions(X_parts, y_parts, device: torch.device):
    """``(X, y, m, n_i, d)`` on the device: X is the dense (m, n_i, d) float32
    tensor, or the ``(cols int32, vals float32)`` pair of (m, n_i, k) planes
    when the caller passed ELL partitions (duck-typed on ``.cols``,
    ``.vals`` and ``.d``, so the reference's ``EllPartitions`` trains too)."""
    y = _as_f32(y_parts, device)
    if hasattr(X_parts, "cols") and hasattr(X_parts, "vals"):
        cols = X_parts.cols
        cols = cols if isinstance(cols, torch.Tensor) else torch.from_numpy(np.asarray(cols))
        cols = cols.to(device=device, dtype=torch.int32).contiguous()
        vals = _as_f32(X_parts.vals, device)
        if cols.ndim != 3 or vals.shape != cols.shape or y.shape != cols.shape[:2]:
            raise ValueError(f"need ELL planes (m, n_i, k) and y (m, n_i), got cols "
                             f"{tuple(cols.shape)}, vals {tuple(vals.shape)}, y {tuple(y.shape)}")
        m, n_i, _ = cols.shape
        return (cols, vals), y, m, n_i, int(X_parts.d)
    X = _as_f32(X_parts, device)
    if X.ndim != 3 or y.shape != X.shape[:2]:
        raise ValueError(f"need X (m, n_i, d) and y (m, n_i), got "
                         f"{tuple(X.shape)} and {tuple(y.shape)}")
    m, n_i, d = X.shape
    return X, y, m, n_i, d


def _sparse_block_bound(cfg: GadgetConfig, X_parts, X) -> int | None:
    """Static n_blocks_max cap of the prefetch schedule, derived on the host
    from the partition planes. None for dense data and for the sweep
    schedule, which consume no bound."""
    if not isinstance(X, tuple) or cfg.sparse_schedule == "sweep":
        return None
    if hasattr(X_parts, "block_bound"):  # EllPartitions caches its row counts
        return X_parts.block_bound(cfg.batch_size)
    cols, vals = np.asarray(X_parts.cols), np.asarray(X_parts.vals)
    return minibatch_block_bound(cols.reshape(cols.shape[0], -1, cols.shape[-1]), vals,
                                 cfg.batch_size, d=int(X_parts.d))


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


def _gossip_step(cfg: GadgetConfig, X, y, counts_f, total, node_index, row_mask,
                 ids, W, Bs, t: int, block_bound: int | None = None):
    """Steps (a)-(h) for all m nodes at iteration t. ``X`` is the dense
    (m, n_i, d) tensor or the (cols, vals) pair of ELL planes; ``Bs`` is the
    collapsed (m, m) product (fused) or the (R, m, m) round stack;
    ``block_bound`` the prefetch schedule's static n_blocks_max. Returns the
    new weights and the iteration's Push-Sum mass retention Σ wts / Σ n_i."""
    yb = y[node_index, ids]
    if isinstance(X, tuple):
        # sparse: the half-step is fleet-wide whether fused or not; fused
        # selects only the mixing below
        W_half = ops.ell_fleet_half_step(W, X[0][node_index, ids], X[1][node_index, ids],
                                         yb, lam=cfg.lam, t=t,
                                         project=cfg.project_before_gossip,
                                         schedule=cfg.sparse_schedule,
                                         n_blocks_max=block_bound)
    elif cfg.fused:
        Xb = X[node_index, ids]
        W_half = ops.fleet_half_step(W, Xb, yb, lam=cfg.lam, t=t,
                                     project=cfg.project_before_gossip,
                                     row_mask=row_mask)
    else:
        W_half = ops.unfused_fleet_half_step(W, X[node_index, ids], yb, lam=cfg.lam, t=t,
                                             project=cfg.project_before_gossip)
    mix = mix_collapsed if cfg.fused else mix_rounds
    vals, wts = mix(W_half * counts_f[:, None], counts_f, Bs)
    W_new = vals / wts[:, None]
    if cfg.project_after_gossip:
        W_new = obj.project_ball(W_new, cfg.lam)
    return W_new, wts.sum() / total


def gadget_train(X_parts, y_parts, cfg: GadgetConfig = GadgetConfig(), *,
                 n_counts=None, device: torch.device | str | None = None,
                 draws: GeneratorDraws | RecordedDraws | None = None,
                 snapshot_every: int | None = None,
                 telemetry=None) -> GadgetResult:
    """GADGET over m simulated nodes on one device.

    X_parts: (m, n_i, d) dense partitions as a numpy array or tensor, or ELL
    partitions (``repro_torch.sparse.EllPartitions`` or any object with
    (m, n_i, k) ``.cols`` and ``.vals`` planes and ``.d``); y_parts: (m, n_i)
    labels. ``n_counts`` (m,): per-node valid-row counts of
    partitions padded to a common n_i; padded rows must carry y=0, are never
    sampled, carry no Push-Sum mass and are left out of the consensus and
    the objective. ``device``: CUDA unless given. ``draws``: the randomness
    source, ``GeneratorDraws(cfg.seed)`` unless given.

    ``cfg.faults``, ``snapshot_every`` and ``telemetry`` raise
    ``NotImplementedError``: later slices of the port bring them.
    """
    _refuse_later_slices(cfg, snapshot_every, telemetry)
    if cfg.topology not in topo.TOPOLOGIES:
        raise ValueError(f"unknown topology {cfg.topology!r}")
    dev = resolve_device(device)
    X, y, m, n_i, d = _unpack_partitions(X_parts, y_parts, dev)
    counts = _partition_counts(m, n_i, n_counts)
    block_bound = _sparse_block_bound(cfg, X_parts, X)

    if cfg.max_iters <= 0:  # zero-iteration call: the initial state
        zeros = torch.zeros((m, d), dtype=torch.float32, device=dev)
        empty = np.zeros((0,), np.float32)
        return GadgetResult(W=zeros, w_consensus=zeros[0].clone(), iters=0,
                            epsilon=float("inf"), objective_trace=empty,
                            time_trace=empty.astype(np.int32), eps_trace=empty,
                            W_avg=zeros.clone(), mass_trace=empty)

    counts_i = torch.from_numpy(counts).to(dev)
    counts_f = counts_i.to(torch.float32)
    total = counts_f.sum()
    y_flat = y.reshape(m * n_i)
    valid = (torch.arange(n_i, device=dev)[None, :] < counts_i[:, None]).reshape(-1)
    if isinstance(X, tuple):  # ELL planes: the full-data pass is a gather-dot
        cols_flat, vals_flat = X[0].reshape(m * n_i, -1), X[1].reshape(m * n_i, -1)

        def objective_of(w):
            return obj.primal_objective_masked_ell(w, cols_flat, vals_flat, y_flat,
                                                   cfg.lam, valid, total)
    else:
        X_flat = X.reshape(m * n_i, d)

        def objective_of(w):
            return obj.primal_objective_masked(w, X_flat, y_flat, cfg.lam, valid, total)
    node_index = torch.arange(m, device=dev)[:, None]
    row_mask = torch.ones((cfg.batch_size,), dtype=torch.float32, device=dev)
    plan = DrawPlan(m, cfg.batch_size, cfg.gossip_rounds, cfg.topology, cfg.fused,
                    counts_i)
    draws = GeneratorDraws(cfg.seed) if draws is None else draws
    cycle = None  # a deterministic topology's uploaded cycle, when draws bring no mix

    def consensus_of(W):
        return (W * counts_f[:, None]).sum(dim=0) / total

    W = torch.zeros((m, d), dtype=torch.float32, device=dev)
    W_sum = torch.zeros_like(W)
    chunk = min(cfg.check_every, cfg.max_iters)
    obj_tr, it_tr, eps_tr, mass_tr = [], [], [], []
    t, eps, bad = 1, float("inf"), 0
    while eps >= cfg.epsilon and t <= cfg.max_iters and not bad:
        n_active = min(chunk, cfg.max_iters - t + 1)
        ids, mix = draws.take(t, n_active, plan)
        if mix is None and cycle is None:
            cycle = _mixing_cycle(cfg, m, dev)
        W_prev = W
        masses = []
        for k in range(n_active):
            Bs = mix[k] if mix is not None else cycle[(t - 1) % cycle.shape[0]]
            W, mass = _gossip_step(cfg, X, y, counts_f, total, node_index, row_mask,
                                   ids[k], W, Bs, t, block_bound)
            W_sum += W
            masses.append(mass)
            t += 1
        mass_min = torch.stack(masses).min()
        if n_active < chunk:
            # the reference scans whole chunks and counts an idle tail
            # iteration as full mass
            mass_min = torch.clamp(mass_min, max=1.0)
        w_cons = consensus_of(W)
        reading = torch.stack([
            torch.linalg.vector_norm(W - W_prev, dim=1).max(),
            objective_of(w_cons),
            mass_min,
            torch.isfinite(w_cons.sum()).to(torch.float32),
        ]).tolist()  # the chunk's one host sync
        eps = reading[0]
        obj_tr.append(reading[1])
        eps_tr.append(eps)
        mass_tr.append(reading[2])
        it_tr.append(t - 1)
        if not reading[3]:
            bad = t - 1
    if bad:
        raise NonFiniteWeightsError(bad)

    iters = t - 1
    return GadgetResult(
        W=W,
        w_consensus=consensus_of(W),
        iters=iters,
        epsilon=float(eps),
        objective_trace=np.asarray(obj_tr, np.float32),
        time_trace=np.asarray(it_tr, np.int32),
        eps_trace=np.asarray(eps_tr, np.float32),
        W_avg=W_sum / max(iters, 1),
        mass_trace=np.asarray(mass_tr, np.float32),
    )
