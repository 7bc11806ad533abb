"""Gossip health observatory: per-node convergence diagnostics on host.

A copy of ``repro.telemetry.observatory`` (numpy over decoded rings; the
port imports nothing of ``repro``).

The training loop's per-node telemetry leaves (``TrainTelemetry(per_node=
True)``) come back on ``TrainTrace`` as ``(count, m)`` rings — per-node
disagreement-to-consensus, per-node Push-Sum mass ratio, per-node fault-drop
counts. This module turns those raw rings into operator-facing health
records:

* :func:`analyze` — one :class:`ObservatoryReport` per trace: the empirical
  **mixing rate** (least-squares log-slope of the fleet disagreement, the
  measured counterpart of the paper's spectral-gap convergence factor),
  per-node :class:`NodeHealth` rows, and the flagged **stragglers** (nodes
  whose final disagreement stands far above the fleet median), **dead
  nodes** (disagreement not decaying while the fleet's is — a crashed node's
  weights freeze, so its distance to the moving consensus stays put) and the
  fleet-level **mass leak** (Push-Sum mass below 1 under message-drop
  faults).
* :func:`publish_node_health` — mirror a report onto a registry as
  ``node.disagreement{node=i}`` / ``node.mass{node=i}`` /
  ``node.drops{node=i}`` series plus ``train.mixing_rate`` /
  ``train.mass_leak`` gauges, which is what ``python -m
  repro.telemetry.top`` (the reference's console) renders as its node table.

Everything here is host-side numpy over already-decoded rings; the training
loop is untouched.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from repro_torch.telemetry.registry import Registry, default_registry
from repro_torch.telemetry.train import TrainTrace

__all__ = [
    "NodeHealth",
    "ObservatoryReport",
    "analyze",
    "publish_node_health",
]


class NodeHealth(NamedTuple):
    """Health record for one gossip node, decoded from the per-node rings.

    ``disagreement``/``mass`` are at the last retained record; ``drops`` is
    the node's total faulted messages over the retained window (by
    mixing-matrix row — what this node failed to deliver). ``straggler``
    and ``dead`` are the flags :func:`analyze` raised for the node.
    """

    node: int
    disagreement: float
    mass: float
    drops: int
    straggler: bool
    dead: bool


class ObservatoryReport(NamedTuple):
    """Fleet-level health decoded from one per-node training trace.

    ``mixing_rate`` is the least-squares slope of ``log(median-over-nodes
    disagreement)`` per iteration over the retained records (negative =
    converging; the empirical twin of the gossip matrix's second-eigenvalue
    rate). The median — not the max the scalar ``disagreement`` ring uses —
    keeps one dead straggler from masking the live fleet's decay.
    ``mass_leak`` is ``max(0, 1 - min node mass)`` at the last record —
    0 under link-drop or fault-free gossip, positive when message drops
    destroyed Push-Sum mass. ``stragglers``/``dead`` list the flagged node
    ids (sorted; a dead node is not double-listed as a straggler).
    """

    nodes: tuple[NodeHealth, ...]
    mixing_rate: float
    mass_leak: float
    stragglers: tuple[int, ...]
    dead: tuple[int, ...]

    @property
    def healthy(self) -> bool:
        """True when no node is flagged and no mass leaked."""
        return not self.stragglers and not self.dead and self.mass_leak == 0.0


def _mixing_rate(iterations: np.ndarray, disagreement: np.ndarray) -> float:
    """Log-slope of the fleet disagreement per iteration (NaN when fewer
    than two positive records exist to fit)."""
    pos = disagreement > 0
    if int(pos.sum()) < 2:
        return float("nan")
    it = iterations[pos].astype(np.float64)
    if it[-1] == it[0]:
        return float("nan")
    slope = np.polyfit(it, np.log(disagreement[pos]), 1)[0]
    return float(slope)


def analyze(trace: TrainTrace, *, straggler_factor: float = 4.0,
            dead_decay: float = 0.9, fleet_decay: float = 0.5,
            mass_tol: float = 1e-3) -> ObservatoryReport:
    """Decode a per-node training trace into an :class:`ObservatoryReport`.

    ``trace`` must carry the per-node rings (train with
    ``TrainTelemetry(per_node=True)``; raises ``ValueError`` otherwise).

    Flag semantics:

    * **straggler** — final disagreement > ``straggler_factor`` × the fleet
      median (and strictly positive): the node is converging far behind its
      peers (slow link, partitioned corner of the topology, dead node).
    * **dead** — needs ≥ 2 records: the node's disagreement decayed by less
      than ``1 - dead_decay`` (last/first ≥ ``dead_decay``) while the fleet
      median decayed below ``fleet_decay`` of its start. A crashed node's
      weights freeze, so its distance to the still-moving consensus holds
      (or grows) while everyone else closes in — that divergence-in-decay is
      the signature, since a dead node sends nothing and therefore shows
      *zero* fault drops of its own.
    * **mass leak** — fleet-level: ``1 - min_i mass_i`` at the last record
      beyond ``mass_tol`` (message-drop faults destroy Push-Sum mass; link
      drops and fault-free gossip conserve it exactly).
    """
    nd, nm, ndr = (trace.node_disagreement, trace.node_mass, trace.node_drops)
    if nd is None or nm is None or ndr is None:
        raise ValueError(
            "trace carries no per-node telemetry — train with "
            "TrainTelemetry(per_node=True) to record the node rings")
    count, m = nd.shape
    if count == 0:
        return ObservatoryReport(nodes=(), mixing_rate=float("nan"),
                                 mass_leak=0.0, stragglers=(), dead=())
    final_dis = nd[-1]
    final_mass = nm[-1]
    total_drops = ndr.sum(axis=0)
    median = float(np.median(final_dis))
    stragglers = set()
    if median >= 0.0:
        for i in range(m):
            if final_dis[i] > straggler_factor * median and final_dis[i] > 0:
                stragglers.add(i)
    dead = set()
    if count >= 2:
        first_dis = nd[0]
        first_median = float(np.median(first_dis))
        fleet_decayed = (first_median > 0
                         and median < fleet_decay * first_median)
        if fleet_decayed:
            for i in range(m):
                if first_dis[i] > 0 and \
                        final_dis[i] / first_dis[i] >= dead_decay:
                    dead.add(i)
    stragglers -= dead
    leak = max(0.0, 1.0 - float(final_mass.min()))
    if leak <= mass_tol:
        leak = 0.0
    fleet_dis = np.median(nd, axis=1)
    nodes = tuple(
        NodeHealth(node=i, disagreement=float(final_dis[i]),
                   mass=float(final_mass[i]), drops=int(total_drops[i]),
                   straggler=i in stragglers, dead=i in dead)
        for i in range(m))
    return ObservatoryReport(
        nodes=nodes,
        mixing_rate=_mixing_rate(trace.iterations, fleet_dis),
        mass_leak=leak,
        stragglers=tuple(sorted(stragglers)),
        dead=tuple(sorted(dead)),
    )


def publish_node_health(report: ObservatoryReport,
                        registry: Registry | None = None) -> None:
    """Mirror a report onto a registry as per-node labelled series.

    Sets ``node.disagreement{node=i}`` / ``node.mass{node=i}`` gauges and
    ``node.drops{node=i}`` counters (set-to-total via inc from zero is
    wrong for repeat publishes, so drops ride a gauge too), plus
    ``train.mixing_rate`` / ``train.mass_leak`` and the flag gauges
    ``node.straggler{node=i}`` / ``node.dead{node=i}`` (0/1). The top
    console renders these.
    """
    reg = default_registry() if registry is None else registry
    for h in report.nodes:
        label = str(h.node)
        reg.gauge("node.disagreement", node=label).set(h.disagreement)
        reg.gauge("node.mass", node=label).set(h.mass)
        reg.gauge("node.drops", node=label).set(float(h.drops))
        reg.gauge("node.straggler", node=label).set(float(h.straggler))
        reg.gauge("node.dead", node=label).set(float(h.dead))
    if np.isfinite(report.mixing_rate):
        reg.gauge("train.mixing_rate").set(report.mixing_rate)
    reg.gauge("train.mass_leak").set(report.mass_leak)
