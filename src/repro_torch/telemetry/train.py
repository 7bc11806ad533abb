"""Training telemetry: the trace ring's config and its host-side decode.

A copy of ``repro.telemetry.train`` (the port imports nothing of ``repro``;
this module is numpy and the port's registry). :class:`TrainTelemetry` is
the config accepted by ``gadget_train(..., telemetry=...)`` and
``gadget_train_stream``. When set, the training loop keeps a fixed-size
ring of device tensors (beside the snapshot ring) recording, every
``every`` iterations:

* consensus disagreement — ``max_i ||w_i - w_consensus||_2``,
* Push-Sum mass min/max over the window since the previous record,
* primal objective at the consensus iterate,
* fault-drop counts (messages lost to the :class:`~repro_torch.core.faults
  .FaultPlan`, summed over the window; 0 when fault-free).

Ring slots and record iterations are known on the host, so the ring adds
no host sync: it is read back at the run's end. ``telemetry=None`` leaves
the trajectory bit-identical (asserted in tests).

:class:`TrainTrace` is the decoded host-side result attached to
``GadgetResult.telemetry``; :func:`publish_trace` mirrors its headline
numbers onto a :class:`~repro_torch.telemetry.registry.Registry` so benches and
the dump CLI read training health from the same place as serve metrics.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

from repro_torch.telemetry.registry import default_registry

__all__ = [
    "TrainTelemetry",
    "TrainTrace",
    "SegmentTelemetry",
    "validate_telemetry",
    "decode_ring",
    "publish_trace",
]


class TrainTelemetry(NamedTuple):
    """Config for the training trace ring.

    ``every`` — record a trace point every this many iterations (>= 1).
    ``slots`` — ring capacity; when more than ``slots`` points are recorded
    the oldest are overwritten (ring semantics, like the snapshot ring).
    ``per_node`` — also carry per-node leaves: ``(slots, m)`` rings of
    per-node disagreement-to-consensus ``||w_i - w_cons||_2``, per-node
    Push-Sum mass ratio at the record iteration, and per-node fault-drop
    counts over the window (by mixing-matrix row; rows sum to the scalar
    ``drops`` series). The observatory (:mod:`repro_torch.telemetry.observatory`)
    decodes these into node-health records.
    """

    every: int = 1
    slots: int = 256
    per_node: bool = False


class TrainTrace(NamedTuple):
    """Decoded training trace: per-record arrays in iteration order.

    All arrays share length ``count`` (<= slots; ring-decoded oldest
    first). ``mass_min``/``mass_max`` are windowed extrema of the Push-Sum
    mass over the iterations since the previous record — under message-drop
    faults ``1 - mass_min`` is the leakage gauge the fault bench asserts
    on. ``drops`` counts faulted messages per window (int64, zeros when
    fault-free). ``final_disagreement`` is measured at the returned
    consensus regardless of ring cadence.

    When the ring ran with ``per_node=True`` the three ``node_*`` arrays are
    ``(count, m)`` (else None): per-node disagreement ``||w_i - w_cons||_2``
    at each record (its row-max equals ``disagreement`` exactly), the
    per-node Push-Sum mass ratio at the record iteration, and per-node
    fault drops over the window (rows sum to ``drops``).
    """

    every: int
    iterations: np.ndarray
    disagreement: np.ndarray
    mass_min: np.ndarray
    mass_max: np.ndarray
    objective: np.ndarray
    drops: np.ndarray
    final_iteration: int
    final_disagreement: float
    node_disagreement: Optional[np.ndarray] = None
    node_mass: Optional[np.ndarray] = None
    node_drops: Optional[np.ndarray] = None

    @property
    def count(self) -> int:
        """Number of trace points retained in the ring."""
        return int(self.iterations.shape[0])


class SegmentTelemetry(NamedTuple):
    """Per-segment telemetry from ``gadget_train_stream``.

    One record per published segment: disagreement and objective are
    measured at the segment boundary; mass/drops aggregate over the
    segment's active iterations (mass extrema are NaN for segments that
    run zero active iterations).
    """

    disagreement: float
    mass_min: float
    mass_max: float
    objective: float
    drops: int


def validate_telemetry(telemetry: Optional[TrainTelemetry]) -> Optional[TrainTelemetry]:
    """Normalize/validate a ``telemetry=`` argument.

    Accepts None (off), a :class:`TrainTelemetry`, or anything with
    ``every``/``slots`` attributes; returns a validated
    :class:`TrainTelemetry` or None.
    """
    if telemetry is None:
        return None
    every = int(getattr(telemetry, "every", 1))
    slots = int(getattr(telemetry, "slots", 256))
    per_node = bool(getattr(telemetry, "per_node", False))
    if every < 1:
        raise ValueError(f"telemetry.every must be >= 1, got {every}")
    if slots < 1:
        raise ValueError(f"telemetry.slots must be >= 1, got {slots}")
    return TrainTelemetry(every=every, slots=slots, per_node=per_node)


def _ring_order(count: int, slots: int) -> np.ndarray:
    """Indices that reorder a ring written ``count`` times (slot ``i %
    slots``) into oldest-first retained order."""
    kept = min(count, slots)
    start = count % slots if count > slots else 0
    return (start + np.arange(kept)) % slots


def decode_ring(every: int, slots: int, count: int, iterations, disagreement,
                mass_min, mass_max, objective, drops,
                final_iteration: int, final_disagreement: float,
                node_disagreement=None, node_mass=None,
                node_drops=None) -> TrainTrace:
    """Assemble a :class:`TrainTrace` from raw device ring arrays; the three
    optional ``node_*`` arguments are the ``(slots, m)`` per-node rings
    (decoded with the same ring order) when the run carried them."""
    order = _ring_order(int(count), slots)
    return TrainTrace(
        every=every,
        iterations=np.asarray(iterations)[order].astype(np.int64),
        disagreement=np.asarray(disagreement)[order].astype(np.float64),
        mass_min=np.asarray(mass_min)[order].astype(np.float64),
        mass_max=np.asarray(mass_max)[order].astype(np.float64),
        objective=np.asarray(objective)[order].astype(np.float64),
        drops=np.asarray(drops)[order].astype(np.int64),
        final_iteration=int(final_iteration),
        final_disagreement=float(final_disagreement),
        node_disagreement=(None if node_disagreement is None else
                           np.asarray(node_disagreement)[order].astype(np.float64)),
        node_mass=(None if node_mass is None else
                   np.asarray(node_mass)[order].astype(np.float64)),
        node_drops=(None if node_drops is None else
                    np.asarray(node_drops)[order].astype(np.int64)),
    )


def publish_trace(trace: TrainTrace, registry=None) -> None:
    """Mirror a decoded trace's headline numbers onto a registry.

    Sets ``train.final_disagreement`` / ``train.mass_min`` /
    ``train.mass_max`` / ``train.objective`` gauges and increments the
    ``train.fault_drops`` counter; no-op details (empty trace) publish
    only the final disagreement.
    """
    reg = default_registry() if registry is None else registry
    reg.gauge("train.final_disagreement").set(trace.final_disagreement)
    if trace.count:
        reg.gauge("train.objective").set(float(trace.objective[-1]))
        finite_min = trace.mass_min[np.isfinite(trace.mass_min)]
        finite_max = trace.mass_max[np.isfinite(trace.mass_max)]
        if finite_min.size:
            reg.gauge("train.mass_min").set(float(finite_min.min()))
        if finite_max.size:
            reg.gauge("train.mass_max").set(float(finite_max.max()))
        reg.counter("train.fault_drops").inc(int(trace.drops.sum()))
