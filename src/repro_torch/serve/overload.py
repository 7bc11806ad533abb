"""Degradation ladder: trade accuracy for latency under sustained pressure.

A copy of ``repro.serve.overload`` (the port imports nothing of ``repro``),
over the port's ``SvmServer`` and ``MicroBatcher``. The bounded queue and
deadlines protect the *server* (memory and launch work stay finite), but
under a sustained 2× offered load they do so by throwing half the traffic
away. :class:`DegradeLadder` instead makes each request cheaper:

* **rung 0** — normal service: f32 weight plane, narrowest-fit bucket
  routing.
* **rung 1** — int8 weight plane: the server swaps to the
  quantize→dequantize image of the live weights
  (``SvmServer.set_plane("int8")``), what an int8 export would serve.
* **rung 2** — int8 plane + cheapest bucket: the batcher routes everything
  to its narrowest rung (``MicroBatcher.degrade_to``), truncating wide
  queries to their largest-|value| features: smaller pad planes, fewer
  touched blocks per launch.

Every transition changes a weight plane or a routing rule, never a served
shape: pre-build the int8 plane with :meth:`DegradeLadder.prepare` and warm
each bucket, and ``stats()["distinct_shapes"]`` stays flat across the whole
ladder.

The **pressure signal** combines the bounded queue (occupancy fraction) with
the latency histograms (p99 against an optional SLO); **hysteresis** comes
from two watermarks plus a patience count: the ladder steps only after
``patience`` consecutive observations beyond a watermark, so one bursty
drain cannot flap the model quality. Telemetry: ``serve.degrade_steps{
direction=down|up}`` counters and a ``serve.degrade_rung`` gauge on the
server's registry, beside the ``serve.degraded`` flag ``set_plane`` keeps.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.serve.batcher import MicroBatcher
from repro_torch.serve.engine import SvmServer
from repro_torch.telemetry import trace as tmtr

__all__ = ["DegradeLadder"]


@dataclass
class DegradeLadder:
    """Hysteretic controller stepping a server/batcher pair down the overload
    ladder and back.

    Call :meth:`observe` between drains (the same cadence as
    ``SvmServer.maybe_reload``). Pressure ≥ ``high`` for ``patience``
    consecutive observations steps one rung down; pressure ≤ ``low`` for
    ``patience`` observations steps one rung up; anything in between resets
    both streaks (the hysteresis band). ``max_rung`` caps how far the ladder
    may degrade (2 = int8 + cheapest bucket, 1 = int8 plane only).

    ``latency_slo_ms`` (optional): fold the latency histograms into the
    pressure signal — p99 at the SLO contributes pressure 1.0, so a server
    whose queue is short but whose tail is blown still degrades. Without a
    bounded queue (``max_pending=None``) *only* the latency term can drive
    the ladder; configure at least one or :meth:`observe` is inert.

    ``trace=True`` additionally emits a traced ``serve.degrade`` event on
    every rung transition (direction + new rung) so the observatory's fate
    view can correlate degraded delivery with the transition that caused it.
    """

    server: SvmServer
    batcher: MicroBatcher
    high: float = 0.75
    low: float = 0.25
    patience: int = 2
    max_rung: int = 2
    latency_slo_ms: float | None = None
    trace: bool = False
    rung: int = 0
    _above: int = field(default=0, repr=False)
    _below: int = field(default=0, repr=False)

    def __post_init__(self):
        if not 0.0 <= self.low < self.high:
            raise ValueError(f"need 0 <= low < high, got low={self.low} "
                             f"high={self.high}")
        if self.patience < 1:
            raise ValueError(f"patience must be >= 1, got {self.patience}")
        if not 0 <= self.max_rung <= 2:
            raise ValueError(f"max_rung must be 0..2, got {self.max_rung}")
        if self.latency_slo_ms is not None and self.latency_slo_ms <= 0:
            raise ValueError(
                f"latency_slo_ms must be > 0, got {self.latency_slo_ms}")

    def prepare(self) -> None:
        """Pre-build the degraded weight plane so the first mid-overload
        step-down costs a dict lookup, not a quantization pass. (Warm-up is
        per bucket shape and happens wherever the serving loop warms its
        buckets; the ladder adds no new shapes.)"""
        self.server.set_plane("int8")
        self.server.set_plane("f32")

    def pressure(self) -> float:
        """Instantaneous pressure in [0, ∞): max of queue occupancy
        (pending / max_pending) and p99 latency / SLO (when configured).
        1.0 means "at the configured limit"."""
        p = 0.0
        if self.batcher.max_pending:
            p = self.batcher.pending / self.batcher.max_pending
        if self.latency_slo_ms is not None:
            h = self.batcher.registry.get("serve.latency_seconds",
                                          bucket="all")
            if h is not None and h.count:
                p = max(p, float(h.quantile(0.99)) * 1e3 / self.latency_slo_ms)
        return p

    def observe(self) -> int:
        """One control step: read the pressure, update the hysteresis
        streaks, apply at most one rung transition. Returns the current
        rung (0 = full service)."""
        p = self.pressure()
        if p >= self.high:
            self._above += 1
            self._below = 0
        elif p <= self.low:
            self._below += 1
            self._above = 0
        else:
            self._above = self._below = 0
        if self._above >= self.patience and self.rung < self.max_rung:
            self.rung += 1
            self._above = 0
            self._apply("down")
        elif self._below >= self.patience and self.rung > 0:
            self.rung -= 1
            self._below = 0
            self._apply("up")
        return self.rung

    def _apply(self, direction: str) -> None:
        """Install the current rung on the server/batcher pair."""
        self.server.set_plane("int8" if self.rung >= 1 else "f32")
        self.batcher.degrade_to(
            self.batcher.buckets[0] if self.rung >= 2 else None)
        reg = self.server.registry
        reg.counter("serve.degrade_steps", direction=direction).inc()
        reg.gauge("serve.degrade_rung").set(float(self.rung))
        if self.trace:
            tmtr.emit_event(reg, "serve.degrade", tmtr.TraceContext.new(),
                            direction=direction, rung=self.rung)
