"""Causal tracing: explicit-propagation trace contexts over the registry.

A copy of ``repro.telemetry.trace`` (the port imports nothing of
``repro``). The registry says *what* the system did; this module records
*why*: which training segment produced which checkpoint, which server swap
picked it up, which query met which fate. A :class:`TraceContext` is an
immutable ``(trace_id, span_id, parent_id)`` triple passed **explicitly**
across the trainer, publisher, watch and drain thread boundaries (each of
those threads would see its own thread-local, so ambient context cannot
work here).

Two record families ride the registry's JSONL sink:

* **Version lineage**, one trace per published model version:
  ``train.segment`` (root, emitted by ``gadget_train_stream``) →
  ``publish.seconds`` + per-attempt ``publish.attempt`` spans
  (:class:`~repro_torch.serve.publisher.TrainPublisher`) →
  ``publish.visible`` (the ``LATEST`` pointer handoff; the publisher moves
  the pointer only after this record, so swap timestamps follow it) →
  ``serve.swap`` (:meth:`~repro_torch.serve.engine.SvmServer.maybe_reload`,
  linked through the checkpoint manifest ``extra["trace"]``) →
  ``serve.first_score`` (the first scoring under the new plane).
  ``python -m repro_torch.telemetry.trace <jsonl> --version N`` prints the
  chain with per-hop latencies.
* **Request fates**: :class:`RequestTracer` samples ``MicroBatcher``
  submissions and emits one ``serve.request`` span per sampled request
  whose terminal attributes are its typed fate (``delivered`` / ``shed`` /
  ``rejected`` / ``deadline``), the bucket it ran in and the degrade rung
  at the time. Retention is a reservoir, so a 50k-request soak holds
  O(reservoir) memory.

Span records carry ``trace_id`` / ``span_id`` / ``parent_id`` at the top
level, next to ``kind`` and ``name``, and ``start`` beside the ``ts`` of
their end, both ``time.time()``: the torch profiler's clock, so the lineage
lines up with a device trace.
"""
from __future__ import annotations

import argparse
import random
import secrets
import sys
import threading
import time
from typing import NamedTuple, Optional

from repro_torch.telemetry.registry import Registry, default_registry

__all__ = [
    "TraceContext",
    "TracedSpan",
    "emit_span",
    "emit_event",
    "RequestTracer",
    "LINEAGE_NAMES",
    "lineage_chains",
    "format_chain",
]

# Lineage chain members in causal order. ``publish.attempt`` spans are
# children of ``publish.seconds`` and annotate (retries) rather than extend
# the chain, so they are not chain stages.
LINEAGE_NAMES = ("train.segment", "publish.seconds", "publish.visible",
                 "serve.swap", "serve.first_score")
# The hops a *complete* chain must contain (``publish.visible`` collapses
# into the publish stage when absent — old streams — but the four below are
# mandatory).
_REQUIRED = ("train.segment", "publish.seconds", "serve.swap",
             "serve.first_score")


def _gen_id() -> str:
    """16-hex-char random id (64 bits — collision-safe at trace volume)."""
    return secrets.token_hex(8)


class TraceContext(NamedTuple):
    """Immutable causal coordinates for one span.

    ``trace_id`` groups every span of one causal story (one model version's
    life, one request's life); ``span_id`` names this span; ``parent_id`` is
    the ``span_id`` of the causally-preceding span (None for roots).
    Propagation is always explicit — pass the context object across thread
    boundaries, derive children with :meth:`child`.
    """

    trace_id: str
    span_id: str
    parent_id: Optional[str] = None

    @classmethod
    def new(cls) -> "TraceContext":
        """Fresh root context (new trace_id, no parent)."""
        return cls(trace_id=_gen_id(), span_id=_gen_id(), parent_id=None)

    def child(self) -> "TraceContext":
        """Context for a span caused by this one (same trace, new span id,
        parent set to this span)."""
        return TraceContext(self.trace_id, _gen_id(), self.span_id)

    def to_extra(self) -> dict:
        """JSON-ready dict for embedding in a checkpoint manifest
        (``extra["trace"]``) — the cross-process propagation format."""
        return {"trace_id": self.trace_id, "span_id": self.span_id,
                "parent_id": self.parent_id}

    @classmethod
    def from_extra(cls, extra) -> Optional["TraceContext"]:
        """Rebuild a context from a manifest ``extra["trace"]`` dict; None
        when the dict is absent or malformed (untraced checkpoint)."""
        if not isinstance(extra, dict):
            return None
        tid, sid = extra.get("trace_id"), extra.get("span_id")
        if not (isinstance(tid, str) and tid and isinstance(sid, str) and sid):
            return None
        return cls(tid, sid, extra.get("parent_id"))


def _trace_fields(ctx: TraceContext) -> dict:
    fields = {"trace_id": ctx.trace_id, "span_id": ctx.span_id}
    if ctx.parent_id is not None:
        fields["parent_id"] = ctx.parent_id
    return fields


def emit_span(registry: Registry, name: str, ctx: TraceContext,
              seconds: float, *, start: float | None = None, **attrs) -> None:
    """Record one completed traced span: observes ``seconds`` into the
    histogram ``name`` and emits a ``span`` record (trace ids at top level,
    ``attrs`` under ``fields``) to the registry's sink. The record's
    ``start`` is ``start`` (``time.time()`` at the span's start), or now
    less ``seconds``: the clock of its ``ts`` and of the torch profiler's
    trace."""
    registry.histogram(name).observe(seconds)
    registry.emit({"kind": "span", "name": name, "labels": {},
                   "seconds": float(seconds),
                   "start": time.time() - float(seconds) if start is None else start,
                   **_trace_fields(ctx),
                   "fields": {k: v for k, v in attrs.items() if v is not None}})


def emit_event(registry: Registry, name: str, ctx: TraceContext,
               **attrs) -> None:
    """Emit an instantaneous traced ``event`` record (a point on the chain
    with no duration, e.g. ``publish.visible``)."""
    registry.emit({"kind": "event", "name": name, "labels": {},
                   **_trace_fields(ctx),
                   "fields": {k: v for k, v in attrs.items() if v is not None}})


class TracedSpan:
    """Context manager timing one phase into a traced span.

    Like :class:`~repro_torch.telemetry.registry.Span` but carries a
    :class:`TraceContext` and — critically — closes on the exception path
    too: a raise inside the block still observes the histogram and emits the
    span record, with an ``error`` attribute naming the exception.
    """

    def __init__(self, registry: Registry, name: str, ctx: TraceContext,
                 **attrs):
        self.registry = registry
        self.name = name
        self.ctx = ctx
        self.attrs = dict(attrs)
        self.seconds: Optional[float] = None
        self._t0: Optional[float] = None
        self._start: Optional[float] = None

    def __enter__(self) -> "TracedSpan":
        self._t0, self._start = self.registry.clock(), time.time()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.seconds = self.registry.clock() - self._t0
        if exc_type is not None:
            self.attrs.setdefault("error", f"{exc_type.__name__}: {exc}")
        emit_span(self.registry, self.name, self.ctx, self.seconds,
                  start=self._start, **self.attrs)


class RequestTracer:
    """Sampled per-request fate traces for the micro-batcher.

    ``sample`` is the fraction of submissions traced (1.0 = all, 0.0 = off —
    the batcher's hot path then does nothing beyond one predicate). Each
    traced request gets a root :class:`TraceContext` at submit; its terminal
    fate (``delivered`` / ``shed`` / ``deadline`` / ``rejected``) closes the
    span with the bucket and degrade rung at execution. Completed fate
    records are retained in a fixed-size **reservoir** (uniform over all
    completions), so memory is O(``reservoir``) regardless of soak length;
    exact totals ride the ``trace.requests`` counter and the per-fate
    ``trace.fate{fate=...}`` counters.

    Thread-safe: submit happens on caller threads, delivery on the drain
    thread, expiry under the batcher lock.
    """

    def __init__(self, registry: Optional[Registry] = None, *,
                 sample: float = 1.0, reservoir: int = 256, seed: int = 0,
                 clock=time.monotonic):
        if not (0.0 <= sample <= 1.0):
            raise ValueError(f"sample must be in [0, 1], got {sample}")
        if reservoir < 1:
            raise ValueError(f"reservoir must be >= 1, got {reservoir}")
        self.registry = default_registry() if registry is None else registry
        self.sample = float(sample)
        self.reservoir = int(reservoir)
        self.clock = clock
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self._live: dict[int, tuple[TraceContext, float]] = {}
        self._kept: list[dict] = []
        self._n_done = 0

    # ------------------------------------------------------------ sampling

    def _sampled(self) -> bool:
        if self.sample >= 1.0:
            return True
        if self.sample <= 0.0:
            return False
        with self._lock:
            return self._rng.random() < self.sample

    # ------------------------------------------------------------- lifecycle

    def start(self, rid: int) -> None:
        """Begin a trace for request ``rid`` (sampling applies); call at
        successful submit."""
        if not self._sampled():
            return
        ctx = TraceContext.new()
        with self._lock:
            self._live[rid] = (ctx, self.clock())
        self.registry.counter("trace.requests").inc()

    def finish(self, rid: int, fate: str, **attrs) -> None:
        """Close request ``rid``'s trace with its terminal ``fate``; no-op
        for unsampled/unknown rids."""
        with self._lock:
            entry = self._live.pop(rid, None)
        if entry is None:
            return
        ctx, t0 = entry
        seconds = self.clock() - t0
        self.registry.counter("trace.fate", fate=fate).inc()
        emit_span(self.registry, "serve.request", ctx, seconds,
                  fate=fate, rid=rid, **attrs)
        self._retain({"rid": rid, "fate": fate, "seconds": seconds, **attrs})

    def reject(self, fate: str = "rejected", **attrs) -> None:
        """Record a submission refused at the door (no rid was assigned):
        a zero-duration root span with the rejection fate."""
        if not self._sampled():
            return
        self.registry.counter("trace.requests").inc()
        self.registry.counter("trace.fate", fate=fate).inc()
        emit_span(self.registry, "serve.request", TraceContext.new(), 0.0,
                  fate=fate, **attrs)
        self._retain({"rid": None, "fate": fate, "seconds": 0.0, **attrs})

    def _retain(self, rec: dict) -> None:
        with self._lock:
            self._n_done += 1
            if len(self._kept) < self.reservoir:
                self._kept.append(rec)
            else:
                j = self._rng.randrange(self._n_done)
                if j < self.reservoir:
                    self._kept[j] = rec

    # --------------------------------------------------------------- reads

    @property
    def pending(self) -> int:
        """Number of sampled requests submitted but not yet resolved."""
        with self._lock:
            return len(self._live)

    def sampled_fates(self) -> list[dict]:
        """Snapshot of the retained fate reservoir (uniform sample of all
        completed fates)."""
        with self._lock:
            return [dict(r) for r in self._kept]

    def fate_counts(self) -> dict[str, int]:
        """Exact per-fate completion totals from the registry counters."""
        out = {}
        for name, labels, m in self.registry.series():
            if name == "trace.fate" and m.kind == "counter":
                out[labels.get("fate", "?")] = int(m.value)
        return out


# --------------------------------------------------------------------------
# Lineage assembly (host-side, over decoded JSONL records)
# --------------------------------------------------------------------------

def _version_of(rec: dict):
    f = rec.get("fields") or {}
    for k in ("version", "step", "iteration"):
        if k in f:
            return f[k]
    return None


def lineage_chains(records) -> dict[int, dict]:
    """Assemble version-lineage chains from decoded JSONL records.

    Returns ``{version: chain}`` where each chain has ``trace_id``,
    ``events`` (``{name: record}`` for the chain stages present, first
    occurrence wins), ``attempts`` (the ``publish.attempt`` spans),
    ``complete`` (all four mandatory stages present) and ``monotone``
    (stage timestamps non-decreasing in causal order, 1 ms slack for wall
    clock steps).
    """
    by_trace: dict[str, list[dict]] = {}
    for r in records:
        tid = r.get("trace_id")
        if tid and (r.get("name") in LINEAGE_NAMES
                    or r.get("name") == "publish.attempt"):
            by_trace.setdefault(tid, []).append(r)
    chains: dict[int, dict] = {}
    for tid, recs in sorted(by_trace.items()):
        recs.sort(key=lambda r: r.get("ts", 0.0))
        events: dict[str, dict] = {}
        attempts = []
        for r in recs:
            name = r["name"]
            if name == "publish.attempt":
                attempts.append(r)
            else:
                events.setdefault(name, r)
        version = None
        for name in ("serve.swap", "publish.seconds", "train.segment"):
            if name in events:
                version = _version_of(events[name])
                if version is not None:
                    break
        if version is None:
            continue
        ts = [events[n].get("ts", 0.0) for n in LINEAGE_NAMES if n in events]
        chains[int(version)] = {
            "trace_id": tid,
            "events": events,
            "attempts": attempts,
            "complete": all(n in events for n in _REQUIRED),
            "monotone": all(b >= a - 1e-3 for a, b in zip(ts, ts[1:])),
        }
    return chains


_HOP_LABELS = {
    "train.segment": "segment-end",
    "publish.seconds": "publish",
    "publish.visible": "visible",
    "serve.swap": "swapped",
    "serve.first_score": "first-serve",
}


def format_chain(version: int, chain: dict) -> str:
    """Human-readable lineage chain for one version: the stages present, the
    per-hop latencies between them, and any publish retry attempts."""
    events = chain["events"]
    lines = [f"version {version}  trace {chain['trace_id']}"
             f"  {'complete' if chain['complete'] else 'INCOMPLETE'}"
             f"{'' if chain['monotone'] else '  NON-MONOTONE'}"]
    present = [(n, events[n]) for n in LINEAGE_NAMES if n in events]
    t_first = present[0][1].get("ts", 0.0) if present else 0.0
    for name, rec in present:
        dur = f"  ({rec['seconds'] * 1e3:.2f} ms)" if "seconds" in rec else ""
        attrs = rec.get("fields") or {}
        shown = {k: v for k, v in attrs.items() if k != "rid"}
        lines.append(f"  {_HOP_LABELS[name]:<12} +{(rec.get('ts', 0.0) - t_first) * 1e3:9.2f} ms"
                     f"{dur}  {shown}")
    for rec in chain["attempts"]:
        err = (rec.get("fields") or {}).get("error")
        lines.append(f"    attempt {(rec.get('fields') or {}).get('attempt')}"
                     f"  {'ERROR ' + str(err) if err else 'ok'}")
    hops = [f"{_HOP_LABELS[a]}→{_HOP_LABELS[b]} "
            f"{(events[b].get('ts', 0.0) - events[a].get('ts', 0.0)) * 1e3:.2f} ms"
            for (a, _), (b, _) in zip(present, present[1:])]
    if hops:
        lines.append("  hops: " + " · ".join(hops))
    return "\n".join(lines)


def main(argv=None) -> int:
    """CLI: print version-lineage chains from a telemetry JSONL file.

    Usage:
        python -m repro_torch.telemetry.trace run.jsonl [--version N]

    Without ``--version``, summarizes every chain found; with it, prints the
    full causal chain for that version (exit 1 when absent).
    """
    from repro_torch.telemetry.export import read_jsonl

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.telemetry.trace",
        description="Print train→publish→swap→serve lineage chains from a "
                    "telemetry JSONL stream.")
    ap.add_argument("path", help="JSONL file written by a JsonlSink")
    ap.add_argument("--version", type=int, default=None,
                    help="print the full chain for this model version")
    args = ap.parse_args(argv)

    chains = lineage_chains(read_jsonl(args.path))
    if not chains:
        print("no lineage chains found")
        return 1
    if args.version is not None:
        chain = chains.get(args.version)
        if chain is None:
            print(f"version {args.version} not found "
                  f"(have: {sorted(chains)})")
            return 1
        print(format_chain(args.version, chain))
        return 0
    for version in sorted(chains):
        print(format_chain(version, chains[version]))
    n_complete = sum(c["complete"] for c in chains.values())
    print(f"{len(chains)} chain(s), {n_complete} complete")
    return 0


if __name__ == "__main__":
    sys.exit(main())
