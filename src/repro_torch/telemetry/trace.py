"""Causal tracing: explicit-propagation trace contexts over the registry.

The lineage pieces of ``repro.telemetry.trace`` that the serving engine
uses, copied (the port imports nothing of ``repro``): a
:class:`TraceContext` is an immutable ``(trace_id, span_id, parent_id)``
triple passed explicitly across thread and process boundaries (a checkpoint
manifest carries it as ``extra["trace"]``), and :func:`emit_span` /
:func:`emit_event` write ``span`` / ``event`` records, trace ids at the top
level, to the registry's sink, and :class:`TracedSpan` times a block into
such a span, on the exception path too. ``SvmServer`` emits ``serve.swap`` when it
installs a traced checkpoint and ``serve.first_score`` at the first scoring
call after it, the serve-side end of a version's lineage chain.
"""
from __future__ import annotations

import secrets
from typing import NamedTuple, Optional

from repro_torch.telemetry.registry import Registry

__all__ = ["TraceContext", "TracedSpan", "emit_span", "emit_event"]


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
              seconds: float, **attrs) -> None:
    """Record one completed traced span: observes ``seconds`` into the
    histogram ``name`` and emits a ``span`` record (trace ids at top level,
    ``attrs`` under ``fields``) to the registry's sink."""
    registry.histogram(name).observe(seconds)
    registry.emit({"kind": "span", "name": name, "labels": {},
                   "seconds": float(seconds), **_trace_fields(ctx),
                   "fields": {k: v for k, v in attrs.items() if v is not None}})


def emit_event(registry: Registry, name: str, ctx: TraceContext,
               **attrs) -> None:
    """Emit an instantaneous traced ``event`` record (a point on the chain
    with no duration, e.g. ``publish.visible``)."""
    registry.emit({"kind": "event", "name": name, "labels": {},
                   **_trace_fields(ctx),
                   "fields": {k: v for k, v in attrs.items() if v is not None}})


class TracedSpan:
    """Context manager timing one phase into a traced span. Like the
    registry's ``Span`` but it carries a :class:`TraceContext` and closes on
    the exception path too: a raise inside the block still observes the
    histogram and emits the span record, with an ``error`` attribute naming
    the exception."""

    def __init__(self, registry: Registry, name: str, ctx: TraceContext, **attrs):
        self.registry = registry
        self.name = name
        self.ctx = ctx
        self.attrs = dict(attrs)
        self.seconds: Optional[float] = None
        self._t0: Optional[float] = None

    def __enter__(self) -> "TracedSpan":
        self._t0 = self.registry.clock()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.seconds = self.registry.clock() - self._t0
        if exc_type is not None:
            self.attrs.setdefault("error", f"{exc_type.__name__}: {exc}")
        emit_span(self.registry, self.name, self.ctx, self.seconds, **self.attrs)
