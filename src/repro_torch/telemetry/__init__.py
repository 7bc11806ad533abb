"""Telemetry for the port: the metrics registry (a copy of the reference's)
and the lineage pieces of causal tracing the serving engine emits."""
from repro_torch.telemetry.registry import (  # noqa: F401
    Counter, Gauge, Histogram, Registry, Span, counter, default_registry, gauge,
    histogram, reset, span,
)
from repro_torch.telemetry.trace import TraceContext, emit_event, emit_span  # noqa: F401
