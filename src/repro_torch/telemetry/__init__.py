"""Telemetry for the port: the metrics registry (a copy of the reference's),
the training trace ring's config and decode (``train``), the per-node
health observatory, the Prometheus and JSONL exporters with the
``python -m repro_torch.telemetry.dump`` CLI, causal tracing (lineage
spans, :class:`RequestTracer`, :func:`lineage_chains` and the
``python -m repro_torch.telemetry.trace`` CLI), the
``python -m repro_torch.telemetry.top`` console and the profiler ranges of
the training loop (:func:`region`)."""
from repro_torch.telemetry.export import (  # noqa: F401
    JsonlSink,
    dump_jsonl,
    read_jsonl,
    registry_records,
    to_prometheus,
    write_prometheus,
)
from repro_torch.telemetry.ranges import region  # noqa: F401
from repro_torch.telemetry.registry import (  # noqa: F401
    Counter, Gauge, Histogram, Registry, Span, counter, default_registry, gauge,
    histogram, reset, span,
)
from repro_torch.telemetry.observatory import (  # noqa: F401
    NodeHealth,
    ObservatoryReport,
    analyze,
    publish_node_health,
)
from repro_torch.telemetry.trace import (  # noqa: F401
    RequestTracer,
    TraceContext,
    TracedSpan,
    emit_event,
    emit_span,
    format_chain,
    lineage_chains,
)
from repro_torch.telemetry.train import (  # noqa: F401
    SegmentTelemetry,
    TrainTelemetry,
    TrainTrace,
    publish_trace,
    validate_telemetry,
)

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "Registry",
    "Span",
    "counter",
    "default_registry",
    "gauge",
    "histogram",
    "reset",
    "span",
    "JsonlSink",
    "dump_jsonl",
    "read_jsonl",
    "registry_records",
    "to_prometheus",
    "write_prometheus",
    "SegmentTelemetry",
    "TrainTelemetry",
    "TrainTrace",
    "publish_trace",
    "validate_telemetry",
    "TraceContext",
    "TracedSpan",
    "RequestTracer",
    "emit_span",
    "emit_event",
    "lineage_chains",
    "format_chain",
    "NodeHealth",
    "ObservatoryReport",
    "analyze",
    "publish_node_health",
    "region",
]
