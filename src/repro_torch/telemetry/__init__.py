"""Telemetry for the port: the metrics registry (a copy of the reference's),
the training trace ring's config and decode (``train``), the per-node
health observatory, the Prometheus and JSONL exporters with the
``python -m repro_torch.telemetry.dump`` CLI, and the lineage pieces of
causal tracing that training, the publisher and the serving engine emit."""
from repro_torch.telemetry.export import (  # noqa: F401
    JsonlSink,
    dump_jsonl,
    read_jsonl,
    registry_records,
    to_prometheus,
    write_prometheus,
)
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
    TraceContext,
    TracedSpan,
    emit_event,
    emit_span,
)
from repro_torch.telemetry.train import (  # noqa: F401
    SegmentTelemetry,
    TrainTelemetry,
    TrainTrace,
    publish_trace,
    validate_telemetry,
)
