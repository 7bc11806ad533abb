"""Exporters for the flight recorder: Prometheus text format and JSONL.

A copy of ``repro.telemetry.export`` (standard library only; the port
imports nothing of ``repro``), writing the same text and records. Two
consumption paths out of a :class:`~repro_torch.telemetry.registry.Registry`:

* :func:`to_prometheus` renders a point-in-time scrape in the Prometheus
  text exposition format (``repro_`` prefix, counters get ``_total``,
  histograms expand to cumulative ``_bucket{le=...}`` / ``_sum`` /
  ``_count``) — paste-able into a pushgateway or served from a debug
  endpoint.
* :func:`registry_records` / :func:`dump_jsonl` snapshot every series as
  one JSON object per line, and :class:`JsonlSink` streams span/event
  records live when attached via ``registry.attach_sink``. The
  ``python -m repro_torch.telemetry.dump`` CLI reads these files back;
  ``tools/check_telemetry_schema.py`` validates them.
"""
from __future__ import annotations

import json
import math
import time

__all__ = [
    "to_prometheus",
    "write_prometheus",
    "registry_records",
    "dump_jsonl",
    "read_jsonl",
    "JsonlSink",
]

PROM_PREFIX = "repro_"


def _prom_name(name: str) -> str:
    """Metric name mangled for Prometheus: prefixed, dots to underscores."""
    return PROM_PREFIX + name.replace(".", "_").replace("-", "_")


def _prom_labels(labels: dict) -> str:
    """Render a label dict as ``{k="v",...}`` (empty string when none)."""
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _fmt(v: float) -> str:
    """Format a sample value (Prometheus spells infinity ``+Inf``)."""
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    return repr(float(v))


def to_prometheus(registry) -> str:
    """Render every series in ``registry`` as Prometheus exposition text."""
    by_name: dict[str, list] = {}
    for name, labels, metric in registry.series():
        by_name.setdefault(name, []).append((labels, metric))
    lines: list[str] = []
    for name in sorted(by_name):
        entries = by_name[name]
        kind = entries[0][1].kind
        pname = _prom_name(name)
        lines.append(f"# TYPE {pname + '_total' if kind == 'counter' else pname} {kind}")
        for labels, metric in entries:
            if kind == "counter":
                lines.append(f"{pname}_total{_prom_labels(labels)} {_fmt(metric.value)}")
            elif kind == "gauge":
                lines.append(f"{pname}{_prom_labels(labels)} {_fmt(metric.value)}")
            else:  # histogram
                cum = 0
                for j, c in enumerate(metric._counts):
                    cum += c
                    le = _fmt(metric.upper_edge(j))
                    lab = dict(labels, le=le)
                    lines.append(f"{pname}_bucket{_prom_labels(lab)} {cum}")
                lines.append(f"{pname}_sum{_prom_labels(labels)} {_fmt(metric.sum)}")
                lines.append(f"{pname}_count{_prom_labels(labels)} {metric.count}")
        lines.append("")
    return "\n".join(lines)


def write_prometheus(registry, path) -> str:
    """Write :func:`to_prometheus` output to ``path``; returns the text."""
    text = to_prometheus(registry)
    with open(path, "w") as fh:
        fh.write(text)
    return text


def registry_records(registry, ts: float | None = None) -> list[dict]:
    """Snapshot every series as JSONL-ready records.

    Record schema (validated by ``tools/check_telemetry_schema.py``): every
    record has ``ts`` (float), ``kind`` (counter/gauge/histogram/span/event),
    ``name`` (str), ``labels`` (dict). Counters and gauges add ``value``;
    histograms add ``count``/``sum``/``min``/``max``/``buckets`` (pairs of
    ``[le, count]``, ``le`` null for overflow); spans add ``seconds``.
    """
    if ts is None:
        ts = time.time()
    records = []
    for name, labels, metric in registry.series():
        rec = {"ts": ts, "kind": metric.kind, "name": name, "labels": labels}
        if metric.kind == "histogram":
            rec.update(metric.to_dict())
        else:
            rec["value"] = metric.value
        records.append(rec)
    return records


def dump_jsonl(registry, path, ts: float | None = None, mode: str = "a") -> int:
    """Append a full registry snapshot to ``path`` as JSONL; returns the
    number of records written."""
    records = registry_records(registry, ts)
    with open(path, mode) as fh:
        for rec in records:
            fh.write(json.dumps(rec) + "\n")
    return len(records)


def read_jsonl(path) -> list[dict]:
    """Parse a telemetry JSONL file back into a list of records (blank
    lines skipped)."""
    out = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


class JsonlSink:
    """Streaming sink writing one JSON object per line as events arrive.

    Attach with ``registry.attach_sink(JsonlSink(path))`` to capture spans
    and explicit ``registry.emit`` events live; call :meth:`close` (or use
    as a context manager) when done.
    """

    def __init__(self, path):
        self.path = path
        self._fh = open(path, "a")

    def emit(self, record: dict) -> None:
        """Write one record and flush (readers may be tailing the file)."""
        self._fh.write(json.dumps(record) + "\n")
        self._fh.flush()

    def close(self) -> None:
        """Close the underlying file."""
        self._fh.close()

    def __enter__(self) -> "JsonlSink":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()
