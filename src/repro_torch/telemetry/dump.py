"""CLI to tail or summarize a telemetry JSONL run.

A copy of ``repro.telemetry.dump`` (the port imports nothing of ``repro``).

Usage::

    python -m repro_torch.telemetry.dump run.jsonl            # summary
    python -m repro_torch.telemetry.dump run.jsonl --tail 20  # last 20 raw lines
    python -m repro_torch.telemetry.dump run.jsonl --prometheus out.prom

The summary groups records by (kind, name): counters/gauges show their
last value, histograms show count/mean/p50/p90/p99/max reconstructed from
the bucket snapshot, spans show count and total seconds.
"""
from __future__ import annotations

import argparse
import json
import math
import sys

from repro_torch.telemetry.export import read_jsonl

__all__ = ["summarize", "main"]


def _hist_quantile(buckets, count: int, q: float, mx) -> float:
    """Quantile from a JSONL bucket snapshot (upper-edge convention,
    overflow/None bucket reports the tracked max)."""
    if not count:
        return math.nan
    target = max(1, math.ceil(q * count))
    cum = 0
    for le, c in buckets:
        cum += c
        if cum >= target:
            if le is None:
                return mx if mx is not None else math.inf
            return le
    return mx if mx is not None else math.nan


def _label_key(rec: dict) -> str:
    labels = rec.get("labels") or {}
    if not labels:
        return rec["name"]
    inner = ",".join(f"{k}={v}" for k, v in sorted(labels.items()))
    return f"{rec['name']}{{{inner}}}"


def summarize(records: list[dict]) -> list[str]:
    """Render one summary line per series (last record wins per series)."""
    last: dict[tuple, dict] = {}
    span_agg: dict[str, list] = {}
    for rec in records:
        kind = rec.get("kind")
        if kind == "span":
            agg = span_agg.setdefault(rec["name"], [0, 0.0])
            agg[0] += 1
            agg[1] += float(rec.get("seconds", 0.0))
        elif kind in ("counter", "gauge", "histogram"):
            last[(kind, _label_key(rec))] = rec
    lines = []
    for (kind, key), rec in sorted(last.items(), key=lambda kv: kv[0][1]):
        if kind == "histogram":
            count = rec.get("count", 0)
            buckets = rec.get("buckets", [])
            mean = rec.get("sum", 0.0) / count if count else math.nan
            p50 = _hist_quantile(buckets, count, 0.50, rec.get("max"))
            p90 = _hist_quantile(buckets, count, 0.90, rec.get("max"))
            p99 = _hist_quantile(buckets, count, 0.99, rec.get("max"))
            lines.append(
                f"histogram {key}: count={count} mean={mean:.6g} "
                f"p50={p50:.6g} p90={p90:.6g} p99={p99:.6g} "
                f"max={rec.get('max')}")
        else:
            lines.append(f"{kind} {key}: {rec.get('value')}")
    for name, (n, total) in sorted(span_agg.items()):
        lines.append(f"span {name}: count={n} total_seconds={total:.6g}")
    return lines


def main(argv=None) -> int:
    """Entry point for ``python -m repro_torch.telemetry.dump``."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.telemetry.dump",
        description="Tail or summarize a telemetry JSONL run.")
    ap.add_argument("path", help="telemetry JSONL file")
    ap.add_argument("--tail", type=int, metavar="N", default=0,
                    help="print the last N raw records instead of a summary")
    ap.add_argument("--prometheus", metavar="OUT", default=None,
                    help="also rebuild a registry from the last snapshot "
                         "and write Prometheus text to OUT")
    args = ap.parse_args(argv)

    records = read_jsonl(args.path)
    if args.tail:
        for rec in records[-args.tail:]:
            print(json.dumps(rec))
    else:
        for line in summarize(records):
            print(line)
        if not records:
            print("(no records)")

    if args.prometheus:
        from repro_torch.telemetry.export import write_prometheus
        from repro_torch.telemetry.registry import Registry
        reg = Registry()
        for rec in records:
            kind, name = rec.get("kind"), rec.get("name")
            labels = rec.get("labels") or {}
            if kind == "counter":
                c = reg.counter(name, **labels)
                c._value = float(rec.get("value", 0.0))
            elif kind == "gauge":
                reg.gauge(name, **labels).set(float(rec.get("value", 0.0)))
        write_prometheus(reg, args.prometheus)
        print(f"wrote {args.prometheus}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
