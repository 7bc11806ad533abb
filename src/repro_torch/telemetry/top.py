"""Live top-style console over the flight recorder and causal traces.

A copy of ``repro.telemetry.top`` (the port imports nothing of ``repro``).
``python -m repro_torch.telemetry.top run.jsonl`` renders a refresh-in-place
console from a telemetry JSONL file (a ``JsonlSink`` stream, periodic
``dump_jsonl`` snapshots, or both appended to one file). Three panes:

* **nodes** — the per-node health table that
  :func:`repro_torch.telemetry.observatory.publish_node_health` mirrors onto
  the registry (disagreement, mass, drops, straggler/dead flags) and the
  fleet's mixing rate;
* **serve** — request-fate accounting (submitted/delivered/shed/deadline/
  rejected, the ``trace.fate`` counters) and the degrade rung;
* **lineage** — the tail of the version-lineage chains assembled by
  :func:`repro_torch.telemetry.trace.lineage_chains` (version, completeness,
  segment→serve latency).

``--once`` prints a single frame and exits; the default loop re-reads the
file every ``--interval`` seconds and redraws in place (ANSI home+clear).
Programmatic use: :func:`render` takes decoded records directly,
:func:`render_registry` a live in-process registry.
"""
from __future__ import annotations

import argparse
import sys
import time

from repro_torch.telemetry import trace as tmtr
from repro_torch.telemetry.registry import Registry

__all__ = ["snapshot_values", "render", "render_registry", "main"]


def snapshot_values(records) -> dict[str, float]:
    """Last-write-wins flat values from counter/gauge snapshot records.

    Keys follow the registry ``values()`` convention:
    ``name`` or ``name{k=v,...}`` for labelled series.
    """
    out: dict[str, float] = {}
    for r in records:
        if r.get("kind") not in ("counter", "gauge"):
            continue
        labels = r.get("labels") or {}
        key = r["name"]
        if labels:
            inner = ",".join(f"{k}={v}" for k, v in sorted(labels.items()))
            key = f"{key}{{{inner}}}"
        out[key] = r.get("value", 0.0)
    return out


def _node_rows(values: dict[str, float]) -> list[tuple]:
    """(node, disagreement, mass, drops, flag) rows from node.* series."""
    nodes = {}
    for key, v in values.items():
        if not key.startswith("node.") or "{node=" not in key:
            continue
        metric = key[len("node."):key.index("{")]
        node = key[key.index("{node=") + 6:-1]
        nodes.setdefault(node, {})[metric] = v
    rows = []
    for node in sorted(nodes, key=lambda s: int(s) if s.isdigit() else 0):
        d = nodes[node]
        flag = ("DEAD" if d.get("dead") else
                "STRAGGLER" if d.get("straggler") else "")
        rows.append((node, d.get("disagreement", float("nan")),
                     d.get("mass", float("nan")), int(d.get("drops", 0)),
                     flag))
    return rows


def render(values: dict[str, float], records=None, *,
           lineage_tail: int = 5) -> str:
    """One console frame from flat ``values`` (+ optional full records for
    the lineage pane). Returns the frame text (no ANSI)."""
    lines = []

    def v(key, default=0.0):
        return values.get(key, default)

    rows = _node_rows(values)
    lines.append("=== gossip nodes ===")
    if rows:
        mix = values.get("train.mixing_rate")
        leak = values.get("train.mass_leak", 0.0)
        lines.append(f"  mixing rate {mix:+.4f}/iter" if mix is not None
                     else "  mixing rate n/a")
        if leak:
            lines.append(f"  MASS LEAK {leak:.4f}")
        lines.append(f"  {'node':>4} {'disagree':>10} {'mass':>8} "
                     f"{'drops':>6}  flag")
        for node, dis, mass, drops, flag in rows:
            lines.append(f"  {node:>4} {dis:>10.4f} {mass:>8.4f} "
                         f"{drops:>6d}  {flag}")
    else:
        lines.append("  (no node health published — train with "
                     "TrainTelemetry(per_node=True) and publish_node_health)")

    lines.append("=== serve fates ===")
    fates = {k[k.index("{fate=") + 6:-1]: int(val)
             for k, val in values.items() if k.startswith("trace.fate{")}
    lines.append(f"  submitted {int(v('serve.submitted'))}  "
                 f"delivered {int(v('serve.delivered'))}  "
                 f"shed {int(v('serve.shed'))}  "
                 f"deadline {int(v('serve.deadline_missed'))}")
    if fates:
        lines.append("  traced fates: " + "  ".join(
            f"{k}={fates[k]}" for k in sorted(fates)))
    rung = v("serve.degrade_rung")
    if rung:
        lines.append(f"  DEGRADED rung {int(rung)}")
    lines.append(f"  publishes {int(v('publish.segments'))}  "
                 f"swaps {int(v('serve.swaps'))}  "
                 f"reload errors {int(v('serve.reload_errors'))}")

    lines.append("=== lineage tail ===")
    if records:
        chains = tmtr.lineage_chains(records)
        for version in sorted(chains)[-lineage_tail:]:
            c = chains[version]
            events = c["events"]
            span = ""
            if "train.segment" in events and "serve.first_score" in events:
                dt = (events["serve.first_score"].get("ts", 0.0)
                      - events["train.segment"].get("ts", 0.0))
                span = f"  segment→serve {dt * 1e3:.1f} ms"
            lines.append(f"  v{version}: "
                         f"{'complete' if c['complete'] else 'incomplete'}"
                         f"{'' if c['monotone'] else ' NON-MONOTONE'}{span}")
        if not chains:
            lines.append("  (no lineage spans yet)")
    else:
        lines.append("  (lineage needs span records — stream via JsonlSink)")
    return "\n".join(lines)


def render_registry(registry: Registry, records=None, **kw) -> str:
    """Frame from a live in-process registry (counters/gauges read
    directly; pass streamed ``records`` too for the lineage pane)."""
    return render(registry.values(), records, **kw)


def main(argv=None) -> int:
    """CLI: top-style console over a telemetry JSONL file.

    Usage:
        python -m repro_torch.telemetry.top run.jsonl [--interval S] [--once]

    Redraws in place every ``--interval`` seconds (the file is re-read, so
    a live run streaming through a ``JsonlSink`` updates the frame);
    ``--once`` prints one frame and exits 0.
    """
    from repro_torch.telemetry.export import read_jsonl

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.telemetry.top",
        description="Refresh-in-place console: node health, request fates "
                    "and version lineage from a telemetry JSONL stream.")
    ap.add_argument("path", help="JSONL file (JsonlSink stream and/or "
                                 "dump_jsonl snapshots)")
    ap.add_argument("--interval", type=float, default=1.0,
                    help="seconds between redraws (default 1.0)")
    ap.add_argument("--once", action="store_true",
                    help="print one frame and exit")
    args = ap.parse_args(argv)

    while True:
        records = read_jsonl(args.path)
        frame = render(snapshot_values(records), records)
        if args.once:
            print(frame)
            return 0
        sys.stdout.write("\x1b[H\x1b[J" + frame + "\n")
        sys.stdout.flush()
        time.sleep(max(0.05, args.interval))


if __name__ == "__main__":
    sys.exit(main())
