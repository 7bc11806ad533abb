"""The port's top console (``repro_torch.telemetry.top``) against the
reference: the same records render the same frame, a live registry renders
as the reference's does, and ``python -m repro_torch.telemetry.top --once``
prints the frame.

Node health is published by hand (``node.*`` gauges), so nothing here rests
on the observatory's fault flags.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro import telemetry as R_tm  # noqa: E402
from repro.telemetry import top as R_top  # noqa: E402
from repro_torch import telemetry as T_tm  # noqa: E402
from repro_torch.telemetry import top as T_top  # noqa: E402
from repro_torch.telemetry import trace as T_trace  # noqa: E402
from tests.test_torch_trace import _chain  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PKGS = {"repro": (R_tm, R_top), "repro_torch": (T_tm, T_top)}


def _fill(tm, *, nodes=True, serve=True, rung=1):
    """A registry as a faulted fleet behind a degraded server leaves it."""
    reg = tm.Registry()
    if nodes:
        for node, (dis, mass, drops, dead, straggler) in enumerate(
                [(0.01, 1.0, 3, 0, 0), (0.2, 0.7, 9, 0, 1), (0.5, 0.0, 0, 1, 0),
                 (0.02, 1.1, 4, 0, 0)] + [(0.03, 1.0, 1, 0, 0)] * 8):
            for metric, value in (("disagreement", dis), ("mass", mass), ("drops", drops),
                                  ("dead", dead), ("straggler", straggler)):
                reg.gauge(f"node.{metric}", node=str(node)).set(value)
        reg.gauge("train.mixing_rate").set(-0.0123)
        reg.gauge("train.mass_leak").set(0.0412)
    if serve:
        for name, n in (("serve.submitted", 40), ("serve.delivered", 31), ("serve.shed", 6),
                        ("serve.deadline_missed", 2), ("publish.segments", 4),
                        ("serve.swaps", 3), ("serve.reload_errors", 1)):
            reg.counter(name).inc(n)
        for fate, n in (("delivered", 31), ("shed", 6), ("deadline", 2), ("rejected", 5)):
            reg.counter("trace.fate", fate=fate).inc(n)
        reg.gauge("serve.degrade_rung").set(rung)
    return reg


def _records(path, with_chains):
    recs = T_tm.read_jsonl(str(path))
    if with_chains:
        recs = recs + [r for v in range(1, 9) for r in _chain(T_trace, v, t0=100.0 * v,
                                                                swap_ts=(1.0 if v == 6 else None))]
    return recs


@pytest.mark.parametrize("case", ["empty", "nodes", "serve", "full", "full+lineage"])
def test_render_matches_reference(tmp_path, case):
    frames = {}
    for name, (tm, top) in PKGS.items():
        reg = _fill(tm, nodes=case in ("nodes", "full", "full+lineage"),
                    serve=case in ("serve", "full", "full+lineage"))
        path = tmp_path / f"{name}.jsonl"
        tm.dump_jsonl(reg, str(path), mode="a")
        records = _records(path, case == "full+lineage")
        values = top.snapshot_values(records)
        assert values == reg.values()
        frames[name] = (top.render(values, records), top.render(values, records, lineage_tail=2),
                        top.render(values))
    assert frames["repro_torch"] == frames["repro"]
    frame = frames["repro_torch"][0]
    if case == "empty":
        assert "no node health published" in frame and "lineage needs span records" in frame
    if case == "full+lineage":
        assert "MASS LEAK 0.0412" in frame and "DEAD" in frame and "STRAGGLER" in frame
        assert "DEGRADED rung 1" in frame and "traced fates: deadline=2" in frame
        assert "v8: complete" in frame and "v6: complete NON-MONOTONE" in frame
        assert "v3:" not in frame and "v4: complete" not in frames["repro_torch"][1]
        assert "lineage needs span records" in frames["repro_torch"][2]


def test_render_registry_matches_reference():
    frames = {name: top.render_registry(_fill(tm, rung=2)) for name, (tm, top) in PKGS.items()}
    assert frames["repro_torch"] == frames["repro"]
    assert "DEGRADED rung 2" in frames["repro_torch"]
    chains = [r for v in (1, 2) for r in _chain(T_trace, v, t0=10.0 * v)]
    frames = {name: top.render_registry(_fill(tm, nodes=False), chains)
              for name, (tm, top) in PKGS.items()}
    assert frames["repro_torch"] == frames["repro"]
    assert "v2: complete  segment→serve 3000.0 ms" in frames["repro_torch"]


def test_cli_once_matches_reference(tmp_path, capsys):
    path = tmp_path / "run.jsonl"
    T_tm.dump_jsonl(_fill(T_tm), str(path), mode="a")
    with open(path, "a") as fh:
        for rec in _chain(T_trace, 5):
            fh.write(json.dumps(rec) + "\n")
    assert T_top.main([str(path), "--once"]) == 0
    out_t = capsys.readouterr().out
    assert R_top.main([str(path), "--once"]) == 0
    assert out_t == capsys.readouterr().out
    assert "=== gossip nodes ===" in out_t and "v5: complete" in out_t
    out = subprocess.run([sys.executable, "-m", "repro_torch.telemetry.top", str(path), "--once"],
                         cwd=ROOT, capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr
    assert out.stdout == out_t
