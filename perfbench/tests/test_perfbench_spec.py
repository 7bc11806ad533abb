"""The harness finds every file of a cell by name and refuses malformed ones."""
from __future__ import annotations

import json
import re

import pytest

from perfbench import spec

BENCH = json.loads((spec.HERE.parent / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_benchmark_has_the_contract_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    names = [e["name"] for e in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names)) and "setup_s" in names
    for e in BENCH["end_to_end"]:
        assert set(e) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= e["bound"] <= 0.25 and e["source"] in ("host_clock", "device_trace")
    moves = {e["name"] for e in BENCH["end_to_end"]}
    for e in BENCH["per_layer"]:
        assert set(e) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert e["moves"] in moves and set(e.get("workloads", CELLS)) <= set(CELLS)
        assert not e["name"].endswith("roofline") or e["unit"] == "%"
    for e in BENCH["configs"] + BENCH["workloads"]:
        assert len(e["why"]) <= 200 and spec.NAME.match(e["name"])
    for w in BENCH["workloads"]:
        assert spec.NAME.match(w["traffic"]) and spec.NAME.match(w["config"])
    for e in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert re.fullmatch(r"[A-Za-z0-9_/%.-]{1,16}", e["unit"])


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_loads_by_name(cell):
    c = spec.load(cell)
    assert c.name == cell and c.chips == 1
    assert {e["name"] for e in c.end_to_end} == {"train_samples_per_s", "setup_s"}
    assert set(c.readers) == {e["name"] for e in c.per_layer} and c.limits
    assert all(callable(r) for r in c.readers.values())


def _corrupt(root, rel, edit):
    f = root / rel
    data = json.loads(f.read_text())
    edit(data)
    f.write_text(json.dumps(data))


@pytest.mark.parametrize("rel, edit, message", [
    ("perfbench/configs/ccat.json", lambda d: d.update(storage="csr"), "storage"),
    ("perfbench/configs/ccat.json", lambda d: d.pop("lam"), "lam"),
    ("perfbench/traffic/m10.b1.json", lambda d: d.update(topology="ring"), "topology"),
    ("perfbench/traffic/m10.b1.json", lambda d: d.update(batch_size=0), "at least 1"),
    ("perfbench/traffic/m10.b1.json",
     lambda d: d.update(faults={"drop_prob": 1.5, "drop": "link"}), "faults"),
    ("perfbench/workloads/ccat.m10.b1.json", lambda d: d.update(limits={}), "limits"),
    ("BENCHMARK.json", lambda d: d["workloads"][0].update(config="nope"), "config"),
])
def test_malformed_files_are_refused(small, rel, edit, message):
    _corrupt(small, rel, edit)
    with pytest.raises(spec.SpecError, match=message):
        spec.load("ccat.m10.b1", small)


@pytest.mark.parametrize("missing", ["perfbench/traffic/m10.b1.json",
                                     "perfbench/workloads/ccat.m10.b1.json",
                                     "perfbench/metrics/idle_share.py",
                                     "perfbench/configs/ccat.json"])
def test_a_missing_file_is_refused(small, missing):
    (small / missing).unlink()
    with pytest.raises(spec.SpecError):
        spec.load("ccat.m10.b1", small)


def test_an_unknown_cell_is_refused():
    with pytest.raises(spec.SpecError, match="no workload"):
        spec.load("ccat.m1.b1")


def test_a_later_metric_is_a_file_of_its_own(small):
    bench = json.loads((small / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "ones", "unit": "1", "better": "higher",
                               "source": "device_trace", "layer": "device",
                               "moves": "train_samples_per_s"})
    (small / "BENCHMARK.json").write_text(json.dumps(bench))
    with pytest.raises(spec.SpecError, match="no reader"):
        spec.load("reuters.m10.b1", small)
    (small / "perfbench/metrics/ones.py").write_text("def read(ctx):\n    return 1.0\n")
    assert spec.load("reuters.m10.b1", small).readers["ones"]({}) == 1.0
