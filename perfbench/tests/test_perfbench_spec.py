"""The harness finds every file of a cell by name and refuses malformed ones."""
from __future__ import annotations

import hashlib
import json
import re

import pytest
import torch

from perfbench import run, spec

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
    ("perfbench/configs/ccat.json", lambda d: d.update(cpu_cut={"width": 3}), "cpu_cut"),
    ("perfbench/traffic/m10.b1.json", lambda d: d.update(cpu_cut=[6]), "cpu_cut"),
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


@pytest.mark.parametrize("path", sorted(p.relative_to(spec.HERE).as_posix() for folder in
                                        ("configs", "traffic")
                                        for p in (spec.HERE / folder).glob("*.json")))
def test_every_configuration_and_mix_states_its_cpu_cut(path):
    """The tests' small copy cuts each file by its own ``cpu_cut``: a file
    without one would run at full size on the CPU."""
    data = json.loads((spec.HERE / path).read_text())
    assert isinstance(data.get("cpu_cut"), dict) and data["cpu_cut"], path
    check = spec.check_config if path.startswith("configs/") else spec.check_traffic
    check({**data, **data["cpu_cut"]}, path)


def _digests(root):
    return {p.relative_to(root).as_posix(): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


@pytest.mark.parametrize("name, sizes", [
    ("wide", dict(n_train=2000, n_test=300, d=50000, sparsity=4e-4, col_skew=1.1,
                  class_balance=0.6, lam=5e-4)),
    # rows of 1,000 Zipf columns of 2 M, as wide as webspam's byte trigrams, cut
    ("wide_rows", dict(n_train=600, n_test=100, d=2_000_000, sparsity=5e-4, col_skew=1.25,
                       class_balance=0.39, label_noise=0.1, lam=1 / 600)),
], ids=["wide", "wide_rows"])
def test_a_later_cell_is_new_files_only(small, name, sizes):
    """A configuration, a mix and a cell added as new files and new entries of
    ``BENCHMARK.json``: no file of the benchmark changes, the cell loads by
    name with every per-layer metric, and it runs correct on the CPU."""
    here = small / "perfbench"
    before, bench = _digests(here), json.loads((small / "BENCHMARK.json").read_text())
    old = json.loads(json.dumps(bench))
    config = {**json.loads((spec.HERE / "configs/kdda.json").read_text()), "name": name, **sizes}
    config["cpu_cut"] = {"d": config["d"]}
    traffic = {"m": 6, "batch_size": 2, "gossip_rounds": 3, "topology": "exponential",
               "segment_iters": 5, "warmup_segments": 1, "cpu_cut": {"segment_iters": 5}}
    limits = json.loads((spec.HERE / "workloads/ccat.m10.b1.json").read_text())
    cell = f"{name}.m6.b2"
    (here / f"configs/{name}.json").write_text(json.dumps(config))
    (here / "traffic/m6.b2.json").write_text(json.dumps(traffic))
    (here / f"workloads/{cell}.json").write_text(json.dumps(limits))
    bench["configs"].append({"name": name, "source": "a test", "file": f"perfbench/configs/{name}.json",
                             "reduced": [], "why": "a later configuration"})
    bench["workloads"].append({"name": cell, "config": name, "traffic": "m6.b2",
                               "chips": 1, "why": "a later cell"})
    (small / "BENCHMARK.json").write_text(json.dumps(bench))

    after = _digests(here)
    assert {k: after[k] for k in before} == before
    assert set(after) - set(before) == {f"configs/{name}.json", "traffic/m6.b2.json",
                                        f"workloads/{cell}.json"}
    for key in ("configs", "workloads"):
        assert bench[key][:len(old[key])] == old[key]
    loaded = spec.load(cell, small)
    assert set(loaded.readers) == {e["name"] for e in bench["per_layer"]}
    assert {e["name"] for e in loaded.end_to_end} == {e["name"] for e in bench["end_to_end"]}
    result = run.measure(loaded, 2 ** 31 + 5, 0.2, False, torch.device("cpu"))
    assert result["correct"] and result["attempted"] > 0
    assert all(v["value"] < 1e-5 for v in result["checks"].values()), result["checks"]
