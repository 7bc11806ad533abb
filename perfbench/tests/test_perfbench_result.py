"""The run's result line, its refusals, the no-JAX rule, and the planted
faults that the comparison has to catch."""
from __future__ import annotations

import ast
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from perfbench import faults, run, spec

HERE = Path(run.__file__).resolve().parent
CONTRACT = ["correct", "attempted", "failed", "metrics", "device"]
CELLS = [w["name"] for w in json.loads((HERE.parent / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("traced", [False, True])
def test_result_line_has_the_contract_keys(small, traced, monkeypatch):
    cell = spec.load("reuters.m10.b1", small)
    if traced:  # no profiler of a card here: read a synthetic trace
        from perfbench import trace
        ops = [trace.Op("fleet_half_step_kernel<true>", 0.001 * i, 0.001 * i + 0.0005,
                        "half_step") for i in range(6)]
        monkeypatch.setattr(trace, "record", lambda fn, layered: (
            fn(), trace.Trace(6, 0.006, ops, [("aten::mm", 0.0, 0.006)]))[1])
    result = run.measure(cell, 5, 0.2, traced, torch.device("cpu"))
    assert set(CONTRACT) <= set(result)
    assert list(result)[-1] == "checks" and result["correct"] is True
    assert result["attempted"] > 0 and result["failed"] == 0
    want = [e["name"] for e in (cell.per_layer if traced else cell.end_to_end)]
    got = result["metrics"]
    if traced:  # the CPU has no peaks: the rooflines and the mfu read nothing
        assert set(got) == {"launches_per_iter", "idle_share"}
        assert got["launches_per_iter"]["value"] == 1.0
        assert abs(got["idle_share"]["value"] - 50.0) < 1e-6
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
        assert result["device"]["busy_s"] == pytest.approx(0.003)
    else:
        assert list(got) == want
    for m in got.values():
        assert set(m) == {"value", "unit"}
    for c in result["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(result)


def test_no_jax_check_compares_top_level_names_whole():
    assert run.forbidden_modules(["repro_torch", "repro_torch.core.gadget", "jaxtyping",
                                  "reprox", "flaxen", "numpy"]) == []
    assert run.forbidden_modules(["repro.core", "jax.numpy", "jaxlib", "flax.linen"]) == [
        "flax", "jax", "jaxlib", "repro"]


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(HERE.rglob("*.py")), ids=lambda p: p.name)
def test_nothing_imports_jax_or_reads_the_old_benchmarks(path):
    assert not _imports(path) & {"jax", "jaxlib", "flax", "repro", "benchmarks"}
    assert "bench" "marks/" not in path.read_text()


@pytest.mark.parametrize("name", ["reference.py", "threefry.py", "check.py", "gen.py",
                                  "cost/iteration.py"])
def test_the_yardstick_imports_nothing_of_the_program(name):
    assert "repro_torch" not in _imports(HERE / name)


def _run(args, cwd):
    return subprocess.run([sys.executable, *args], cwd=cwd, capture_output=True, text=True,
                          timeout=120)


def test_refuses_without_a_card_and_prints_nothing():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = _run(["perfbench/run.py", "--workload", "ccat.m10.b1", "--seed", "1",
                "--seconds", "1", "--trace", "0"], HERE.parent)
    assert out.returncode == 2 and out.stdout == ""


def test_refuses_without_the_program(tmp_path):
    shutil.copytree(HERE, tmp_path / "perfbench", ignore=shutil.ignore_patterns("tests"))
    shutil.copy(HERE.parent / "BENCHMARK.json", tmp_path)
    out = _run(["perfbench/run.py", "--workload", "ccat.m10.b1", "--seed", "1",
                "--seconds", "1", "--trace", "0"], tmp_path)
    assert out.returncode == 2 and out.stdout == ""


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", faults.FAULTS)
def test_a_planted_fault_is_not_correct(small, cell, fault):
    c = spec.load(cell, small)
    if not faults.applies(fault, c.traffic):  # half of one row: the mix has no such fault
        c = c._replace(traffic={**c.traffic, "batch_size": 8})
    with faults.planted(fault):
        result = run.measure(c, 2 ** 31 + 3, 0.2, False, torch.device("cpu"))
    assert result["correct"] is False
    assert any(v["value"] > v["limit"] for v in result["checks"].values())


@pytest.mark.chip
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(card, cell):
    """The reference in TF32 in the program's place, at the cell's own size
    (about a minute a cell on the card)."""
    from perfbench import check, gen, readings
    c = spec.load(cell)
    seed = 2 ** 31 + 11
    fleet, test = gen.make(c.config, c.traffic["m"], seed, card)
    s = run.settings(c, seed)
    stream = run.stream(c, fleet, s, card)
    prev = [next(stream) for _ in range(3)][-1]
    stream.close()
    assert not check.judge(readings.in_place(c, fleet, test, s, prev, low=True), c.limits)[0]
