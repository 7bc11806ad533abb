"""Pytest settings of the benchmark's own tests: the ``chip`` marker, for
tests that need a CUDA card (run them on the card with
``python -m pytest perfbench/tests -m chip``), and the fixtures that build a
benchmark root at small sizes."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card; skipped without one")


@pytest.fixture
def card():
    """The CUDA device; skips the test where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def small_root(tmp: Path) -> Path:
    """A copy of the benchmark with every configuration and mix file cut to
    the sizes its own ``cpu_cut`` states; every other key as it is."""
    shutil.copytree(ROOT / "perfbench", tmp / "perfbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    for folder in ("configs", "traffic"):
        for f in (tmp / "perfbench" / folder).glob("*.json"):
            data = json.loads(f.read_text())
            data.update(data["cpu_cut"])
            f.write_text(json.dumps(data))
    return tmp


@pytest.fixture
def small(tmp_path) -> Path:
    return small_root(tmp_path)
