"""Shared test fixtures. NOTE: no XLA_FLAGS here by design — tests must see
the real single CPU device; only launch/dryrun.py forces 512 devices (in its
own subprocess, exercised by tests/test_dryrun_subprocess.py)."""
import sys

import numpy as np
import pytest

try:
    import hypothesis  # noqa: F401  — real package wins when installed (CI)
except ImportError:  # bare container: install the deterministic fallback shim
    from tests import _hypothesis_fallback as _hf

    sys.modules["hypothesis"] = _hf
    sys.modules["hypothesis.strategies"] = _hf.strategies


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card; skipped without one")


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def make_separable(n=2000, d=20, noise=0.02, seed=0):
    rng = np.random.default_rng(seed)
    w_true = rng.normal(size=d)
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = np.sign(X @ w_true).astype(np.float32)
    flip = rng.random(n) < noise
    y = np.where(flip, -y, y)
    return X, y, w_true
