"""The port's primal objective functions against ``repro.core.svm_objective``."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import svm_objective as R  # noqa: E402
from repro_torch.core import svm_objective as T  # noqa: E402

TOL = 1e-6


def _inputs(seed, n=57, d=33, scale=1.0):
    rng = np.random.default_rng(seed)
    X = (rng.normal(size=(n, d)) / np.sqrt(d)).astype(np.float32)
    y = np.where(rng.random(n) < 0.5, -1.0, 1.0).astype(np.float32)
    w = (scale * rng.normal(size=d)).astype(np.float32)
    return X, y, w


def _close(port, ref):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hinge_and_primal(seed):
    X, y, w = _inputs(seed)
    tX, ty, tw = map(torch.from_numpy, (X, y, w))
    _close(T.hinge_loss(tw, tX, ty), R.hinge_loss(w, X, y))
    _close(T.primal_objective(tw, tX, ty, 1e-3), R.primal_objective(w, X, y, 1e-3))
    _close(T.accuracy(tw, tX, ty), R.accuracy(w, X, y))


@pytest.mark.parametrize("seed", [0, 1])
def test_primal_masked(seed):
    X, y, w = _inputs(seed)
    valid = np.random.default_rng(seed + 9).random(len(y)) < 0.7
    y = np.where(valid, y, 0.0).astype(np.float32)
    total = np.float32(valid.sum())
    ref = R.primal_objective_masked(w, X, y, 1e-2, jnp.asarray(valid), total)
    port = T.primal_objective_masked(torch.from_numpy(w), torch.from_numpy(X),
                                     torch.from_numpy(y), 1e-2, torch.from_numpy(valid),
                                     torch.tensor(total))
    _close(port, ref)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_subgradient_update_projection(seed):
    X, y, w = _inputs(seed, scale=3.0)
    tX, ty, tw = map(torch.from_numpy, (X, y, w))
    _close(T.hinge_subgradient(tw, tX, ty), R.hinge_subgradient(w, X, y))
    for t in (1, 7, 250):
        _close(T.pegasos_update(tw, tX, ty, 1e-2, t), R.pegasos_update(w, X, y, 1e-2, t))
    for lam in (1e-4, 1e-2, 1.0):  # radius 100 (no-op), 10, 1 (shrinks)
        _close(T.project_ball(tw, lam), R.project_ball(w, lam))
