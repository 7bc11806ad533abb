"""The port's baselines and the multiclass extension against the JAX
reference, on the CPU: centralised Pegasos (its ids bit for bit, w, the
iterate average and the objective trace at 1e-5), the cutting-plane SVM and
SVM-SGD (1e-6), and one-vs-rest GADGET (W at 1e-5 of
max(1, max |W|): without the projection W grows to about 60, the same draws
through the port's Threefry streams) with its prediction."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import cutting_plane as R_cp  # noqa: E402
from repro.core import gadget as G  # noqa: E402
from repro.core import multiclass as R_mc  # noqa: E402
from repro.core import pegasos as R_peg  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import cutting_plane as T_cp  # noqa: E402
from repro_torch.core import gadget as TG  # noqa: E402
from repro_torch.core import multiclass as T_mc  # noqa: E402
from repro_torch.core import pegasos as T_peg  # noqa: E402
from tests.conftest import make_separable  # noqa: E402

ATOL = 1e-5


def _separable(n=400, d=24, seed=0):
    X, y, _ = make_separable(n=n, d=d, noise=0.05, seed=seed)
    return X / np.sqrt(d), y


def _make_multiclass(n, d, C, seed=0):
    """tests/test_multiclass.py's generator: Gaussian class centres ×3 plus
    unit noise."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(C, d)) * 3.0
    y = rng.integers(0, C, size=n)
    X = centers[y] + rng.normal(size=(n, d))
    return X.astype(np.float32), y.astype(np.int32)


# ------------------------------------------------------------------ Pegasos


@pytest.mark.parametrize("seed,n,k", [(0, 400, 1), (3, 400, 8), (11, 37, 5)])
def test_pegasos_ids_bit_for_bit(seed, n, k):
    T = 50
    got = T_peg._batch_ids(seed, T, n, k, torch.device("cpu")).numpy()
    key0 = jax.random.PRNGKey(seed)
    want = np.stack([np.asarray(R_peg._batch_ids(jax.random.fold_in(key0, t), n, k))
                     for t in range(1, T + 1)])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("batch_size,trace_every", [(1, 0), (8, 10), (4, 7)])
def test_pegasos_matches_reference(batch_size, trace_every):
    X, y = _separable()
    lam, T = 1e-2, 120
    ref = R_peg.pegasos_train(jnp.asarray(X), jnp.asarray(y), lam, T, batch_size=batch_size,
                              seed=2, trace_every=trace_every)
    port = T_peg.pegasos_train(X, y, lam, T, batch_size=batch_size, seed=2,
                               trace_every=trace_every, device="cpu")
    np.testing.assert_allclose(port.w.numpy(), np.asarray(ref.w), atol=ATOL)
    np.testing.assert_allclose(port.w_avg.numpy(), np.asarray(ref.w_avg), atol=ATOL)
    np.testing.assert_allclose(port.objective.numpy(), np.asarray(ref.objective),
                               rtol=ATOL, atol=ATOL, equal_nan=True)
    np.testing.assert_allclose(T_peg.pegasos_objective_trace(port).numpy(),
                               np.asarray(R_peg.pegasos_objective_trace(ref)), rtol=ATOL)


def test_pegasos_needs_a_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    X, y = _separable(n=20)
    with pytest.raises(RuntimeError):
        T_peg.pegasos_train(X, y, 1e-2, 3)


# ------------------------------------------------------ cutting plane, SGD


@pytest.mark.parametrize("seed", [0, 1])
def test_cutting_plane_equals_reference(seed):
    X, y = _separable(n=300, d=16, seed=seed)
    ref = R_cp.cutting_plane_svm(X, y, 1e-2, max_cuts=25)
    port = T_cp.cutting_plane_svm(X, y, 1e-2, max_cuts=25, device="cpu")
    np.testing.assert_allclose(port.w.numpy(), ref.w, atol=1e-6)
    assert port.n_cuts == ref.n_cuts
    assert abs(port.gap - ref.gap) <= 1e-6 and abs(port.objective - ref.objective) <= 1e-6


@pytest.mark.parametrize("seed", [0, 4])
def test_svm_sgd_equals_reference(seed):
    X, y = _separable(n=200, d=12, seed=seed)
    np.testing.assert_allclose(T_cp.svm_sgd(X, y, 1e-2, n_epochs=2, seed=seed,
                                            device="cpu").numpy(),
                               R_cp.svm_sgd(X, y, 1e-2, n_epochs=2, seed=seed), atol=1e-6)


def test_project_capped_simplex_equals_reference():
    rng = np.random.default_rng(0)
    for scale in (0.1, 1.0, 5.0):
        a = rng.normal(size=9) * scale
        np.testing.assert_allclose(T_cp._project_capped_simplex(torch.from_numpy(a)).numpy(),
                                   R_cp._project_capped_simplex(a), atol=1e-12)


# --------------------------------------------------------------- multiclass


def _multiclass_parts(m=4, n_i=30, d=16, C=3, seed=0):
    X, y = _make_multiclass(m * n_i + 60, d, C, seed=seed)
    return X[:m * n_i].reshape(m, n_i, d), y[:m * n_i].reshape(m, n_i), X[m * n_i:], y[m * n_i:]


@pytest.mark.parametrize("topology,check_every,project", [
    ("random", 20, True), ("exponential", 25, True), ("ring", 60, False)])
def test_multiclass_matches_reference(topology, check_every, project):
    Xp, yp, Xte, _ = _multiclass_parts()
    common = dict(lam=1e-3, batch_size=4, gossip_rounds=2, topology=topology, epsilon=0.0,
                  check_every=check_every, max_iters=60, seed=3,
                  project_before_gossip=project)
    ref = R_mc.gadget_train_multiclass(jnp.asarray(Xp), jnp.asarray(yp), 3,
                                       G.GadgetConfig(**common))
    port = T_mc.gadget_train_multiclass(Xp, yp, 3, TG.GadgetConfig(**common), device="cpu")
    assert port.iters == ref.iters == 60
    tol = ATOL * max(1.0, float(np.abs(np.asarray(ref.W)).max()))
    np.testing.assert_allclose(port.W.numpy(), np.asarray(ref.W), atol=tol)
    np.testing.assert_allclose(port.w_consensus.numpy(), np.asarray(ref.w_consensus), atol=tol)
    want = np.asarray(R_mc.predict_multiclass(ref.w_consensus, jnp.asarray(Xte),
                                              use_kernels=False))
    Xt = torch.from_numpy(Xte)
    for use_kernels in (None, False):
        got = T_mc.predict_multiclass(port.w_consensus, Xt, use_kernels=use_kernels)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def test_multiclass_epsilon_stop_matches_reference():
    Xp, yp, _, _ = _multiclass_parts(seed=1)
    common = dict(lam=1e-1, batch_size=4, gossip_rounds=2, topology="exponential", epsilon=5e-2,
                  check_every=10, max_iters=200, seed=0)
    ref = R_mc.gadget_train_multiclass(jnp.asarray(Xp), jnp.asarray(yp), 3,
                                       G.GadgetConfig(**common))
    port = T_mc.gadget_train_multiclass(Xp, yp, 3, TG.GadgetConfig(**common), device="cpu")
    assert port.iters == ref.iters < 200
    np.testing.assert_allclose(port.W.numpy(), np.asarray(ref.W), atol=ATOL)


def test_multiclass_result_converts():
    Xp, yp, _, _ = _multiclass_parts()
    res = T_mc.gadget_train_multiclass(Xp, yp, 3, TG.GadgetConfig(max_iters=5, check_every=5),
                                       device="cpu")
    out = convert.result_to_torch(res, device="cpu")
    assert torch.equal(out["W"], res.W) and torch.equal(out["w_consensus"], res.w_consensus)
    assert out["W_avg"] is None


def test_multiclass_random_rounds_carry_no_mass():
    """The reference's multiclass mixes ``Bs[r].T @ flat`` with no Push-Sum
    mass weights, and the port keeps that for parity. The paper's random
    one-neighbour matrices are not doubly stochastic, so the mix of a
    constant plane is not constant: node values are not averages (binary
    GADGET divides by the weights and is not affected)."""
    from repro.core.push_sum import PushSumSim as RefSim
    from repro_torch.core.push_sum import PushSumSim
    m = 8
    B_ref, B = RefSim(m, "random", seed=0).matrix(3), PushSumSim(m, "random", seed=0).matrix(3)
    np.testing.assert_array_equal(B, B_ref)
    mixed = torch.from_numpy(B).T @ torch.ones(m, 4, dtype=torch.float64)
    assert not torch.allclose(mixed, torch.ones_like(mixed))
    np.testing.assert_allclose(float(mixed.sum()), m * 4)  # mass is conserved all the same
