"""The port's Push-Sum simulator and exponential schedule against the JAX
reference, on the CPU. ``PushSumSim`` builds its matrices on the host from
the same ``default_rng((seed, t))`` draws, so the rounds are compared at
1e-6 (float32 matrix products in two libraries); mass is conserved every
round."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import push_sum as R  # noqa: E402
from repro_torch.core import push_sum as T  # noqa: E402

ATOL = 1e-6
TOPOLOGIES = ["exponential", "ring", "complete", "torus", "random"]


def _values(n, seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(n, 6)).astype(np.float32),
            "b": rng.normal(size=(n, 2, 3)).astype(np.float32)}


@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_matrix_equals_reference(topology):
    ref, port = R.PushSumSim(8, topology, seed=3), T.PushSumSim(8, topology, seed=3)
    for t in range(6):
        np.testing.assert_array_equal(port.matrix(t), ref.matrix(t))


@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_rounds_match_reference_and_conserve_mass(topology):
    n = 8
    vals = _values(n)
    ref, port = R.PushSumSim(n, topology, seed=1), T.PushSumSim(n, topology, seed=1)
    rs = ref.init({k: jnp.asarray(v) for k, v in vals.items()})
    ps = port.init({k: torch.from_numpy(v) for k, v in vals.items()})
    total = {k: v.sum(axis=0) for k, v in vals.items()}
    for t in range(5):
        rs, ps = ref.round(rs, t), port.round(ps, t)
        for k in vals:
            np.testing.assert_allclose(ps.values[k].numpy(), np.asarray(rs.values[k]), atol=ATOL)
            np.testing.assert_allclose(ps.values[k].numpy().sum(axis=0), total[k], atol=1e-5)
        np.testing.assert_allclose(ps.weight.numpy(), np.asarray(rs.weight), atol=ATOL)
        np.testing.assert_allclose(float(ps.weight.sum()), n, atol=1e-5)


@pytest.mark.parametrize("topology,t0", [("exponential", 0), ("random", 4), ("torus", 2)])
def test_run_estimate_matches_reference(topology, t0):
    n = 8
    vals = _values(n, seed=2)
    ref = R.PushSumSim(n, topology, seed=7).run({k: jnp.asarray(v) for k, v in vals.items()},
                                                 6, t0=t0)
    port = T.PushSumSim(n, topology, seed=7).run({k: torch.from_numpy(v)
                                                   for k, v in vals.items()}, 6, t0=t0)
    r_est, p_est = ref.estimate(), port.estimate()
    for k in vals:
        np.testing.assert_allclose(p_est[k].numpy(), np.asarray(r_est[k]), atol=1e-5)


def test_exponential_run_reaches_the_mean():
    n = 16
    x = np.random.default_rng(0).normal(size=(n, 5)).astype(np.float32)
    est = T.PushSumSim(n, "exponential").run(torch.from_numpy(x), 4).estimate()
    np.testing.assert_allclose(est.numpy(), np.broadcast_to(x.mean(axis=0), x.shape), atol=1e-5)


@pytest.mark.parametrize("topology,gamma", [("exponential", 1e-3), ("ring", 1e-2),
                                            ("complete", 1e-4), ("torus", 1e-2)])
def test_rounds_for_error_equals_reference(topology, gamma):
    assert (T.PushSumSim(16, topology).rounds_for_error(gamma)
            == R.PushSumSim(16, topology).rounds_for_error(gamma))


def test_init_and_topology_validation():
    with pytest.raises(ValueError):
        T.PushSumSim(4, "hypercube")
    with pytest.raises(ValueError):
        T.PushSumSim(4).init({"w": torch.zeros(3, 2)})


@pytest.mark.parametrize("axis_sizes", [{"nodes": 8}, {"pod": 2, "data": 4},
                                        {"a": 1, "b": 4}, {"a": 1}, {"x": 4, "y": 1, "z": 2}])
def test_exponential_schedule_equals_reference(axis_sizes):
    got = T.exponential_schedule(axis_sizes)
    want = R.exponential_schedule(axis_sizes)
    assert [(g.axis, g.hop) for g in got] == [(w.axis, w.hop) for w in want]


def test_exponential_schedule_raises_on_non_power_of_two():
    with pytest.raises(ValueError):
        R.exponential_schedule({"nodes": 6})
    with pytest.raises(ValueError):
        T.exponential_schedule({"nodes": 6})


@pytest.mark.parametrize("n,hop", [(4, 1), (8, 2), (2, 1)])
def test_ring_perm_equals_reference(n, hop):
    assert T._ring_perm(n, hop) == R._ring_perm(n, hop)
