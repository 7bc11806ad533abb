"""The port's dense GADGET slice against the JAX reference, on the CPU.

The port (``repro_torch.core.gadget.gadget_train(..., device="cpu")``) runs
its kernels' plain versions; the reference runs its Pallas kernels in
interpret mode (``use_kernels=True``). Torch cannot reproduce ``jax.random``,
so the port replays the reference's own draws (``_batch_ids`` and
``_iter_mixing``) through ``RecordedDraws``. Runs are compared at a fixed
iteration count (ε = 0), never at an ε-stop.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import gadget as G  # noqa: E402
from repro.core import svm_objective as ref_obj  # noqa: E402
from repro.core import topology as ref_topo  # noqa: E402
from repro.kernels.hinge_subgrad import ops as ref_ops  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import gadget as TG  # noqa: E402
from repro_torch.core import svm_objective as t_obj  # noqa: E402
from repro_torch.kernels.hinge_subgrad import hinge_subgrad as t_hinge  # noqa: E402
from repro_torch.kernels.hinge_subgrad import ops as t_ops  # noqa: E402
from tests.conftest import make_separable  # noqa: E402

M, N_I, D, B, ITERS, CHECK = 4, 33, 200, 4, 40, 15
N_COUNTS = np.array([33, 30, 27, 33])
TOPOLOGIES = ["exponential", "ring", "complete", "torus", "random"]


def _data(seed=0, n_counts=N_COUNTS):
    """Padded non-uniform partitions: node i's rows beyond n_counts[i] are X=0, y=0."""
    rng = np.random.default_rng(seed)
    w_true = rng.normal(size=D)
    X = (rng.normal(size=(len(n_counts), N_I, D)) / np.sqrt(D)).astype(np.float32)
    y = np.sign(X @ w_true).astype(np.float32)
    y[y == 0] = 1.0
    for i, c in enumerate(n_counts):
        X[i, c:] = 0.0
        y[i, c:] = 0.0
    return X, y


def _cfg_pair(topology, fused, use_kernels=False, **kw):
    """(reference config, port config); ``use_kernels`` is the reference's
    switch between its Pallas kernels and its jnp path."""
    common = dict(lam=1e-3, batch_size=B, gossip_rounds=3, topology=topology,
                  epsilon=0.0, check_every=CHECK, max_iters=ITERS, seed=5, fused=fused)
    common.update(kw)
    return G.GadgetConfig(use_kernels=use_kernels, **common), TG.GadgetConfig(**common)


def _reference_draws(cfg, y, n_counts, T):
    """The reference's own per-iteration draws for iterations 1..T."""
    m = y.shape[0]
    data_key, mix_key = G._stream_keys(cfg.seed)
    counts = G._partition_counts(jnp.asarray(y), n_counts)
    ts = jnp.arange(1, T + 1, dtype=jnp.int32)
    ids = jax.vmap(lambda t: G._batch_ids(data_key, t, counts, cfg.batch_size))(ts)
    if cfg.topology == "random":
        stack = None
    elif cfg.fused:
        stack = jnp.asarray(ref_topo.build_product_stack(cfg.topology, m, cfg.gossip_rounds))
    else:
        stack = jnp.asarray(ref_topo.build_matrix_stack(cfg.topology, m))
    mix = jax.vmap(lambda t: G._iter_mixing(mix_key, stack, t, m, cfg.gossip_rounds,
                                            cfg.topology, cfg.fused))(ts)
    return np.asarray(ids), np.asarray(mix)


def _assert_match(ref, port):
    assert port.iters == ref.iters
    np.testing.assert_array_equal(port.time_trace, ref.time_trace)
    for name in ("W", "w_consensus", "W_avg"):
        np.testing.assert_allclose(getattr(port, name).numpy(),
                                   np.asarray(getattr(ref, name)), rtol=0, atol=1e-5,
                                   err_msg=name)
    for name in ("objective_trace", "eps_trace", "mass_trace"):
        np.testing.assert_allclose(getattr(port, name), getattr(ref, name),
                                   rtol=1e-5, atol=0, err_msg=name)
    np.testing.assert_allclose(port.epsilon, ref.epsilon, rtol=1e-5)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_trajectory_matches_reference_kernels(topology, fused):
    """Every topology, fused and unfused, non-uniform n_counts, the reference's
    Pallas kernels (interpret mode) against the port's plain versions. The
    random topology replays recorded mixing; the deterministic ones use the
    port's own uploaded cycle."""
    X, y = _data()
    rcfg, tcfg = _cfg_pair(topology, fused, use_kernels=True)
    ref = G.gadget_train(X, y, rcfg, n_counts=N_COUNTS)
    ids, mix = _reference_draws(rcfg, y, N_COUNTS, ITERS)
    draws = TG.RecordedDraws(ids, mix if topology == "random" else None)
    port = TG.gadget_train(X, y, tcfg, n_counts=N_COUNTS, device="cpu", draws=draws)
    _assert_match(ref, port)
    assert ref.time_trace.tolist() == [15, 30, 40]  # max_iters not a multiple of check_every


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_exponential_cycle_position_matches_reference(fused):
    """At m=4 every exponential product is exact averaging, whatever its
    position in the cycle; at m=6 with R=2 the three products of the cycle
    differ, so this pins which one each iteration uses."""
    counts = np.array([33, 31, 29, 33, 30, 32])
    X, y = _data(seed=5, n_counts=counts)
    rcfg, tcfg = _cfg_pair("exponential", fused, gossip_rounds=2)
    ref = G.gadget_train(X, y, rcfg, n_counts=counts)
    ids, _ = _reference_draws(rcfg, y, counts, ITERS)
    port = TG.gadget_train(X, y, tcfg, n_counts=counts, device="cpu",
                           draws=TG.RecordedDraws(ids))
    _assert_match(ref, port)


def test_trajectory_matches_reference_jnp_path():
    """The reference's pure-jnp path (use_kernels=False), with the recorded
    mixing of a deterministic topology replayed instead of the port's cycle."""
    X, y = _data(seed=1)
    rcfg, tcfg = _cfg_pair("exponential", True)
    ref = G.gadget_train(X, y, rcfg, n_counts=N_COUNTS)
    ids, mix = _reference_draws(rcfg, y, N_COUNTS, ITERS)
    port = TG.gadget_train(X, y, tcfg, n_counts=N_COUNTS, device="cpu",
                           draws=TG.RecordedDraws(ids, mix))
    _assert_match(ref, port)


def test_projections_off_match_reference():
    X, y = _data(seed=2)
    rcfg, tcfg = _cfg_pair("random", True, project_before_gossip=False,
                           project_after_gossip=False)
    ref = G.gadget_train(X, y, rcfg, n_counts=N_COUNTS)
    ids, mix = _reference_draws(rcfg, y, N_COUNTS, ITERS)
    port = TG.gadget_train(X, y, tcfg, n_counts=N_COUNTS, device="cpu",
                           draws=TG.RecordedDraws(ids, mix))
    _assert_match(ref, port)


def test_epsilon_stop_matches_reference():
    """A loose ε stops both at the same ε-check."""
    X, y = _data(seed=3)
    rcfg, tcfg = _cfg_pair("ring", True, epsilon=1e3, max_iters=400)
    ref = G.gadget_train(X, y, rcfg, n_counts=N_COUNTS)
    ids, _ = _reference_draws(rcfg, y, N_COUNTS, 400)
    port = TG.gadget_train(X, y, tcfg, n_counts=N_COUNTS, device="cpu",
                           draws=TG.RecordedDraws(ids))
    assert ref.iters == port.iters == CHECK
    _assert_match(ref, port)


def test_nonfinite_guard_matches_reference():
    X, y = _data(seed=4)
    X[1, :5] = np.nan
    rcfg, tcfg = _cfg_pair("complete", True)
    with pytest.raises(G.NonFiniteWeightsError) as ref_err:
        G.gadget_train(X, y, rcfg, n_counts=N_COUNTS)
    ids, _ = _reference_draws(rcfg, y, N_COUNTS, ITERS)
    with pytest.raises(TG.NonFiniteWeightsError) as port_err:
        TG.gadget_train(X, y, tcfg, n_counts=N_COUNTS, device="cpu",
                        draws=TG.RecordedDraws(ids))
    assert port_err.value.iteration == ref_err.value.iteration


def test_zero_iterations_return_initial_state():
    X, y = _data()
    res = TG.gadget_train(X, y, TG.GadgetConfig(max_iters=0), device="cpu")
    assert res.iters == 0 and res.epsilon == float("inf")
    assert res.W.shape == (M, D) and not res.W.any() and not res.w_consensus.any()
    assert res.objective_trace.shape == (0,) and res.mass_trace.shape == (0,)


@pytest.mark.parametrize("topology", ["ring", "random"])
def test_fused_step_above_batch_cap_routes_unfused(topology, monkeypatch):
    """Above ``hinge_subgrad.MAX_FLEET_B`` rows the fused dense step runs ``margins``
    and ``grad_update`` (the kernel's cap is lowered here to force the
    route) and still matches the reference's fused gadget_train at 1e-5."""
    X, y = _data(seed=6)
    monkeypatch.setattr(t_hinge, "MAX_FLEET_B", B - 1)
    routed = []
    unfused = t_ops.unfused_fleet_half_step
    monkeypatch.setattr(t_ops, "unfused_fleet_half_step",
                        lambda *a, **kw: routed.append(1) or unfused(*a, **kw))
    rcfg, tcfg = _cfg_pair(topology, True, use_kernels=True)
    ref = G.gadget_train(X, y, rcfg, n_counts=N_COUNTS)
    ids, mix = _reference_draws(rcfg, y, N_COUNTS, ITERS)
    draws = TG.RecordedDraws(ids, mix if topology == "random" else None)
    port = TG.gadget_train(X, y, tcfg, n_counts=N_COUNTS, device="cpu", draws=draws)
    assert len(routed) == ITERS
    _assert_match(ref, port)
    cost = t_ops.launch_cost("fleet_half_step", m=M, B=B, d=D)
    assert cost["launches"] == 2


def test_own_draws_keyed_on_the_iteration():
    """GeneratorDraws: iteration t's ids, mixing and failure masks are the
    same whatever chunk asked for them."""
    from repro_torch.core.faults import FaultPlan
    counts = torch.tensor([5, 3, 7, 2])
    for fused, faults in ((True, None), (False, None), (True, FaultPlan(0.3, seed=2))):
        plan = TG.DrawPlan(m=4, batch_size=3, rounds=2, topology="random", fused=fused,
                           counts=counts, faults=faults)
        draws = TG.GeneratorDraws(11)
        ids, mix = draws.take(1, 30, plan)
        parts = [draws.take(t0, n, plan) for t0, n in ((1, 7), (8, 16), (24, 7))]
        assert torch.equal(ids, torch.cat([p[0] for p in parts]))
        assert torch.equal(mix, torch.cat([p[1] for p in parts]))
        if faults is not None:
            assert mix.shape == (30, 2, 4, 4)  # clean rounds under faults, even fused
            fails = draws.fails(1, 30, plan)
            assert torch.equal(fails, torch.cat([draws.fails(t0, n, plan)
                                                 for t0, n in ((1, 13), (14, 17))]))
    other = TG.GeneratorDraws(12).take(1, 30, plan)[0]
    assert not torch.equal(ids, other)


def test_own_draws_reach_reference_accuracy():
    """The port's own draws are the reference's (``core.counter_rng``), so
    with no recorded draws it reaches the reference's accuracy, and its
    consensus, on the same separable data and config."""
    X, y, _ = make_separable(n=2000, d=20, seed=0)
    m = 8
    Xp, yp = X.reshape(m, -1, 20), y.reshape(m, -1)
    common = dict(lam=1e-3, batch_size=8, gossip_rounds=3, topology="random",
                  max_iters=600, check_every=200, epsilon=0.0, seed=0)
    ref = G.gadget_train(Xp, yp, G.GadgetConfig(use_kernels=False, **common))
    port = TG.gadget_train(Xp, yp, TG.GadgetConfig(**common), device="cpu")
    acc_ref = float(ref_obj.accuracy(ref.w_consensus, jnp.asarray(X), jnp.asarray(y)))
    acc_port = float(t_obj.accuracy(port.w_consensus, torch.from_numpy(X),
                                    torch.from_numpy(y)))
    assert acc_ref > 0.9
    assert abs(acc_port - acc_ref) <= 1e-6, (acc_port, acc_ref)  # float32 means of one count
    np.testing.assert_allclose(port.w_consensus.numpy(), np.asarray(ref.w_consensus),
                               rtol=0, atol=1e-5)


def test_convert_carries_reference_weights_to_same_labels():
    """A reference-trained consensus, carried across by convert.py, labels
    held-out rows exactly as the reference's dense_predict does."""
    X, y, _ = make_separable(n=800, d=20, seed=1)
    m = 4
    ref = G.gadget_train(X.reshape(m, -1, 20), y.reshape(m, -1),
                         G.GadgetConfig(lam=1e-3, batch_size=4, topology="ring",
                                        max_iters=200, check_every=100,
                                        use_kernels=False))
    Xq = np.random.default_rng(2).normal(size=(37, 20)).astype(np.float32)
    ref_s, ref_l = ref_ops.dense_predict(ref.w_consensus, jnp.asarray(Xq), interpret=True)
    weights = convert.result_to_torch(ref, device="cpu")
    assert weights["W"].shape == (m, 20) and weights["W_avg"].shape == (m, 20)
    w = convert.weights_to_torch(np.asarray(ref.w_consensus), device="cpu")
    np.testing.assert_array_equal(w.numpy(), weights["w_consensus"].numpy())
    s, labels = t_ops.dense_predict(w, torch.from_numpy(Xq))
    np.testing.assert_array_equal(labels.numpy(), np.asarray(ref_l))
    np.testing.assert_allclose(s.numpy(), np.asarray(ref_s), rtol=0, atol=1e-5)


def test_generator_draws_respect_counts_and_protocol():
    counts = torch.tensor([5, 1, 3])
    plan = TG.DrawPlan(m=3, batch_size=4, rounds=2, topology="random", fused=False,
                       counts=counts)
    ids, mix = TG.GeneratorDraws(7).take(1, 60, plan)
    assert ids.shape == (60, 3, 4) and mix.shape == (60, 2, 3, 3)
    assert torch.all(ids >= 0) and torch.all(ids < counts[None, :, None])
    assert set(ids[:, 0].unique().tolist()) == set(range(5))  # every valid row is drawn
    torch.testing.assert_close(mix.sum(-1), torch.ones(60, 2, 3))
    fused_ids, P = TG.GeneratorDraws(7).take(1, 60, plan._replace(fused=True))
    assert torch.equal(fused_ids, ids) and P.shape == (60, 3, 3)
    assert TG.GeneratorDraws(7).take(1, 5, plan._replace(topology="ring"))[1] is None


def test_recorded_draws_refuse_mismatched_runs():
    plan = TG.DrawPlan(m=3, batch_size=2, rounds=2, topology="random", fused=True,
                       counts=torch.tensor([4, 4, 4]))
    ids = np.zeros((10, 3, 2), np.int64)
    with pytest.raises(ValueError, match="mixing"):
        TG.RecordedDraws(ids).take(1, 5, plan)
    with pytest.raises(ValueError, match="cover"):
        TG.RecordedDraws(ids, np.zeros((10, 3, 3))).take(8, 5, plan)
    with pytest.raises(ValueError, match="shape"):
        TG.RecordedDraws(ids, np.zeros((10, 3, 3))).take(1, 5, plan._replace(fused=False))
    got_ids, got_mix = TG.RecordedDraws(ids, np.ones((10, 3, 3))).take(3, 5, plan)
    assert got_ids.shape == (5, 3, 2) and got_mix.shape == (5, 3, 3)
