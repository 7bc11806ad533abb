"""The port's fault injection against the JAX reference, on the CPU.

``repro_torch.core.faults`` takes its failure masks as tensors, so the
reference's own masks (``jax.random.bernoulli(round_fail_key(plan, t, r),
p, (m, m))``) drive the port here: the fault model, the host simulator and
faulted training (through ``RecordedDraws(ids, mix, fails)``) are held to
the reference at 1e-5. The port's own keyed masks are held to the fault
model's properties: link mode conserves mass, message mode leaks, dead rows
stay frozen, an inert plan is no plan.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import faults as rflt  # noqa: E402
from repro.core import gadget as G  # noqa: E402
from repro.core import resilience as rres  # noqa: E402
from repro.core import topology as ref_topo  # noqa: E402
from repro_torch.core import faults as tflt  # noqa: E402
from repro_torch.core import gadget as TG  # noqa: E402
from repro_torch.core import resilience as tres  # noqa: E402

M, N_I, D, B, R, ITERS, CHECK = 5, 24, 40, 3, 2, 16, 6
N_COUNTS = np.array([24, 20, 17, 24, 22])
TOPOLOGIES = ["exponential", "ring", "complete", "torus", "random"]


def _data(seed=0, n_counts=N_COUNTS):
    rng = np.random.default_rng(seed)
    w_true = rng.normal(size=D)
    X = (rng.normal(size=(len(n_counts), N_I, D)) / np.sqrt(D)).astype(np.float32)
    y = np.sign(X @ w_true).astype(np.float32)
    y[y == 0] = 1.0
    for i, c in enumerate(n_counts):
        X[i, c:] = 0.0
        y[i, c:] = 0.0
    return X, y


def _ref_masks(plan, T, rounds, m, t0=1):
    """The reference's failure masks of iterations t0 … t0+T−1, (T, R, m, m)."""
    plan = rflt.validate_plan(plan, m)

    def one(t, r):
        return jax.random.bernoulli(rflt.round_fail_key(plan, t, r), plan.drop_prob, (m, m))

    ts, rs = jnp.arange(t0, t0 + T), jnp.arange(rounds)
    return np.array(jax.vmap(lambda t: jax.vmap(lambda r: one(t, r))(rs))(ts))


def _ref_draws(cfg, y, n_counts, T):
    """The reference's ids and, for the random topology, its clean rounds."""
    m = y.shape[0]
    data_key, mix_key = G._stream_keys(cfg.seed)
    counts = G._partition_counts(jnp.asarray(y), n_counts)
    ts = jnp.arange(1, T + 1, dtype=jnp.int32)
    ids = jax.vmap(lambda t: G._batch_ids(data_key, t, counts, cfg.batch_size))(ts)
    if cfg.topology != "random":
        return np.asarray(ids), None
    mix = jax.vmap(lambda t: G._iter_mixing(mix_key, None, t, m, cfg.gossip_rounds,
                                            "random", False))(ts)
    return np.asarray(ids), np.asarray(mix)


def _cfgs(topology, fused, plan, **kw):
    common = dict(lam=1e-2, batch_size=B, gossip_rounds=R, topology=topology, epsilon=0.0,
                  check_every=CHECK, max_iters=ITERS, seed=3, fused=fused, faults=plan)
    common.update(kw)
    ref_plan = None if plan is None else rflt.FaultPlan(*plan)
    return (G.GadgetConfig(use_kernels=False, **dict(common, faults=ref_plan)),
            TG.GadgetConfig(**common))


def _assert_faulted_match(ref, port):
    assert port.iters == ref.iters
    for name in ("W", "w_consensus", "W_avg"):
        np.testing.assert_allclose(getattr(port, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=0, atol=1e-5, err_msg=name)
    np.testing.assert_allclose(port.mass_trace, ref.mass_trace, rtol=0, atol=1e-5)
    np.testing.assert_allclose(port.objective_trace, ref.objective_trace, rtol=1e-5)


# ------------------------------------------------------------- fault model


def test_validate_plan_errors_and_normalisation():
    plan = tflt.FaultPlan(drop_prob=np.float64(0.25), drop="message", dead_nodes=(3, 1, 3),
                          seed=np.int64(7))
    got = tflt.validate_plan(plan, 5)
    want = rflt.validate_plan(rflt.FaultPlan(*plan), 5)
    assert tuple(got) == tuple(want) == (0.25, "message", (1, 3), 7)
    assert type(got.drop_prob) is float and type(got.seed) is int
    for bad in (tflt.FaultPlan(drop="udp"), tflt.FaultPlan(drop_prob=1.0),
                tflt.FaultPlan(drop_prob=-0.1), tflt.FaultPlan(dead_nodes=(5,)),
                tflt.FaultPlan(dead_nodes=(-1,)), tflt.FaultPlan(dead_nodes=(0, 1, 2, 3, 4))):
        with pytest.raises(ValueError):
            tflt.validate_plan(bad, 5)
        with pytest.raises(ValueError):
            rflt.validate_plan(rflt.FaultPlan(*bad), 5)


@pytest.mark.parametrize("dead", [(), (2,)], ids=["alive", "dead2"])
@pytest.mark.parametrize("drop", ["link", "message"])
@pytest.mark.parametrize("topology", ["ring", "random", "torus"])
def test_apply_faults_and_drops_match_reference(topology, drop, dead):
    """apply_faults, faulty_rounds, count_drops and count_drops_node on the
    reference's own masks: matrices within 1e-7, counts exact."""
    m, T = 6, 5
    plan = tflt.FaultPlan(drop_prob=0.35, drop=drop, dead_nodes=dead, seed=11)
    rplan = rflt.validate_plan(rflt.FaultPlan(*plan), m)
    rng = np.random.default_rng(4)
    for t in range(1, T + 1):
        Bs = np.stack([ref_topo.build_matrix(topology, m, t=t * R + r, rng=rng)
                       for r in range(R)]).astype(np.float32)
        masks = _ref_masks(plan, 1, R, m, t0=t)[0]
        want = np.asarray(rflt.faulty_rounds(jnp.asarray(Bs), rplan, t))
        got = tflt.faulty_rounds(torch.from_numpy(Bs), torch.from_numpy(masks), plan)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-7)
        single = tflt.apply_faults(torch.from_numpy(Bs[0]), torch.from_numpy(masks[0]), plan)
        np.testing.assert_allclose(single.numpy(), want[0], rtol=0, atol=1e-7)
        drops = tflt.count_drops(torch.from_numpy(Bs), torch.from_numpy(masks), plan)
        assert int(drops) == int(rflt.count_drops(jnp.asarray(Bs), rplan, t))
        node = tflt.count_drops_node(torch.from_numpy(Bs), torch.from_numpy(masks), plan)
        np.testing.assert_array_equal(node.numpy(),
                                      np.asarray(rflt.count_drops_node(jnp.asarray(Bs), rplan, t)))
        assert int(node.sum()) == int(drops)


@pytest.mark.parametrize("drop", ["link", "message"])
def test_faulty_sim_matches_reference(drop):
    """FaultySim on the reference's masks: the reference's matrices (its
    random draws from default_rng((seed, t)) are the port's) and rounds."""
    m = 7
    kw = dict(topology="random", seed=3, drop_prob=0.3, drop=drop, dead_nodes=(4,))
    ref = rres.FaultySim(m, **kw)
    plan = tflt.FaultPlan(0.3, drop, (4,), 3)
    port = tres.FaultySim(m, **kw, fails=lambda t: _ref_masks(plan, 1, 1, m, t0=t)[0, 0])
    assert port.plan == tuple(ref.plan) and port.dead == ref.dead
    for t in range(4):
        np.testing.assert_allclose(port.matrix(t), ref.matrix(t), rtol=0, atol=1e-7)
    values = np.random.default_rng(0).normal(size=(m, 3)).astype(np.float32)
    st_ref = ref.run(jnp.asarray(values), 6)
    st = port.run(torch.from_numpy(values), 6)
    np.testing.assert_allclose(st.weight.numpy(), np.asarray(st_ref.weight), rtol=0, atol=1e-6)
    np.testing.assert_allclose(st.estimate().numpy(), np.asarray(st_ref.estimate()),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_faulty_sim_own_masks_keep_the_fault_model(topology):
    """The port's keyed masks: link mode rows sum to 1 (mass conserved),
    message mode leaks mass, a dead row is e_d and nothing flows into it."""
    m = 8
    link = tres.FaultySim(m, topology, seed=1, drop_prob=0.3, drop="link", dead_nodes=(2,))
    msg = tres.FaultySim(m, topology, seed=1, drop_prob=0.3, drop="message")
    for t in range(6):
        B = link.matrix(t)
        np.testing.assert_allclose(B.sum(axis=1), 1.0, atol=1e-6)
        np.testing.assert_array_equal(B[2], np.eye(m, dtype=np.float32)[2])
        assert np.all(np.delete(B[:, 2], 2) == 0.0)
        assert msg.matrix(t).sum() <= m + 1e-6
    st = msg.run(torch.ones((m, 2)), 10)
    assert float(st.weight.sum()) < m
    np.testing.assert_allclose(st.estimate().numpy(), 1.0, atol=1e-5)  # ratios stay consistent


def test_keyed_masks_are_pure_and_at_rate():
    plan = tflt.FaultPlan(drop_prob=0.2, seed=9)
    whole = tflt.keyed_fail_masks(plan, 1, 40, 3, 6)
    parts = torch.cat([tflt.keyed_fail_masks(plan, 1, 15, 3, 6),
                       tflt.keyed_fail_masks(plan, 16, 25, 3, 6)])
    assert whole.shape == (40, 3, 6, 6) and torch.equal(whole, parts)
    assert abs(float(whole.float().mean()) - 0.2) < 0.03
    other = tflt.keyed_fail_masks(plan._replace(seed=10), 1, 40, 3, 6)
    assert not torch.equal(whole, other)
    assert not tflt.keyed_fail_masks(plan._replace(drop_prob=0.0), 1, 40, 3, 6).any()


# ------------------------------------------------------- faulted training


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_faulted_training_matches_reference_link_dead(topology, fused):
    """Link mode with a dead node, non-uniform n_counts, every topology,
    fused and unfused: W, consensus at 1e-5, mass_trace at 1e-5."""
    X, y = _data()
    plan = tflt.FaultPlan(drop_prob=0.3, drop="link", dead_nodes=(1,), seed=5)
    rcfg, tcfg = _cfgs(topology, fused, plan)
    ref = G.gadget_train(X, y, rcfg, n_counts=N_COUNTS)
    ids, mix = _ref_draws(rcfg, y, N_COUNTS, ITERS)
    draws = TG.RecordedDraws(ids, mix, _ref_masks(plan, ITERS, R, M))
    port = TG.gadget_train(X, y, tcfg, n_counts=N_COUNTS, device="cpu", draws=draws)
    _assert_faulted_match(ref, port)
    np.testing.assert_allclose(port.mass_trace, 1.0, atol=1e-6)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("topology", ["exponential", "random"])
def test_faulted_training_matches_reference_message(topology, fused):
    """Message mode: mass leaks, the renormalising divide uses the smaller
    weights, mass_trace at 1e-5 absolute."""
    X, y = _data(seed=1)
    plan = tflt.FaultPlan(drop_prob=0.25, drop="message", dead_nodes=(3,), seed=8)
    rcfg, tcfg = _cfgs(topology, fused, plan)
    ref = G.gadget_train(X, y, rcfg, n_counts=N_COUNTS)
    ids, mix = _ref_draws(rcfg, y, N_COUNTS, ITERS)
    draws = TG.RecordedDraws(ids, mix, _ref_masks(plan, ITERS, R, M))
    port = TG.gadget_train(X, y, tcfg, n_counts=N_COUNTS, device="cpu", draws=draws)
    _assert_faulted_match(ref, port)
    assert np.all(port.mass_trace < 1.0)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_dead_rows_bit_frozen(fused):
    X, y = _data(seed=2)
    plan = tflt.FaultPlan(drop_prob=0.2, drop="message", dead_nodes=(0, 3), seed=1)
    res = TG.gadget_train(X, y, _cfgs("random", fused, plan)[1], n_counts=N_COUNTS,
                          device="cpu")
    assert not res.W[[0, 3]].any() and not res.W_avg[[0, 3]].any()
    assert res.W[[1, 2, 4]].abs().sum() > 0


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("topology", ["ring", "random"])
def test_inert_plan_bit_identical_to_no_plan(topology, fused):
    X, y = _data(seed=3)
    base = _cfgs(topology, fused, None)[1]
    plain = TG.gadget_train(X, y, base, n_counts=N_COUNTS, device="cpu")
    inert = TG.gadget_train(X, y, base._replace(faults=tflt.FaultPlan(seed=4)),
                            n_counts=N_COUNTS, device="cpu")
    assert torch.equal(plain.W, inert.W) and torch.equal(plain.W_avg, inert.W_avg)
    np.testing.assert_array_equal(plain.mass_trace, inert.mass_trace)


def test_own_masks_link_conserves_message_leaks():
    X, y = _data(seed=4)
    link = TG.gadget_train(X, y, _cfgs("random", True, tflt.FaultPlan(0.3, "link"))[1],
                           n_counts=N_COUNTS, device="cpu")
    msg = TG.gadget_train(X, y, _cfgs("random", True, tflt.FaultPlan(0.3, "message"))[1],
                          n_counts=N_COUNTS, device="cpu")
    np.testing.assert_allclose(link.mass_trace, 1.0, atol=1e-6)
    assert np.all(msg.mass_trace < 1.0)
    assert bool(torch.isfinite(msg.W).all())


def test_invalid_plan_rejected_at_train_entry():
    X, y = _data()
    for bad in (tflt.FaultPlan(drop="udp"), tflt.FaultPlan(dead_nodes=(M,))):
        with pytest.raises(ValueError):
            TG.gadget_train(X, y, _cfgs("ring", True, bad)[1], device="cpu")


def test_recorded_draws_need_masks_for_faulted_runs():
    X, y = _data()
    plan = tflt.FaultPlan(drop_prob=0.3, seed=5)
    rcfg, tcfg = _cfgs("random", True, plan)
    ids, mix = _ref_draws(rcfg, y, N_COUNTS, ITERS)
    with pytest.raises(ValueError, match="failure masks"):
        TG.gadget_train(X, y, tcfg, n_counts=N_COUNTS, device="cpu",
                        draws=TG.RecordedDraws(ids, mix))
    with pytest.raises(ValueError, match="fails must have shape"):
        TG.gadget_train(X, y, tcfg, n_counts=N_COUNTS, device="cpu",
                        draws=TG.RecordedDraws(ids, mix, np.zeros((ITERS, R + 1, M, M), bool)))


def test_faulty_sim_runs_on_the_values_device():
    """The weight and every round live on the values' device: ``meta``
    values, as CUDA ones on the card (a CPU round matrix times them raises).
    The matrices stay numpy float32."""
    m = 6
    sim = tres.FaultySim(m, "random", seed=2, drop_prob=0.3, drop="link", dead_nodes=(1,))
    values = {"w": torch.empty((m, 5), device="meta"),
              "b": torch.empty((m, 2, 3), device="meta", dtype=torch.bfloat16)}
    st = sim.run(values, 4)
    assert st.weight.device.type == "meta" and st.weight.shape == (m,)
    for k, v in st.values.items():
        assert v.device.type == "meta" and v.shape == values[k].shape
        assert v.dtype == values[k].dtype
    assert sim.matrix(3).dtype == np.float32


@pytest.mark.parametrize("drop_prob", [0.0, 0.2, 0.7])
def test_faulty_sim_mask_is_the_keyed_mask(drop_prob):
    """The simulator's own round-t mask is the reference's keyed draw at
    (t, round 0), the one its training loop makes, bit for bit."""
    sim = tres.FaultySim(10, "random", seed=3, drop_prob=drop_prob)
    for t in (0, 1, 5, 3601):
        np.testing.assert_array_equal(sim.fail_mask(t).numpy(),
                                      _ref_masks(sim.plan, 1, 1, 10, t0=t)[0, 0])
