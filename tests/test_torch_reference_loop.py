"""The port's host-loop oracle (``gadget_train_reference``) against the JAX
reference's, on the CPU, and against the port's own ``gadget_train``.

Both loops draw the reference's Threefry streams (the port through
``core.counter_rng``), so no draws are replayed: W, the consensus, the
objective trace and the mass trace are held at 1e-5 with equal ``iters``,
for deterministic and random topologies, link faults and a dead node,
ELL partitions, non-uniform ``n_counts`` and the host snapshot ring. The
reference runs its plain path (``use_kernels=False``); the port's kernels
take their plain versions on CPU tensors. ``transfer_stats`` of the host
loop equal the reference's; the port's ``gadget_train`` and stream count
one upload and one sync an ε-chunk or segment.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import gadget as G  # noqa: E402
from repro.core.faults import FaultPlan as RefPlan  # noqa: E402
from repro.sparse.formats import EllPartitions as RefEll  # noqa: E402
from repro_torch.core import gadget as TG  # noqa: E402
from repro_torch.core.faults import FaultPlan  # noqa: E402
from repro_torch.sparse.formats import EllPartitions  # noqa: E402

M, N_I, D, B, ITERS, CHECK = 4, 24, 40, 3, 30, 10
ATOL = 1e-5


def _data(seed=0, n_counts=None):
    rng = np.random.default_rng(seed)
    w_true = rng.normal(size=D)
    X = (rng.normal(size=(M, N_I, D)) / np.sqrt(D)).astype(np.float32)
    y = np.sign(X @ w_true).astype(np.float32)
    y[y == 0] = 1.0
    if n_counts is not None:
        for i, c in enumerate(n_counts):
            X[i, c:] = 0.0
            y[i, c:] = 0.0
    return X, y


def _ell(X, k=12):
    """Padded-ELL planes of dense partitions: each row's k largest-magnitude
    columns, ascending, the rest of the row dropped; returns the planes and
    the dense matrix they describe."""
    order = np.argsort(-np.abs(X), axis=-1)[..., :k]
    cols = np.sort(order, axis=-1).astype(np.int32)
    vals = np.take_along_axis(X, cols, axis=-1).astype(np.float32)
    dense = np.zeros_like(X)
    np.put_along_axis(dense, cols, vals, axis=-1)
    return cols, vals, dense


def _configs(**kw):
    common = dict(lam=1e-2, batch_size=B, gossip_rounds=3, topology="exponential",
                  epsilon=0.0, check_every=CHECK, max_iters=ITERS, seed=4)
    common.update(kw)
    plan = common.pop("faults", None)
    return (G.GadgetConfig(use_kernels=False, **common,
                           faults=None if plan is None else RefPlan(*plan)),
            TG.GadgetConfig(**common, faults=None if plan is None else FaultPlan(*plan)))


def _close(port, ref):
    assert port.iters == ref.iters
    np.testing.assert_allclose(port.W.numpy(), np.asarray(ref.W), atol=ATOL)
    np.testing.assert_allclose(port.w_consensus.numpy(), np.asarray(ref.w_consensus), atol=ATOL)
    np.testing.assert_allclose(port.W_avg.numpy(), np.asarray(ref.W_avg), atol=ATOL)
    np.testing.assert_allclose(port.objective_trace, ref.objective_trace, rtol=ATOL)
    np.testing.assert_allclose(port.mass_trace, ref.mass_trace, atol=ATOL)
    np.testing.assert_array_equal(port.time_trace, ref.time_trace)
    np.testing.assert_allclose(port.eps_trace, ref.eps_trace, rtol=1e-4, atol=ATOL)


CASES = {
    "exponential": dict(),
    "random": dict(topology="random"),
    "ring": dict(topology="ring"),
    "link-faults": dict(topology="random", faults=(0.3, "link", (), 2)),
    "message-dead": dict(faults=(0.2, "message", (1,), 5)),
    "no-projection": dict(project_before_gossip=False, project_after_gossip=False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_host_loop_matches_reference(case):
    X, y = _data()
    rcfg, tcfg = _configs(**CASES[case])
    ref = G.gadget_train_reference(jnp.asarray(X), jnp.asarray(y), rcfg)
    port = TG.gadget_train_reference(X, y, tcfg, device="cpu")
    _close(port, ref)


def test_host_loop_non_uniform_counts_matches_reference():
    counts = np.array([24, 19, 13, 22])
    X, y = _data(seed=1, n_counts=counts)
    rcfg, tcfg = _configs(topology="random")
    ref = G.gadget_train_reference(jnp.asarray(X), jnp.asarray(y), rcfg, n_counts=counts)
    port = TG.gadget_train_reference(X, y, tcfg, n_counts=counts, device="cpu")
    _close(port, ref)


@pytest.mark.parametrize("schedule", ["prefetch", "sweep"])
def test_host_loop_ell_matches_reference(schedule):
    X, y = _data(seed=2)
    cols, vals, dense = _ell(X)
    rcfg, tcfg = _configs(topology="random", sparse_schedule=schedule)
    ref = G.gadget_train_reference(RefEll(cols, vals, D), jnp.asarray(y), rcfg)
    port = TG.gadget_train_reference(EllPartitions(cols, vals, D), y, tcfg, device="cpu")
    _close(port, ref)
    dense_port = TG.gadget_train_reference(dense, y, tcfg, device="cpu")
    np.testing.assert_allclose(dense_port.W.numpy(), port.W.numpy(), atol=ATOL)


@pytest.mark.parametrize("every,slots", [(4, 3), (10, 8)])
def test_host_snapshot_ring_matches_reference(every, slots):
    X, y = _data(seed=3)
    rcfg, tcfg = _configs()
    ref = G.gadget_train_reference(jnp.asarray(X), jnp.asarray(y), rcfg,
                                   snapshot_every=every, snapshot_slots=slots)
    port = TG.gadget_train_reference(X, y, tcfg, snapshot_every=every, snapshot_slots=slots,
                                     device="cpu")
    r, p = ref.snapshots, port.snapshots
    assert (p.every, p.count, p.final_iteration) == (r.every, r.count, r.final_iteration)
    np.testing.assert_array_equal(p.iterations, r.iterations)
    np.testing.assert_allclose(p.W, r.W, atol=ATOL)
    np.testing.assert_allclose(p.objectives, r.objectives, rtol=ATOL, equal_nan=True)
    np.testing.assert_allclose(p.final_w, r.final_w, atol=ATOL)
    assert abs(p.final_objective - r.final_objective) <= ATOL * abs(r.final_objective)


def test_host_loop_epsilon_stop_matches_reference():
    X, y = _data(seed=5)
    rcfg, tcfg = _configs(lam=1e-1, epsilon=5e-2, max_iters=300)
    ref = G.gadget_train_reference(jnp.asarray(X), jnp.asarray(y), rcfg)
    port = TG.gadget_train_reference(X, y, tcfg, device="cpu")
    assert ref.iters < 300
    _close(port, ref)


@pytest.mark.parametrize("topology", ["exponential", "random"])
def test_transfer_stats_of_host_loop_equal_reference(topology):
    X, y = _data()
    rcfg, tcfg = _configs(topology=topology)
    G.reset_transfer_stats()
    G.gadget_train_reference(jnp.asarray(X), jnp.asarray(y), rcfg)
    TG.reset_transfer_stats()
    TG.gadget_train_reference(X, y, tcfg, device="cpu")
    assert TG.transfer_stats == G.transfer_stats
    assert TG.transfer_stats == {"matrix_uploads": ITERS if topology != "random" else 0,
                                 "host_syncs": 2 * (ITERS // CHECK)}


@pytest.mark.parametrize("topology", ["exponential", "random", "link-faults"])
def test_unfused_gadget_train_equals_host_loop(topology):
    X, y = _data(seed=6)
    kw = CASES.get(topology, dict(topology=topology))
    _, tcfg = _configs(**kw, fused=False)
    loop = TG.gadget_train_reference(X, y, tcfg, device="cpu")
    dev = TG.gadget_train(X, y, tcfg, device="cpu")
    assert loop.iters == dev.iters
    np.testing.assert_allclose(dev.W.numpy(), loop.W.numpy(), atol=ATOL)
    np.testing.assert_allclose(dev.w_consensus.numpy(), loop.w_consensus.numpy(), atol=ATOL)
    np.testing.assert_allclose(dev.objective_trace, loop.objective_trace, rtol=ATOL)


@pytest.mark.parametrize("topology,uploads", [("exponential", 1), ("random", 0)])
def test_transfer_stats_of_gadget_train_and_stream(topology, uploads):
    """One upload of a deterministic cycle and one sync an ε-chunk; the
    stream one sync a segment."""
    X, y = _data()
    _, tcfg = _configs(topology=topology, max_iters=2 * CHECK)
    TG.reset_transfer_stats()
    TG.gadget_train(X, y, tcfg, device="cpu")
    assert TG.transfer_stats == {"matrix_uploads": uploads, "host_syncs": 2}
    TG.reset_transfer_stats()
    segments = list(TG.gadget_train_stream(X, y, tcfg, segment_iters=CHECK, device="cpu"))
    assert len(segments) == 2
    assert TG.transfer_stats == {"matrix_uploads": uploads, "host_syncs": 2}
