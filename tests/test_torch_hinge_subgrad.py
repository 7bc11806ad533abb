"""The port's dense half-step functions against the reference's Pallas
kernels, run in interpret mode. On CPU tensors the port's wrappers take
their kernels' plain versions, which is what these tests hold to the
reference (the CUDA kernels themselves are held to the plain versions on
the card by chip_smoke.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.hinge_subgrad import hinge_subgrad as RK  # noqa: E402
from repro.kernels.hinge_subgrad import ops as RO  # noqa: E402
from repro_torch.core import gadget as TG  # noqa: E402
from repro_torch.kernels.hinge_subgrad import hinge_subgrad as TK  # noqa: E402
from repro_torch.kernels.hinge_subgrad import ops as TO  # noqa: E402
from repro_torch.kernels.hinge_subgrad import predict as TP  # noqa: E402

ATOL = 1e-5
SHAPES = [(B, d) for B in (1, 5, 8) for d in (100, 130, 300)]
LAM, T = 1e-2, 7


def _inputs(B, d, m=3, seed=0):
    """Unit-scale rows, weights near the margin boundary, and (for B > 1) one
    padded row per node: y = 0."""
    rng = np.random.default_rng(seed + 31 * B + d)
    X = (rng.normal(size=(m, B, d)) / np.sqrt(d) * 3).astype(np.float32)
    W = rng.normal(size=(m, d)).astype(np.float32)
    y = np.where(rng.random((m, B)) < 0.5, -1.0, 1.0).astype(np.float32)
    if B > 1:
        y[:, -1] = 0.0
    return X, W, y


def _close(port, ref):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=0, atol=ATOL)


@pytest.mark.parametrize("project", [True, False])
@pytest.mark.parametrize("B,d", SHAPES)
def test_fleet_half_step(B, d, project):
    X, W, y = _inputs(B, d)
    ref = RO.fleet_half_step(jnp.asarray(W), jnp.asarray(X), jnp.asarray(y), lam=LAM,
                             t=jnp.float32(T), project=project, interpret=True)
    port = TO.fleet_half_step(torch.from_numpy(W), torch.from_numpy(X),
                              torch.from_numpy(y), lam=LAM, t=T, project=project)
    _close(port, ref)


@pytest.mark.parametrize("project", [True, False])
@pytest.mark.parametrize("B,d", SHAPES)
def test_local_half_step(B, d, project):
    X, W, y = _inputs(B, d, m=1)
    ref = RO.local_half_step(jnp.asarray(W[0]), jnp.asarray(X[0]), jnp.asarray(y[0]),
                             lam=LAM, t=jnp.float32(T), project=project, interpret=True)
    port = TO.local_half_step(torch.from_numpy(W[0]), torch.from_numpy(X[0]),
                              torch.from_numpy(y[0]), lam=LAM, t=T, project=project)
    _close(port, ref)


@pytest.mark.parametrize("B,d", SHAPES)
def test_pegasos_step(B, d):
    X, W, y = _inputs(B, d, m=1)
    y[0] = np.where(y[0] == 0, 1.0, y[0])  # pegasos_step takes labels in {-1, +1}
    w_ref, loss_ref = RO.pegasos_step(jnp.asarray(W[0]), jnp.asarray(X[0]),
                                      jnp.asarray(y[0]), lam=LAM, t=jnp.float32(T),
                                      interpret=True)
    w_port, loss_port = TO.pegasos_step(torch.from_numpy(W[0]), torch.from_numpy(X[0]),
                                        torch.from_numpy(y[0]), lam=LAM, t=T)
    _close(w_port, w_ref)
    _close(loss_port, loss_ref)


@pytest.mark.parametrize("B,d", SHAPES)
def test_kernel_functions(B, d):
    """The three kernel entry points as the reference's raw pallas_calls take
    them: a fleet row mask with dropped rows, margins, and grad_update."""
    X, W, y = _inputs(B, d)
    mask = np.ones(B, np.float32)
    mask[::2] = 0.0
    s0, s1 = TO.step_scalars(LAM, T, B)
    scal = jnp.asarray([s0, s1], jnp.float32)
    ref = RK.fleet_half_step(jnp.asarray(X), jnp.asarray(W), jnp.asarray(y),
                             jnp.asarray(mask), scal, interpret=True)
    port = TK.fleet_half_step(torch.from_numpy(X), torch.from_numpy(W),
                              torch.from_numpy(y), torch.from_numpy(mask), (s0, s1))
    _close(port, ref)

    m_ref = RK.margins(jnp.asarray(X[0]), jnp.asarray(W[0]), jnp.asarray(y[0]),
                       blk_b=B, blk_d=d, interpret=True)
    m_port = TK.margins(torch.from_numpy(X[0]), torch.from_numpy(W[0]), torch.from_numpy(y[0]))
    _close(m_port, m_ref)

    coeff = np.where(np.asarray(m_ref) < 1.0, y[0], 0.0).astype(np.float32)
    g_ref = RK.grad_update(jnp.asarray(X[0]), jnp.asarray(W[0]), jnp.asarray(coeff), scal,
                           blk_b=B, blk_d=d, interpret=True)
    g_port = TK.grad_update(torch.from_numpy(X[0]), torch.from_numpy(W[0]),
                            torch.from_numpy(coeff), (s0, s1))
    _close(g_port, g_ref)


@pytest.mark.parametrize("d", [129, 1001])
@pytest.mark.parametrize("B", [1, 5, 37])
@pytest.mark.parametrize("m", [1, 3])
def test_fleet_margins_matches_vmapped_reference(m, B, d):
    """The fleet form of ``margins`` (X (m, B, d), W (m, d), y (m, B)) against
    the reference's Pallas ``margins`` vmapped over the nodes, as its unfused
    step runs it."""
    X, W, y = _inputs(B, d, m=m, seed=7)
    ref = jax.vmap(lambda Xi, wi, yi: RK.margins(Xi, wi, yi, blk_b=B, blk_d=d, interpret=True))(
        jnp.asarray(X), jnp.asarray(W), jnp.asarray(y))
    port = TK.margins(torch.from_numpy(X), torch.from_numpy(W), torch.from_numpy(y))
    assert port.shape == (m, B)
    _close(port, ref)


@pytest.mark.parametrize("B,d", [(1, 129), (5, 1001), (37, 300)])
def test_margins_one_node_form_is_the_m1_fleet(B, d):
    X, W, y = (torch.from_numpy(a) for a in _inputs(B, d, m=1, seed=3))
    one = TK.margins(X[0], W[0], y[0])
    assert one.shape == (B,)
    assert torch.equal(one, TK.margins(X, W, y)[0])
    assert torch.equal(one, TK.margins_plain(X[0], W[0], y[0]))


@pytest.mark.parametrize("rows,n_sm,want", [(10, 132, 16), (1, 132, 16), (17, 132, 8),
                                            (111, 132, 2), (133, 132, 1), (264, 132, 1),
                                            (5000, 132, 1), (10, 66, 8)])
def test_margins_cluster(rows, n_sm, want):
    """Blocks a margins row gets: the largest power of two up to 16 with at
    most two blocks an SM (16 at the unfused reuters fleet's 10 rows on an
    H100 SXM's 132 SMs), one block a row from 2 SMs' worth of rows up."""
    cl = TK.margins_cluster(rows, n_sm)
    assert cl == want
    assert rows * cl <= 2 * n_sm or cl == 1


def test_unfused_train_launches_margins_once_per_iteration(monkeypatch):
    """The unfused step calls the fleet ``margins`` and the fleet
    ``grad_update`` once an iteration each (the reference vmaps one node's
    step over the nodes)."""
    calls = {"margins": [], "grad_update": []}
    for name in calls:
        fn = getattr(TK, name)

        def spy(*args, _fn=fn, _name=name):
            calls[_name].append(tuple(args[0].shape))
            return _fn(*args)
        monkeypatch.setattr(TK, name, spy)
    m, n_i, B, d, iters = 3, 12, 2, 40, 7
    rng = np.random.default_rng(0)
    X = (rng.normal(size=(m, n_i, d)) / np.sqrt(d)).astype(np.float32)
    y = np.where(rng.random((m, n_i)) < 0.5, -1.0, 1.0).astype(np.float32)
    cfg = TG.GadgetConfig(lam=1e-2, batch_size=B, gossip_rounds=2, topology="ring",
                          epsilon=0.0, check_every=5, max_iters=iters, fused=False)
    res = TG.gadget_train(X, y, cfg, device="cpu")
    assert res.iters == iters
    assert calls["margins"] == [(m, B, d)] * iters
    assert calls["grad_update"] == [(m, B, d)] * iters


@pytest.mark.parametrize("m,B,d", [(3, 1, 130), (2, 5, 131), (4, 2, 40), (1, 37, 129),
                                   (10, 1, 1001)])
def test_fleet_grad_update_matches_vmapped_reference(m, B, d):
    """The fleet form of ``grad_update`` (X (m, B, d), W (m, d), coeff
    (m, B)) against the reference's Pallas ``grad_update`` vmapped over the
    nodes, as its unfused step runs it."""
    X, W, y = _inputs(B, d, m=m, seed=11)
    coeff = np.where(np.random.default_rng(m + B + d).random((m, B)) < 0.5, y, 0.0)
    coeff = coeff.astype(np.float32)
    s0, s1 = TO.step_scalars(LAM, T, B)
    scal = jnp.asarray([s0, s1], jnp.float32)
    ref = jax.vmap(lambda Xi, wi, ci: RK.grad_update(Xi, wi, ci, scal, blk_b=B, blk_d=d,
                                                     interpret=True))(
        jnp.asarray(X), jnp.asarray(W), jnp.asarray(coeff))
    port = TK.grad_update(torch.from_numpy(X), torch.from_numpy(W), torch.from_numpy(coeff),
                          (s0, s1))
    assert port.shape == (m, d)
    _close(port, ref)


@pytest.mark.parametrize("m,B,d", [(3, 1, 130), (2, 5, 131), (4, 2, 40)])
def test_grad_update_one_node_form_is_row_of_the_fleet(m, B, d):
    """One node's (B, d) form equals its row of the fleet form, and the
    plain version's, bit for bit."""
    X, W, y = (torch.from_numpy(a) for a in _inputs(B, d, m=m, seed=5))
    scal = TO.step_scalars(LAM, T, B)
    fleet = TK.grad_update(X, W, y, scal)
    for i in range(m):
        one = TK.grad_update(X[i], W[i], y[i], scal)
        assert one.shape == (d,)
        assert torch.equal(one, fleet[i])
        assert torch.equal(one, TK.grad_update_plain(X[i], W[i], y[i], scal))


@pytest.mark.parametrize("project", [True, False])
@pytest.mark.parametrize("m,B,d", [(3, 1, 130), (2, 5, 131), (4, 2, 40)])
def test_unfused_fleet_half_step_matches_vmapped_reference(m, B, d, project):
    """The unfused fleet step (one fleet ``margins``, one fleet
    ``grad_update``) against the reference's ``local_half_step`` vmapped
    over the nodes."""
    X, W, y = _inputs(B, d, m=m, seed=13)
    ref = jax.vmap(lambda wi, Xi, yi: RO.local_half_step(wi, Xi, yi, lam=LAM, t=jnp.float32(T),
                                                         project=project, interpret=True))(
        jnp.asarray(W), jnp.asarray(X), jnp.asarray(y))
    port = TO.unfused_fleet_half_step(torch.from_numpy(W), torch.from_numpy(X),
                                      torch.from_numpy(y), lam=LAM, t=T, project=project)
    _close(port, ref)


def test_grad_update_counts_no_cpu_launch_and_refuses_bad_inputs():
    """On CPU tensors ``grad_update`` takes its plain version and counts no
    launch; a meta tensor, tensors on two devices and mismatched shapes
    raise."""
    X, W, y = (torch.from_numpy(a) for a in _inputs(2, 100))
    scal = TO.step_scalars(LAM, T, 2)
    before = TK.grad_update.launches
    assert TK.grad_update(X, W, y, scal).shape == (3, 100)
    assert TK.grad_update(X[0], W[0], y[0], scal).shape == (100,)
    assert TK.grad_update.launches == before == 0
    with pytest.raises(ValueError, match="devices"):
        TK.grad_update(X, W.to("meta"), y, scal)
    with pytest.raises(ValueError, match="unsupported device"):
        TK.grad_update(X.to("meta"), W.to("meta"), y.to("meta"), scal)
    for bad in ((X, W[:2], y), (X, W, y[:, :1]), (X, W[:, :99], y), (X[0, 0], W[0], y[0])):
        with pytest.raises(ValueError):
            TK.grad_update(*bad, scal)
    assert TK.grad_update.launches == 0


def test_launch_cost_grad_update_counts_nodes():
    """The fleet grad reads X, W and coeff and writes W_half once: 997,840
    bytes at the unfused reuters shape (10, 1, 8315), a bound of 0.298 us at
    3.35 TB/s; m = 1 is one node's call."""
    cost = TO.launch_cost("grad_update", m=10, B=1, d=8315)
    assert cost == {"launches": 1, "bytes": 4 * 10 * (8315 + 2 * 8315 + 1),
                    "flops": 10 * (2 * 8315 + 3 * 8315)}
    assert cost["bytes"] == 997840
    assert TO.launch_cost("grad_update", B=5, d=130) == {
        "launches": 1, "bytes": 4 * (5 * 130 + 2 * 130 + 5), "flops": 2 * 5 * 130 + 3 * 130}


def test_launch_cost_margins_counts_nodes():
    """The fleet margins read X, W and y and write the margins once: 665 KB
    at the unfused reuters shape (10, 1, 8315); m = 1 is one node's call."""
    assert TO.launch_cost("margins", m=10, B=1, d=8315) == {
        "launches": 1, "bytes": 4 * (10 * 8315 + 10 * 8315 + 2 * 10), "flops": 10 * (2 * 8315 + 1)}
    assert TO.launch_cost("margins", B=5, d=130) == {
        "launches": 1, "bytes": 4 * (5 * 130 + 130 + 2 * 5), "flops": 2 * 5 * 130 + 5}


def test_step_scalars_are_float32_as_reference():
    for lam, t, B in ((1.29e-4, 1, 1), (1e-3, 37, 5), (3.07e-5, 4000, 8)):
        tf = jnp.float32(t)
        alpha = 1.0 / (lam * tf)
        assert TO.step_scalars(lam, t, B) == (float(lam * alpha), float(alpha / B))


def test_launch_cost_model():
    assert TO.launch_cost("fleet_half_step", m=10, B=1, d=8315) == {
        "launches": 1, "bytes": 4 * (10 * 8315 + 2 * 10 * 8315 + 10 + 1),
        "flops": 10 * (4 * 8315 + 1 + 3 * 8315)}
    local = TO.launch_cost("local_half_step", B=5, d=130)
    assert local["launches"] == 2
    assert local["bytes"] == (TO.launch_cost("margins", B=5, d=130)["bytes"]
                              + TO.launch_cost("grad_update", B=5, d=130)["bytes"])
    assert TO.launch_cost("dense_predict", B=3299, d=8315, C=1)["flops"] == 2 * 3299 * 8315
    with pytest.raises(ValueError):
        TO.launch_cost("ell_fleet_half_step")


def test_wrappers_refuse_mixed_devices():
    X, W, y = _inputs(2, 100)
    with pytest.raises(ValueError):
        TK.margins(torch.from_numpy(X[0]), torch.from_numpy(W[0]).to("meta"),
                   torch.from_numpy(y[0]))


@pytest.mark.parametrize("n_padded,n_valid", [(8, 5), (4, 4), (3, 0)])
def test_padded_row_mask(n_padded, n_valid):
    np.testing.assert_array_equal(TO.padded_row_mask(n_padded, n_valid).numpy(),
                                  np.asarray(RO.padded_row_mask(n_padded, n_valid)))


@pytest.mark.parametrize("m,n_sm,want", [(10, 132, 8), (1, 132, 16), (32, 132, 4), (33, 132, 4),
                                         (64, 132, 2), (132, 132, 1), (500, 132, 1), (10, 66, 4)])
def test_fleet_cluster_gives_every_block_an_sm(m, n_sm, want):
    """fleet_half_step's cluster size: the largest power of two up to 16 with
    m·CL blocks on at most the card's SMs (8 at the paper's m = 10 on an H100
    SXM's 132), 1 when the nodes alone outnumber the SMs."""
    cl = TK.fleet_cluster(m, n_sm)
    assert cl == want
    assert m * cl <= n_sm or cl == 1
    assert cl == 16 or m * 2 * cl > n_sm


@pytest.mark.parametrize("d,cluster", [(8315, 16), (8315, 8), (1001, 16), (70001, 16), (5, 16),
                                       (1, 1), (129, 16), (1001, 1)])
def test_fleet_column_shares_cover_d_once(d, cluster):
    """fleet_half_step and margins cut d as predict.even_split does: a
    cluster's blocks own contiguous shares that cover [0, d) once, none
    wider than ⌈d / CL⌉ (the shared memory fleet_half_step sizes for X's
    slice), some empty when d < CL."""
    shares = TP.even_split(d, cluster)
    assert shares[0][0] == 0 and shares[-1][1] == d
    assert all(a[1] == b[0] for a, b in zip(shares, shares[1:]))
    assert max(hi - lo for lo, hi in shares) == -(-d // cluster)
    assert sum(hi - lo for lo, hi in shares) == d
