"""The port's dense half-step functions against the reference's Pallas
kernels, run in interpret mode. On CPU tensors the port's wrappers take
their kernels' plain versions, which is what these tests hold to the
reference (the CUDA kernels themselves are held to the plain versions on
the card by chip_smoke.py)."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.hinge_subgrad import hinge_subgrad as RK  # noqa: E402
from repro.kernels.hinge_subgrad import ops as RO  # noqa: E402
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
                                       (1, 1)])
def test_fleet_column_shares_cover_d_once(d, cluster):
    """The kernel cuts d as predict.even_split does: the cluster's blocks own
    contiguous shares that cover [0, d) once, none wider than ⌈d / CL⌉ (the
    shared memory the kernel sizes for X's slice), some empty when d < CL."""
    shares = TP.even_split(d, cluster)
    assert shares[0][0] == 0 and shares[-1][1] == d
    assert all(a[1] == b[0] for a, b in zip(shares, shares[1:]))
    assert max(hi - lo for lo, hi in shares) == -(-d // cluster)
    assert sum(hi - lo for lo, hi in shares) == d
