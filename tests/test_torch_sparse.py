"""The port's sparse (padded-ELL) kernels and dispatch against the reference.

On CPU tensors the port's kernel wrappers take their plain versions; the
reference runs its Pallas kernels in interpret mode, on inputs padded as its
own wrapper pads them ((8, 128) planes, W to a block multiple plus, for the
prefetch pair, the zero landing block). Rows have unit norm as the
generator makes them, and sums are taken in another order on each side, so
outputs are compared at 1e-5 absolute.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import svm_objective as R_obj  # noqa: E402
from repro.kernels.hinge_subgrad import ops as RO  # noqa: E402
from repro.kernels.hinge_subgrad import sparse as RS  # noqa: E402
from repro.sparse import formats as R_fmt  # noqa: E402
from repro_torch.core import svm_objective as T_obj  # noqa: E402
from repro_torch.kernels.hinge_subgrad import ops as TO  # noqa: E402
from repro_torch.kernels.hinge_subgrad import ref as T_ref  # noqa: E402
from repro_torch.kernels.hinge_subgrad import sparse as TS  # noqa: E402

ATOL = 1e-5
LAM, T = 1e-2, 7
SHAPES = [(m, B, k) for m in (1, 3) for B in (1, 5) for k in (1, 13)]
D = 1001  # not a multiple of 128 or 512


def _planes(m, B, k, d, seed, pad_row=True, pad_node=False):
    """(cols, vals, W, y) as numpy: unit-norm rows with some pad entries,
    row 2 of every node a pad row (vals 0, y 0) when B > 2, and with
    ``pad_node`` node 1 all pads."""
    rng = np.random.default_rng(seed)
    cols = rng.integers(0, d, size=(m, B, k)).astype(np.int32)
    vals = np.abs(rng.normal(size=(m, B, k))).astype(np.float32)
    if k > 1:
        pad = rng.random((m, B, k)) < 0.25
        pad[..., 0] = False
        cols[pad], vals[pad] = 0, 0.0
    vals /= np.maximum(np.linalg.norm(vals, axis=-1, keepdims=True), 1e-8)
    y = np.where(rng.random((m, B)) < 0.5, -1.0, 1.0).astype(np.float32)
    if pad_row and B > 2:
        cols[:, 2], vals[:, 2], y[:, 2] = 0, 0.0, 0.0
    if pad_node and m > 1:
        cols[1], vals[1], y[1] = 0, 0.0, 0.0
    W = rng.normal(size=(m, d)).astype(np.float32)
    return cols, vals, W, y


def _pad(a, axis, mult):
    widths = [(0, 0)] * a.ndim
    widths[axis] = (0, (-a.shape[axis]) % mult)
    return np.pad(a, widths)


def _ref_planes(cols, vals, y):
    """The planes as the reference's wrapper pads them: B to 8, k to 128."""
    cP = jnp.asarray(_pad(_pad(cols, 1, 8), 2, 128))
    vP = jnp.asarray(_pad(_pad(vals, 1, 8), 2, 128))
    return cP, vP, jnp.asarray(_pad(y, 1, 8))


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _close(port, ref):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=0, atol=ATOL)


def _scal(B):
    s0, s1 = TO.step_scalars(LAM, T, B)
    return (s0, s1), jnp.asarray([s0, s1], jnp.float32)


def _coeff(cols, vals, W, y):
    margins = y * np.einsum("mbk,mbk->mb", vals, np.take_along_axis(
        W, cols.reshape(cols.shape[0], -1), axis=1).reshape(cols.shape))
    return np.where(margins < 1.0, y, 0.0).astype(np.float32)


def _maps(cols, vals, blk_d, n_d_blocks, undersized):
    """The device map at the nodes' largest live count, or one slot short
    of it (then the highest live id is dropped, as in the reference)."""
    m = cols.shape[0]
    live = max(1, max(len(np.unique((c[v != 0] // blk_d))) for c, v in
                      zip(cols.reshape(m, -1), vals.reshape(m, -1))))
    n_blocks_max = max(1, live - 1) if undersized else live
    got = TO.ell_block_map(*_t(cols, vals), blk_d=blk_d, n_d_blocks=n_d_blocks,
                           n_blocks_max=n_blocks_max).numpy()
    return got


# ------------------------------------------------------------ sweep kernels

@pytest.mark.parametrize("m,B,k", SHAPES)
def test_ell_margins_plain_matches_reference_kernel(m, B, k):
    cols, vals, W, y = _planes(m, B, k, D, seed=m * 100 + B * 10 + k, pad_node=True)
    cP, vP, yP = _ref_planes(cols, vals, y)
    ref = RS.ell_margins(cP, vP, jnp.asarray(_pad(W, 1, 512)), yP, blk_d=512,
                         interpret=True)[:, :B]
    _close(TS.ell_margins(*_t(cols, vals, W, y)), ref)


@pytest.mark.parametrize("m,B,k", SHAPES)
def test_ell_grad_update_plain_matches_reference_kernel(m, B, k, blk_d=512):
    cols, vals, W, y = _planes(m, B, k, D, seed=m * 100 + B * 10 + k + 1, pad_node=True)
    coeff = _coeff(cols, vals, W, y)
    scal, scal_j = _scal(B)
    cP, vP, _ = _ref_planes(cols, vals, y)
    ref = RS.ell_grad_update(cP, vP, jnp.asarray(_pad(W, 1, blk_d)),
                             jnp.asarray(_pad(coeff, 1, 8)), scal_j, blk_d=blk_d,
                             interpret=True)[:, :D]
    _close(TS.ell_grad_update(*_t(cols, vals, W, coeff), scal, blk_d=blk_d), ref)


@pytest.mark.parametrize("blk_d", [128, 512, 1000])
@pytest.mark.parametrize("case", ["shared_columns", "pad_node"])
def test_ell_grad_update_plain_matches_reference_at_any_blk_d(case, blk_d):
    """The sweep grad against the reference's at each of its tile widths:
    rows sharing columns (several entries on one lane, summed in entry
    order) or a node of pads only. The port's tile is its own, so one
    result must hold for every ``blk_d`` the reference takes."""
    m, B, k = 3, 5, 13
    cols, vals, W, y = _planes(m, B, k, D, seed=blk_d + len(case), pad_node=case == "pad_node")
    if case == "shared_columns":
        cols[0, :, 0] = 17            # every row of node 0 on lane 17
        cols[2, 0, 1] = cols[2, 1, 1] = 1000  # the last column, twice
        vals[2, 0, 1] = vals[2, 1, 1] = 0.25
    coeff = _coeff(cols, vals, W, y)
    scal, scal_j = _scal(B)
    cP, vP, _ = _ref_planes(cols, vals, y)
    ref = RS.ell_grad_update(cP, vP, jnp.asarray(_pad(W, 1, blk_d)),
                             jnp.asarray(_pad(coeff, 1, 8)), scal_j, blk_d=blk_d,
                             interpret=True)[:, :D]
    got = TS.ell_grad_update(*_t(cols, vals, W, coeff), scal, blk_d=blk_d)
    _close(got, ref)
    assert torch.equal(got, TS.ell_grad_update_plain(*_t(cols, vals, W, coeff), scal))


def test_ell_grad_update_checks_blk_d_and_counts_no_cpu_launch():
    """``blk_d`` is checked on every device to be at least 1, as the
    reference needs, and any width above that gives one result; on CPU
    tensors the plain version runs and no launch is counted."""
    cols, vals, W, y = _t(*_planes(2, 3, 4, 300, seed=1))
    coeff = torch.from_numpy(_coeff(*(a.numpy() for a in (cols, vals, W, y))))
    scal, _ = _scal(3)
    for blk_d in (0, -1):
        with pytest.raises(ValueError, match="blk_d"):
            TS.ell_grad_update(cols, vals, W, coeff, scal, blk_d=blk_d)
    want = TS.ell_grad_update_plain(cols, vals, W, coeff, scal)
    for blk_d in (1, 1024, 2048):
        assert torch.equal(TS.ell_grad_update(cols, vals, W, coeff, scal, blk_d=blk_d), want)
    assert TS.ell_grad_update.launches == 0
    with pytest.raises(ValueError, match="devices"):
        TS.ell_grad_update(cols, vals, W.to("meta"), coeff, scal)


# --------------------------------------------------------- prefetch kernels

@pytest.mark.parametrize("undersized", [False, True], ids=["sound", "undersized"])
@pytest.mark.parametrize("m,B,k", SHAPES)
def test_ell_margins_prefetch_plain_matches_reference_kernel(m, B, k, undersized):
    blk_d = 128
    n_d_blocks = -(-D // blk_d)
    cols, vals, W, y = _planes(m, B, k, D, seed=m * 100 + B * 10 + k + 2, pad_node=True)
    bids = _maps(cols, vals, blk_d, n_d_blocks, undersized)
    cP, vP, yP = _ref_planes(cols, vals, y)
    WP = jnp.asarray(np.pad(_pad(W, 1, blk_d), ((0, 0), (0, blk_d))))  # + zero landing block
    ref = RS.ell_margins_prefetch(cP, vP, WP, yP, jnp.asarray(bids), blk_d=blk_d,
                                  n_d_blocks=n_d_blocks, interpret=True)[:, :B]
    port = TS.ell_margins_prefetch(*_t(cols, vals, W, y, bids), blk_d=blk_d,
                                   n_d_blocks=n_d_blocks)
    _close(port, ref)
    if undersized and k > 1 and B > 1:  # the cut map really dropped entries
        assert not np.allclose(port.numpy(), TS.ell_margins(*_t(cols, vals, W, y)).numpy())


@pytest.mark.parametrize("undersized", [False, True], ids=["sound", "undersized"])
@pytest.mark.parametrize("m,B,k", SHAPES)
def test_ell_grad_update_prefetch_plain_matches_reference_kernel(m, B, k, undersized):
    blk_d = 128
    n_d_blocks = -(-D // blk_d)
    cols, vals, W, y = _planes(m, B, k, D, seed=m * 100 + B * 10 + k + 3, pad_node=True)
    coeff = _coeff(cols, vals, W, y)
    bids = _maps(cols, vals, blk_d, n_d_blocks, undersized)
    cP, vP, _ = _ref_planes(cols, vals, y)
    ref = RS.ell_grad_update_prefetch(cP, vP, jnp.asarray(_pad(coeff, 1, 8)),
                                      jnp.asarray(bids), blk_d=blk_d,
                                      n_d_blocks=n_d_blocks, interpret=True)
    port = TS.ell_grad_update_prefetch(*_t(cols, vals, coeff, bids), blk_d=blk_d,
                                       n_d_blocks=n_d_blocks)
    assert port.shape == ref.shape
    _close(port, ref)
    if m > 1:  # the all-pad node's map is all sentinel, its buckets zero
        assert (bids[1] == n_d_blocks).all() and not port[1].any()


def _coeff_case(case, m, B, k):
    """(cols, vals, W, y, bids, n_d_blocks) as numpy for the coefficient
    entry: ``sound`` and ``undersized`` maps over planes with pad entries,
    pad rows (B > 2) and an all-pad node (m > 1); ``nan`` a NaN value in
    row 0 of node 0, whose margin is then NaN."""
    blk_d = 128
    n_d_blocks = -(-D // blk_d)
    cols, vals, W, y = _planes(m, B, k, D, seed=m * 100 + B * 10 + k + 5, pad_node=True)
    if case == "nan":
        vals[0, 0, 0] = np.nan
    bids = _maps(cols, np.nan_to_num(vals, nan=1.0), blk_d, n_d_blocks, case == "undersized")
    return cols, vals, W, y, bids, n_d_blocks


@pytest.mark.parametrize("case", ["sound", "undersized", "nan"])
@pytest.mark.parametrize("m,B,k", [(3, 5, 13), (1, 1, 76)])
def test_ell_margins_prefetch_coeff_plain_matches_reference(case, m, B, k):
    """The coefficient entry's plain version against the reference's
    prefetch margins kernel (interpret mode) followed by its
    ``jnp.where(margins < 1, y, 0)``: margins at 1e-5 (NaN where the
    reference has NaN), coefficients equal wherever the margin is not
    within 1e-5 of 1; and the coefficients are bit for bit
    ``torch.where`` of the margins the entry returns."""
    blk_d = 128
    cols, vals, W, y, bids, n_d_blocks = _coeff_case(case, m, B, k)
    cP, vP, yP = _ref_planes(cols, vals, y)
    WP = jnp.asarray(np.pad(_pad(W, 1, blk_d), ((0, 0), (0, blk_d))))  # + zero landing block
    ref_m = RS.ell_margins_prefetch(cP, vP, WP, yP, jnp.asarray(bids), blk_d=blk_d,
                                    n_d_blocks=n_d_blocks, interpret=True)
    ref_c = np.asarray(jnp.where(ref_m < 1.0, yP, 0.0))[:, :B]
    ref_m = np.asarray(ref_m)[:, :B]
    tc, tv, tW, ty, tb = _t(cols, vals, W, y, bids)
    margins, coeff = TS.ell_margins_prefetch_coeff(tc, tv, tW, ty, tb, blk_d=blk_d,
                                                   n_d_blocks=n_d_blocks)
    np.testing.assert_allclose(margins.numpy(), ref_m, rtol=0, atol=ATOL)
    sure = ~(np.abs(ref_m - 1.0) <= ATOL)  # NaN margins included: both give 0
    np.testing.assert_array_equal(coeff.numpy()[sure], ref_c[sure])
    assert torch.equal(coeff, torch.where(margins < 1.0, ty, torch.zeros_like(ty)))
    torch.testing.assert_close(margins, TS.ell_margins_prefetch(
        tc, tv, tW, ty, tb, blk_d=blk_d, n_d_blocks=n_d_blocks), rtol=0, atol=0, equal_nan=True)
    if B > 2:  # pad rows: y = 0, margin 0 < 1, coefficient 0
        assert not coeff[:, 2].any()
    if m > 1:  # the all-pad node: every margin and coefficient 0
        assert (bids[1] == n_d_blocks).all() and not margins[1].any() and not coeff[1].any()
    if case == "nan":
        assert np.isnan(ref_m[0, 0]) and torch.isnan(margins[0, 0]) and coeff[0, 0] == 0


def test_plain_versions_agree_with_oracle():
    """The sweep and the prefetch pair at a sound map, composed as the
    dispatch composes them, equal the plain fleet oracle."""
    cols, vals, W, y = _planes(3, 5, 13, D, seed=11)
    want = T_ref.ell_fleet_half_step_ref(*_t(W, cols, vals, y), LAM, T, project=False)
    for schedule in ("sweep", "prefetch"):
        got = TO.ell_fleet_half_step(*_t(W, cols, vals, y), lam=LAM, t=T, project=False,
                                     schedule=schedule)
        torch.testing.assert_close(got, want, rtol=0, atol=ATOL)
    for i in range(3):
        torch.testing.assert_close(
            T_ref.ell_margins_ref(*_t(W[i], cols[i], vals[i], y[i])),
            TS.ell_margins(*_t(cols, vals, W, y))[i], rtol=0, atol=ATOL)


@pytest.mark.parametrize("case", ["sound", "nan"])
@pytest.mark.parametrize("m,B,k", [(3, 5, 13), (1, 1, 76)])
def test_ell_margins_coeff_plain_matches_reference(case, m, B, k):
    """The sweep's coefficient entry against the reference's sweep margins
    kernel (interpret mode) followed by its ``jnp.where(margins < 1, y, 0)``:
    margins at 1e-5 (NaN where the reference has NaN), coefficients equal
    wherever the margin is not within 1e-5 of 1; the coefficients are bit
    for bit ``torch.where`` of the margins the entry returns, and the
    margins bit for bit ``ell_margins``'. Pad rows (B > 2) and an all-pad
    node (m > 1) included; ``nan`` puts a NaN value in row 0 of node 0."""
    cols, vals, W, y = _planes(m, B, k, D, seed=m * 100 + B * 10 + k + 7, pad_node=True)
    if case == "nan":
        vals[0, 0, 0] = np.nan
    cP, vP, yP = _ref_planes(cols, vals, y)
    ref_m = RS.ell_margins(cP, vP, jnp.asarray(_pad(W, 1, 512)), yP, blk_d=512, interpret=True)
    ref_c = np.asarray(jnp.where(ref_m < 1.0, yP, 0.0))[:, :B]
    ref_m = np.asarray(ref_m)[:, :B]
    tc, tv, tW, ty = _t(cols, vals, W, y)
    margins, coeff = TS.ell_margins_coeff(tc, tv, tW, ty)
    np.testing.assert_allclose(margins.numpy(), ref_m, rtol=0, atol=ATOL)
    sure = ~(np.abs(ref_m - 1.0) <= ATOL)  # NaN margins included: both give 0
    np.testing.assert_array_equal(coeff.numpy()[sure], ref_c[sure])
    assert torch.equal(coeff, torch.where(margins < 1.0, ty, torch.zeros_like(ty)))
    torch.testing.assert_close(margins, TS.ell_margins(tc, tv, tW, ty), rtol=0, atol=0,
                               equal_nan=True)
    if B > 2:  # pad rows: y = 0, margin 0 < 1, coefficient 0
        assert not coeff[:, 2].any()
    if m > 1:  # the all-pad node: every margin and coefficient 0
        assert not margins[1].any() and not coeff[1].any()
    if case == "nan":
        assert np.isnan(ref_m[0, 0]) and torch.isnan(margins[0, 0]) and coeff[0, 0] == 0


# ------------------------------------------------------------ dispatch layer

@pytest.mark.parametrize("blk_d", [128, 512])
@pytest.mark.parametrize("m,B,k,d", [(3, 5, 13, 1001), (2, 4, 30, 300), (2, 3, 1, 200),
                                     (4, 8, 40, 5000)])
def test_ell_block_map_matches_reference(m, B, k, d, blk_d):
    cols, vals, _, _ = _planes(m, B, k, d, seed=d + k, pad_node=True)
    n_d_blocks = -(-d // blk_d)
    bound = R_fmt.minibatch_block_bound(cols, vals, B, blk_d, d=d)
    for n_blocks_max in (bound, max(1, bound - 2), n_d_blocks + 3):
        got = TO.ell_block_map(*_t(cols, vals), blk_d=blk_d, n_d_blocks=n_d_blocks,
                               n_blocks_max=n_blocks_max)
        want = RO.ell_block_map(jnp.asarray(cols), jnp.asarray(vals), blk_d=blk_d,
                                n_d_blocks=n_d_blocks, n_blocks_max=n_blocks_max)
        assert got.dtype == torch.int32 and got.shape == (m, n_blocks_max)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        if n_blocks_max >= bound:
            np.testing.assert_array_equal(
                got.numpy(), R_fmt.block_map(cols, vals, blk_d, n_d_blocks, n_blocks_max))


def test_resolve_ell_schedule_matches_reference():
    grid = [(s, B, k, d, nbm, blk)
            for s in ("auto", "prefetch", "sweep")
            for B in (1, 4, 8, 33)
            for k in (0, 1, 76, 129, 600)
            for d in (130, 1001, 8315, 47236)
            for nbm in (None, 1, 35, 400)
            for blk in (None, 128, 256)]
    for s, B, k, d, nbm, blk in grid:
        assert (TO.resolve_ell_schedule(s, B=B, k=k, d=d, n_blocks_max=nbm, blk_d=blk)
                == RO.resolve_ell_schedule(s, B=B, k=k, d=d, n_blocks_max=nbm, blk_d=blk)), \
            (s, B, k, d, nbm, blk)
    assert TO.resolve_ell_schedule("auto", B=1, k=76, d=47236, n_blocks_max=35) \
        == ("prefetch", 128, 35)
    with pytest.raises(ValueError, match="schedule"):
        TO.resolve_ell_schedule("dense", B=1, k=1, d=10)


@pytest.mark.parametrize("project", [True, False], ids=["project", "no_project"])
@pytest.mark.parametrize("schedule", ["sweep", "prefetch", "auto"])
def test_ell_fleet_half_step_matches_reference(schedule, project):
    m, B, k, d = 3, 5, 13, 1001
    cols, vals, W, y = _planes(m, B, k, d, seed=21, pad_node=True)
    W *= 0.3
    bound = R_fmt.minibatch_block_bound(cols, vals, B, d=d)
    ref = RO.ell_fleet_half_step(jnp.asarray(W), jnp.asarray(cols), jnp.asarray(vals),
                                 jnp.asarray(y), lam=LAM, t=jnp.float32(T), project=project,
                                 interpret=True, schedule=schedule, n_blocks_max=bound)
    port = TO.ell_fleet_half_step(*_t(W, cols, vals, y), lam=LAM, t=T, project=project,
                                  schedule=schedule, n_blocks_max=bound)
    _close(port, ref)


@pytest.mark.parametrize("m,B,k,d,cut", [(3, 5, 13, 1001, 0), (3, 5, 13, 1001, 1),
                                         (4, 1, 76, 5000, 0), (1, 1, 76, 5000, 0),
                                         (1, 4, 76, 5000, 2), (2, 16, 30, 3000, 0),
                                         (2, 2, 200, 3000, 0), (3, 5, 13, 1001, 3),
                                         (2, 8, 7, 9000, 0), (5, 3, 1, 640, 0),
                                         (2, 33, 5, 1001, 1)])
def test_ell_fleet_half_step_prefetch_matches_reference(m, B, k, d, cut):
    """The prefetch schedule (``ell_grad_update_fused``: on the CPU the
    map, the coefficient entry and the fold entry) against the reference's
    at 1e-5, at a sound map and ``cut`` slots short of the data's bound, one
    node to five, B from 1 to 33 and k from 1 to 200."""
    cols, vals, W, y = _planes(m, B, k, d, seed=31 + k, pad_node=True)
    W *= 0.3
    bound = R_fmt.minibatch_block_bound(cols, vals, B, d=d) - cut
    ref = RO.ell_fleet_half_step(jnp.asarray(W), jnp.asarray(cols), jnp.asarray(vals),
                                 jnp.asarray(y), lam=LAM, t=jnp.float32(T), interpret=True,
                                 schedule="prefetch", n_blocks_max=bound)
    port = TO.ell_fleet_half_step(*_t(W, cols, vals, y), lam=LAM, t=T, schedule="prefetch",
                                  n_blocks_max=bound)
    _close(port, ref)


def test_prefetch_dispatch_runs_the_coefficient_entry(monkeypatch):
    """On the CPU the prefetch schedule's fused entry runs the chain it
    replaces on the card, which takes its coefficients from
    ``ell_margins_prefetch_coeff``: the margins-only entry is not called."""
    calls = []
    coeff_entry = TS.ell_margins_prefetch_coeff

    def counted(*args, **kwargs):
        calls.append("coeff")
        return coeff_entry(*args, **kwargs)

    def refused(*args, **kwargs):
        raise AssertionError("the prefetch path called ell_margins_prefetch")

    monkeypatch.setattr(TS, "ell_margins_prefetch_coeff", counted)
    monkeypatch.setattr(TS, "ell_margins_prefetch", refused)
    cols, vals, W, y = _planes(3, 5, 13, D, seed=12)
    TO.ell_fleet_half_step(*_t(W, cols, vals, y), lam=LAM, t=T, schedule="prefetch")
    assert calls == ["coeff"]


def test_sweep_dispatch_runs_the_coefficient_entry(monkeypatch):
    """The sweep schedule takes its coefficients from ``ell_margins_coeff``,
    once: the margins-only entry is not called."""
    calls = []
    coeff_entry = TS.ell_margins_coeff

    def counted(*args, **kwargs):
        calls.append("coeff")
        return coeff_entry(*args, **kwargs)

    def refused(*args, **kwargs):
        raise AssertionError("the sweep path called ell_margins")

    monkeypatch.setattr(TS, "ell_margins_coeff", counted)
    monkeypatch.setattr(TS, "ell_margins", refused)
    cols, vals, W, y = _planes(3, 5, 13, D, seed=13)
    TO.ell_fleet_half_step(*_t(W, cols, vals, y), lam=LAM, t=T, schedule="sweep")
    assert calls == ["coeff"]


@pytest.mark.parametrize("schedule", ["sweep", "prefetch"])
def test_ell_fleet_half_step_k_zero_matches_reference(schedule):
    m, B, d = 2, 3, 200
    W = np.random.default_rng(3).normal(size=(m, d)).astype(np.float32)
    cols, vals = np.zeros((m, B, 0), np.int32), np.zeros((m, B, 0), np.float32)
    y = np.zeros((m, B), np.float32)
    ref = RO.ell_fleet_half_step(jnp.asarray(W), jnp.asarray(cols), jnp.asarray(vals),
                                 jnp.asarray(y), lam=LAM, t=jnp.float32(T), interpret=True,
                                 schedule=schedule)
    port = TO.ell_fleet_half_step(*_t(W, cols, vals, y), lam=LAM, t=T, schedule=schedule)
    _close(port, ref)


def test_fold_drops_sentinel_and_tail_lanes():
    """The prefetch fold adds live buckets only: a bucket lane past d and a
    sentinel bucket change nothing, and the rest of W is only decayed."""
    m, d, blk_d = 2, 300, 128
    W = torch.arange(m * d, dtype=torch.float32).reshape(m, d)
    G = torch.ones((m, 2, blk_d))
    bids = torch.tensor([[2, 3], [0, 3]], dtype=torch.int32)  # 3 = sentinel
    got = TS.fold_buckets(W, G, bids, blk_d, 0.5, 2.0)
    want = 0.5 * W
    want[0, 256:300] += 2.0
    want[1, 0:128] += 2.0
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def _fold_case(case):
    """(cols, vals, coeff, bids, W, n_d_blocks) as numpy for one edge of the
    fused prefetch grad, blk_d 128 and d = 1001 (the last block 896..1023
    runs past d): ``sentinel`` a map wider than the live count (sentinel
    slots), ``tail`` entries at the last columns below d, ``undersized`` a
    map one slot short, ``pad_node`` an all-pad node (all-sentinel map),
    ``k0`` no entries at all."""
    blk_d, d = 128, D
    n_d_blocks = -(-d // blk_d)
    k = 0 if case == "k0" else 13
    cols, vals, W, y = _planes(3, 5, k, d, seed=41, pad_node=case == "pad_node")
    if case == "tail":
        cols[:, :, 0] = d - 1 - np.arange(5)[None, :]
    coeff = np.where(np.arange(5)[None, :] % 2 == 0, y, 0.0).astype(np.float32)
    if case == "undersized":
        bids = _maps(cols, vals, blk_d, n_d_blocks, undersized=True)
    else:
        live = max(1, max(len(np.unique(c[v != 0] // blk_d)) for c, v in
                          zip(cols.reshape(3, -1), vals.reshape(3, -1))))
        wide = live + 3 if case == "sentinel" else live
        bids = TO.ell_block_map(*_t(cols, vals), blk_d=blk_d, n_d_blocks=n_d_blocks,
                                n_blocks_max=wide).numpy()
    return cols, vals, coeff, bids, W, n_d_blocks


@pytest.mark.parametrize("case", ["sentinel", "tail", "undersized", "pad_node", "k0"])
def test_fused_prefetch_grad_is_buckets_then_fold(case):
    """The fused entry's plain version is bit for bit the G entry's plain
    version followed by ``fold_buckets``, which the kernel must reproduce;
    and both are W_half = (1 − s0)·W + s1·scatter of the entries whose block
    is in the map, computed here in float64."""
    cols, vals, coeff, bids, W, n_d_blocks = _fold_case(case)
    (s0, s1), _ = _scal(5)
    om = float(np.float32(1) - np.float32(s0))
    tc, tv, tcf, tb, tW = _t(cols, vals, coeff, bids, W)
    got = TS.ell_grad_update_prefetch_fold(tc, tv, tcf, tb, tW, (s0, s1), blk_d=128,
                                           n_d_blocks=n_d_blocks)
    G = TS.ell_grad_update_prefetch(tc, tv, tcf, tb, blk_d=128, n_d_blocks=n_d_blocks)
    assert torch.equal(got, TS.fold_buckets(tW, G, tb, 128, om, s1))
    want = om * W.astype(np.float64)
    for i in range(3):
        live = set(bids[i][bids[i] < n_d_blocks].tolist())
        for b, e in np.ndindex(cols.shape[1:]):
            if cols[i, b, e] // 128 in live:
                want[i, cols[i, b, e]] += s1 * float(coeff[i, b]) * float(vals[i, b, e])
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    if case == "pad_node":  # the all-sentinel node is only decayed
        assert (bids[1] == n_d_blocks).all()
        assert torch.equal(got[1], tW[1] * om)
    if case == "undersized":  # the dropped block's lanes are only decayed
        assert not np.allclose(got.numpy(), TS.ell_grad_update_prefetch_fold(
            tc, tv, tcf, torch.from_numpy(_maps(cols, vals, 128, n_d_blocks, False)), tW,
            (s0, s1), blk_d=128, n_d_blocks=n_d_blocks).numpy())


def test_launch_cost_fused_prefetch_grad():
    """The fused entry reads the entries, coeff, the map and W once and
    writes W_half once: 3.79 MB at CCAT's (10, 1, 76), d 47,236, map 36."""
    cost = TO.launch_cost("ell_grad_update_prefetch_fold", m=10, B=1, k=76, d=47236,
                          n_blocks_max=36, blk_d=128)
    assert cost == {"launches": 1, "bytes": 4 * (2 * 760 + 10 + 360 + 2 * 10 * 47236),
                    "flops": 2 * 760 + 3 * 10 * 47236}
    assert cost["bytes"] == 3786440


def test_launch_cost_margins_prefetch_coeff():
    """The coefficient entry moves what the margins entry moves plus the
    m·B coefficients it writes; its operations are the margins'."""
    shape = dict(m=10, B=1, k=76, n_blocks_max=36)
    margins = TO.launch_cost("ell_margins_prefetch", **shape)
    cost = TO.launch_cost("ell_margins_prefetch_coeff", **shape)
    assert cost == {"launches": 1, "bytes": 4 * (3 * 760 + 2 * 10 + 360 + 10),
                    "flops": 2 * 760 + 10}
    assert cost["bytes"] == margins["bytes"] + 4 * 10 and cost["flops"] == margins["flops"]


def test_launch_cost_margins_coeff():
    """The sweep's coefficient entry moves what ``ell_margins`` moves plus
    the m·B coefficients it writes; its operations are the margins'."""
    shape = dict(m=10, B=1, k=76)
    margins = TO.launch_cost("ell_margins", **shape)
    cost = TO.launch_cost("ell_margins_coeff", **shape)
    assert cost == {"launches": 1, "bytes": margins["bytes"] + 4 * 10,
                    "flops": margins["flops"]}
    assert cost["bytes"] == 4 * (3 * 760 + 2 * 10 + 10)


def test_primal_objective_masked_ell_matches_reference():
    cols, vals, _, y = _planes(1, 40, 9, D, seed=5, pad_row=False)
    cols, vals, y = cols[0], vals[0], y[0]
    valid = np.arange(40) < 33
    y[33:] = 0.0
    w = np.random.default_rng(6).normal(size=D).astype(np.float32) * 0.2
    ref = R_obj.primal_objective_masked_ell(jnp.asarray(w), jnp.asarray(cols),
                                            jnp.asarray(vals), jnp.asarray(y), 1e-3,
                                            jnp.asarray(valid), jnp.float32(33))
    got = T_obj.primal_objective_masked_ell(*_t(w, cols, vals, y), 1e-3,
                                            torch.from_numpy(valid), torch.tensor(33.0))
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)
    X = R_fmt.ELL(cols, vals, (40, D)).to_dense()
    dense = T_obj.primal_objective_masked(*_t(w, X, y), 1e-3, torch.from_numpy(valid),
                                          torch.tensor(33.0))
    np.testing.assert_allclose(float(got), float(dense), rtol=1e-6)


def test_ell_matvec_flat_matches_dense():
    cols, vals, _, _ = _planes(1, 20, 7, 300, seed=8, pad_row=False)
    X = R_fmt.ELL(cols[0], vals[0], (20, 300)).to_dense()
    w = np.random.default_rng(9).normal(size=300).astype(np.float32)
    torch.testing.assert_close(T_ref.ell_matvec_flat(*_t(w, cols[0], vals[0])),
                               torch.from_numpy(X @ w), rtol=0, atol=ATOL)


def test_wrappers_refuse_bad_inputs():
    cols, vals, W, y = _t(*_planes(2, 3, 4, 300, seed=1))
    with pytest.raises(ValueError, match="devices"):
        TS.ell_margins(cols, vals, W.to("meta"), y)
    assert TS.ell_margins.launches == 0 and TS.ell_grad_update_prefetch.launches == 0
    assert TS.ell_grad_update_prefetch_fold.launches == 0


def test_coefficient_entry_refuses_bad_inputs_and_counts_no_cpu_launch():
    """On CPU tensors the coefficient entry takes its plain version and
    counts no launch; a meta tensor or tensors on two devices raise."""
    cols, vals, W, y = _t(*_planes(2, 3, 4, 300, seed=1))
    bids = TO.ell_block_map(cols, vals, blk_d=128, n_d_blocks=3, n_blocks_max=3)
    before = TS.ell_margins_prefetch_coeff.launches
    margins, coeff = TS.ell_margins_prefetch_coeff(cols, vals, W, y, bids, blk_d=128,
                                                   n_d_blocks=3)
    assert margins.shape == coeff.shape == (2, 3)
    assert TS.ell_margins_prefetch_coeff.launches == before == 0
    with pytest.raises(ValueError, match="devices"):
        TS.ell_margins_prefetch_coeff(cols, vals, W.to("meta"), y, bids, blk_d=128,
                                      n_d_blocks=3)
    with pytest.raises(ValueError, match="unsupported device"):
        TS.ell_margins_prefetch_coeff(*(x.to("meta") for x in (cols, vals, W, y, bids)),
                                      blk_d=128, n_d_blocks=3)
    assert TS.ell_margins_prefetch_coeff.launches == 0


def test_check_bitmap_refuses_a_map_short_of_d():
    """The map kernels look up the d-block of any column below d in their
    bitmap, so ``n_d_blocks`` must cover d: one block short raises, as does
    a bitmap past a block's shared memory; CCAT's 370 blocks of 128 pass."""
    TS.check_bitmap(370, 47236, 128)
    TS.check_bitmap(1, 128, 128)
    with pytest.raises(ValueError, match="covers fewer"):
        TS.check_bitmap(369, 47236, 128)
    with pytest.raises(ValueError, match="out of range"):
        TS.check_bitmap(0)
    with pytest.raises(ValueError, match="out of range"):
        TS.check_bitmap(8 * 227 * 1024 + 1)
