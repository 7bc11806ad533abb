"""The fused touched-block half-step (``sparse.ell_grad_update_fused``),
the prefetch schedule's whole half-step, against the chain it replaces on
the path: the touched-block map (``ops.ell_block_map``), then
``ell_margins_prefetch_coeff`` and ``ell_grad_update_prefetch_fold``. W_half
must be the same bits.

On the CPU the fused entry runs that chain (each wrapper its plain
version), so the CPU tests here hold the dispatch, the route and the launch
accounting; ``test_torch_sparse.py`` holds the prefetch schedule to the
reference. The tests marked ``chip`` hold the CUDA kernel to the CUDA chain
on the card and skip without one:
``PYTHONPATH=src python -m pytest tests/test_torch_ell_fused.py -m chip``.
This file imports nothing of JAX.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import gadget as TG  # noqa: E402
from repro_torch.core.svm_objective import project_ball  # noqa: E402
from repro_torch.kernels.hinge_subgrad import hinge_subgrad as TK  # noqa: E402
from repro_torch.kernels.hinge_subgrad import ops as TO  # noqa: E402
from repro_torch.kernels.hinge_subgrad import sparse as TS  # noqa: E402
from repro_torch.sparse.formats import minibatch_block_bound  # noqa: E402
from repro_torch import telemetry as ttm  # noqa: E402

CCAT_D, CCAT_K = 47236, 76
KDDA_D, KDDA_K = 20216830, 36
PLAIN_RTOL = 1e-5  # kernel against the plain chain: max |diff| / max(1, max |plain|)


def _planes(m, B, k, d, seed, *, zipf=False, pad_row=True, pad_node=False):
    """(cols int32, vals, W, y) as numpy: unit-norm rows with 25% pad
    entries (0, 0), row 2 a pad row (y = 0) when B > 2, with ``pad_node``
    node 1 all pads; ``zipf`` draws each row's k distinct columns with
    CCAT's skew (popularity ~ rank^-1.25) and no pads."""
    rng = np.random.default_rng(seed)
    if zipf:
        p = 1.0 / np.arange(1, d + 1) ** 1.25
        p /= p.sum()
        cols = np.stack([rng.choice(d, size=k, replace=False, p=p)
                         for _ in range(m * B)]).reshape(m, B, k).astype(np.int32)
        vals = np.abs(rng.normal(size=(m, B, k))).astype(np.float32)
    else:
        cols = rng.integers(0, d, size=(m, B, k)).astype(np.int32)
        vals = np.abs(rng.normal(size=(m, B, k))).astype(np.float32)
        pad = rng.random((m, B, k)) < 0.25
        cols[pad], vals[pad] = 0, 0.0
    vals /= np.maximum(np.linalg.norm(vals, axis=-1, keepdims=True), 1e-8)
    y = np.where(rng.random((m, B)) < 0.5, -1.0, 1.0).astype(np.float32)
    if pad_row and B > 2:
        cols[:, 2], vals[:, 2], y[:, 2] = 0, 0.0, 0.0
    if pad_node and m > 1:
        cols[1], vals[1], y[1] = 0, 0.0, 0.0
    W = (3 * rng.normal(size=(m, d))).astype(np.float32)  # some rows violate, some not
    return cols, vals, W, y


def _case(name):
    """(cols, vals, W, y, blk_d, n_blocks_max) of one edge of the route."""
    blk_d = 100 if name == "odd_blk_d" else 128
    if name in ("ccat", "ccat_undersized"):
        cols, vals, W, y = _planes(10, 1, CCAT_K, CCAT_D, seed=1, zipf=True)
    else:
        cols, vals, W, y = _planes(3, 5, 13, 1001, seed=2, pad_node=True)
    d = W.shape[1]
    if name == "outside":  # columns past d: in the last block, past every block, negative
        cols[0, 0, :3] = [d + 5, -(-d // blk_d) * blk_d + 7, 10 ** 6]
        cols[0, 1, 0] = -3
        vals[0, :2, :3] = 0.5
    bound = minibatch_block_bound(cols.reshape(cols.shape[0], -1, cols.shape[-1]), vals,
                                  cols.shape[1], d=d, blk_d=blk_d)
    cap = {"ccat_undersized": bound - 3, "undersized": bound - 1, "one_slot": 1,
           "wide_map": -(-d // blk_d)}.get(name, bound)
    return cols, vals, W, y, blk_d, cap


CASES = ["ccat", "ccat_undersized", "minibatch", "undersized", "one_slot", "wide_map",
         "outside", "odd_blk_d"]


def _t(*arrays, device="cpu"):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays]


def _chain(cols, vals, W, y, scal, *, blk_d, n_blocks_max):
    """The two-kernel route: the map, the coefficient entry, the fold entry.
    A column outside [0, d) counts for nothing in the CUDA pair, and its
    block marks the map only where it lies inside the blocks (the map cannot
    take one outside: the fused rule marks nothing for it)."""
    d = W.shape[1]
    n_d = -(-d // blk_d)
    in_blocks = (cols >= 0) & (cols < n_d * blk_d)
    bids = TO.ell_block_map(cols, torch.where(in_blocks, vals, torch.zeros_like(vals)),
                            blk_d=blk_d, n_d_blocks=n_d, n_blocks_max=n_blocks_max)
    _, coeff = TS.ell_margins_prefetch_coeff(cols, vals, W, y, bids, blk_d=blk_d, n_d_blocks=n_d)
    return TS.ell_grad_update_prefetch_fold(cols, vals, coeff, bids, W, scal, blk_d=blk_d,
                                            n_d_blocks=n_d)


def _plain_chain(cols, vals, W, y, scal, *, blk_d, n_blocks_max):
    """The chain in plain PyTorch: the map, then the plain versions of the
    coefficient and fold entries (what the wrapper runs on the CPU)."""
    n_d = -(-W.shape[1] // blk_d)
    bids = TO.ell_block_map(cols, vals, blk_d=blk_d, n_d_blocks=n_d, n_blocks_max=n_blocks_max)
    _, coeff = TS.ell_margins_prefetch_coeff_plain(cols, vals, W, y, bids, blk_d=blk_d,
                                                   n_d_blocks=n_d)
    return TS.ell_grad_update_prefetch_fold_plain(cols, vals, coeff, bids, W, scal, blk_d=blk_d,
                                                  n_d_blocks=n_d)


def _fused(cols, vals, W, y, scal, *, blk_d, n_blocks_max):
    return TS.ell_grad_update_fused(cols, vals, W, y, scal, blk_d=blk_d,
                                    n_d_blocks=-(-W.shape[1] // blk_d), n_blocks_max=n_blocks_max)


# ----------------------------------------------------------------- the CPU

def _spy(monkeypatch, names):
    """Record the calls of the kernel entries ``names`` (in order; the
    sparse ``ell_*`` entries and the dense ones) in the returned list; each
    still runs."""
    calls = []

    def counted(name):
        owner = TS if name.startswith("ell_") else TK
        entry = getattr(owner, name)

        def call(*args, **kwargs):
            calls.append(name)
            return entry(*args, **kwargs)
        monkeypatch.setattr(owner, name, call)
    for name in names:
        counted(name)
    return calls


@pytest.mark.parametrize("case,schedule,B,k,fused", [
    ("ccat", "prefetch", 1, 76, True), ("b47", "prefetch", 47, 76, True),
    ("b64", "prefetch", 64, 76, True), ("sweep", "sweep", 1, 76, False),
    ("auto_prefetch", "auto", 1, 76, True), ("auto_sweep", "auto", 64, 76, False)],
    ids=["ccat", "b47", "b64", "sweep", "auto_prefetch", "auto_sweep"])
def test_route_rule(monkeypatch, case, schedule, B, k, fused):
    """``ops.ell_fleet_half_step`` at CCAT's width calls the fused entry
    once, and no other kernel entry of its own, exactly when the schedule
    resolves to prefetch, at every B; the sweep's pair otherwise."""
    calls = _spy(monkeypatch, ("ell_grad_update_fused", "ell_margins_coeff", "ell_grad_update"))
    cols, vals, W, y = _planes(2, B, k, CCAT_D, seed=B, zipf=True)
    bound = minibatch_block_bound(cols, vals, B, d=CCAT_D)
    TO.ell_fleet_half_step(*_t(W, cols, vals, y), lam=1e-4, t=1000, schedule=schedule,
                           n_blocks_max=bound)
    assert calls == (["ell_grad_update_fused"] if fused
                     else ["ell_margins_coeff", "ell_grad_update"]), case


@pytest.mark.parametrize("k", [0, 13], ids=["k0", "k13"])
@pytest.mark.parametrize("project", [True, False], ids=["project", "no_project"])
def test_dispatch_takes_one_route_with_the_same_bits(monkeypatch, project, k):
    """``ops.ell_fleet_half_step`` at prefetch calls the fused entry once,
    with the schedule's blk_d, block count and cap and the step's scalars,
    and gives the chain's W_half (then the ball projection) bit for bit,
    projected or not, k = 0 (widened to one inert entry) too."""
    calls = _spy(monkeypatch, ("ell_grad_update_fused",))
    cols, vals, W, y = _planes(3, 5, k, 1001, seed=3, pad_node=True)
    args = _t(W, cols, vals, y)
    got = TO.ell_fleet_half_step(*args, lam=1e-2, t=7, project=project, schedule="prefetch")
    assert calls == ["ell_grad_update_fused"]
    W_, cols_, vals_, y_ = args
    if k == 0:
        cols_ = torch.zeros((3, 5, 1), dtype=torch.int32)
        vals_ = torch.zeros((3, 5, 1))
    _, blk_d, cap = TO.resolve_ell_schedule("prefetch", B=5, k=max(k, 1), d=1001)
    want = _chain(cols_, vals_, W_, y_, TO.step_scalars(1e-2, 7, 5), blk_d=blk_d,
                  n_blocks_max=cap)
    assert torch.equal(got, project_ball(want, 1e-2) if project else want)


def test_fused_entry_counts_no_cpu_launch_and_refuses_mixed_devices():
    cols, vals, W, y = _t(*_planes(2, 1, 5, 300, seed=4))
    before = TS.ell_grad_update_fused.launches
    _fused(cols, vals, W, y, (0.1, 0.2), blk_d=128, n_blocks_max=3)
    assert TS.ell_grad_update_fused.launches == before == 0
    with pytest.raises(ValueError, match="different devices"):
        _fused(cols, vals, W.to("meta"), y, (0.1, 0.2), blk_d=128, n_blocks_max=3)


def test_launch_cost_fused():
    """The fused entry reads the entries, the labels and W once and writes
    W_half once, and no map, margins or coefficients: 3.79 MB at CCAT's
    (10, 1, 76), d 47,236, less than the pair it replaces moves."""
    shape = dict(m=10, B=1, k=76, d=47236, n_blocks_max=36, blk_d=128)
    cost = TO.launch_cost("ell_grad_update_fused", **shape)
    assert cost == {"launches": 1, "bytes": 4 * (2 * 760 + 10 + 2 * 472360),
                    "flops": 4 * 760 + 10 + 3 * 472360}
    assert cost["bytes"] == 3785000
    pair = [TO.launch_cost(kind, **shape) for kind in ("ell_margins_prefetch_coeff",
                                                       "ell_grad_update_prefetch_fold")]
    assert cost["flops"] == sum(c["flops"] for c in pair)
    assert cost["bytes"] < sum(c["bytes"] for c in pair)


class _Ell:
    """ELL partitions as ``gadget_train`` duck-types them."""

    def __init__(self, cols, vals, d):
        self.cols, self.vals, self.d = cols, vals, d


@pytest.mark.parametrize("route,B", [
    ("fused", 1), ("unfused", 1), ("above_cap", 4), ("prefetch", 1), ("prefetch", 8),
    ("sweep", 1)], ids=["dense_fused", "dense_unfused", "dense_above_cap", "prefetch",
                        "prefetch_b8", "sweep"])
def test_record_iterations_accounts_the_route(monkeypatch, route, B):
    """Every half-step route launches what ``kernel.launches`` records: the
    step calls the kernel entries of ``ops.HALF_STEP_KINDS[route]`` once an
    iteration each, and no other; the prefetch pair's kinds are never
    recorded. Above ``hinge_subgrad.MAX_FLEET_B`` (lowered here) the fused
    dense route calls ``margins`` and ``grad_update`` and records
    ``fleet_half_step``, whose ``launch_cost`` counts those two launches."""
    # every kernel entry a half-step route can call, whatever the table says
    kinds = ["fleet_half_step", "margins", "grad_update", "ell_margins_coeff", "ell_grad_update",
             "ell_grad_update_fused"]
    pair = ["ell_margins_prefetch_coeff", "ell_grad_update_prefetch_fold"]
    calls = _spy(monkeypatch, kinds)
    m, d, iters = 3, 300, 6
    cols, vals, _, y = _planes(m, 20, 6, d, seed=5, pad_row=False)
    if route in ("fused", "unfused", "above_cap"):
        X = np.zeros((m, 20, d), np.float32)
        np.add.at(X, (np.arange(m)[:, None, None], np.arange(20)[None, :, None], cols), vals)
    else:
        X = _Ell(cols, vals, d)
    if route == "above_cap":
        monkeypatch.setattr(TK, "MAX_FLEET_B", B - 1)
    cfg = TG.GadgetConfig(lam=1e-2, batch_size=B, gossip_rounds=2, topology="random",
                          epsilon=0.0, check_every=3, max_iters=iters, seed=1,
                          fused=route != "unfused",
                          sparse_schedule="sweep" if route == "sweep" else "prefetch")
    ttm.reset()
    try:
        TG.gadget_train(X, y, cfg, device="cpu")
        reg = ttm.default_registry()
        recorded = {kind: reg.value("kernel.launches", kernel=kind) for kind in kinds + pair}
        fused_bytes = reg.value("kernel.bytes", kernel="ell_grad_update_fused")
    finally:
        ttm.reset()
    ran = TO.HALF_STEP_KINDS["unfused" if route == "above_cap" else route]
    called = {kind: calls.count(kind) for kind in kinds}
    assert called == {kind: iters * (kind in ran) for kind in kinds}
    assert sum(recorded.values()) == sum(called.values())
    if route == "above_cap":
        assert recorded == {kind: 2 * iters * (kind == "fleet_half_step") for kind in kinds + pair}
    else:
        assert recorded == dict(called, **{kind: 0 for kind in pair})
    if route == "prefetch":
        assert fused_bytes == iters * TO.launch_cost("ell_grad_update_fused", m=m, B=B, k=6,
                                                     d=d)["bytes"]


@pytest.mark.parametrize("m,d,resident,want", [
    (10, CCAT_D, 1056, 1), (10, KDDA_D, 790, 250), (1, KDDA_D, 790, 25),
    (2, 3000001, 660, 9), (800, KDDA_D, 790, 19743), (3, 1001, 790, 1)],
    ids=["ccat", "kdda", "kdda_one_node", "ragged", "more_nodes_than_resident", "one_tile"])
def test_fused_grid_rule(m, d, resident, want):
    """The fused kernel's run of tiles from the blocks the card holds at
    once: at CCAT's width one tile a block, at kdda's about one wave of
    blocks folding 250 tiles each, one block a node when the nodes
    outnumber the resident blocks; the runs cover every tile once, the last
    one ragged where the tiles do not divide."""
    tiles = -(-d // 1024)  # the kernel's tiles are 1,024 columns of W
    tiles_per_block = TS.fused_grid(m, tiles, resident)
    assert tiles_per_block == want
    per_node = -(-tiles // tiles_per_block)  # the blocks the kernel launches a node
    assert (per_node - 1) * tiles_per_block < tiles <= per_node * tiles_per_block
    assert per_node <= max(1, resident // m)


# ---------------------------------------------------------------- the card

@pytest.fixture
def card():
    """The CUDA device; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _card_shapes():
    """(name, m, B, k, d, cap change): the paper's CCAT fleet, one node, B
    from 1 to 64, k in waves, and undersized caps; then the widths where a
    block folds a run of tiles: kdda's fleet at the bound and 3 under it,
    one node at kdda's width, and a ragged width whose tiles a node's
    blocks do not divide evenly."""
    return [("ccat", 10, 1, CCAT_K, CCAT_D, 0), ("one_node", 1, 1, CCAT_K, CCAT_D, 0),
            ("b2", 10, 2, CCAT_K, CCAT_D, 0), ("b5", 10, 5, CCAT_K, CCAT_D, 0),
            ("b47", 10, 47, CCAT_K, CCAT_D, 0),
            ("b64", 10, 64, CCAT_K, CCAT_D, 0), ("k600", 2, 3, 600, CCAT_D, 0),
            ("undersized", 10, 1, CCAT_K, CCAT_D, -3), ("b5_undersized", 10, 5, CCAT_K, CCAT_D, -9),
            ("kdda", 10, 1, KDDA_K, KDDA_D, 0), ("kdda_undersized", 10, 1, KDDA_K, KDDA_D, -3),
            ("kdda_one_node", 1, 1, KDDA_K, KDDA_D, 0), ("ragged_runs", 2, 5, KDDA_K, 3000001, 0)]


@pytest.mark.chip
@pytest.mark.parametrize("shape", range(len(_card_shapes())), ids=[s[0] for s in _card_shapes()])
def test_card_fused_kernel_is_the_chain_bit_for_bit(card, shape):
    """On the card the fused kernel's W_half is the CUDA chain's bit for
    bit, at the paper's CCAT shape, one node, B from 1 to 64, k in waves,
    undersized caps and the wide shapes; one launch a call, folding one
    tile a block at CCAT's width and a run of tiles at the wider ones."""
    name, m, B, k, d, cut = _card_shapes()[shape]
    cols, vals, W, y = _planes(m, B, k, d, seed=10 + shape, zipf=True)
    bound = minibatch_block_bound(cols, vals, B, d=d)
    cap = max(1, bound + cut)
    if cut:
        assert cap < bound, name  # the map is really cut
    scal = TO.step_scalars(1e-4, 1000, B)
    args = _t(cols, vals, W, y, device=card)
    before = TS.ell_grad_update_fused.launches
    got = _fused(*args, scal, blk_d=128, n_blocks_max=cap)
    assert TS.ell_grad_update_fused.launches == before + 1
    tiles = TS.ell_grad_update_fused.tiles_per_block
    assert tiles == TS.fused_tiles_per_block(m, B, d, -(-d // 128), card), name
    if d == CCAT_D:
        assert tiles == 1, name
    else:
        assert tiles > 1, name
    want = _chain(*args, scal, blk_d=128, n_blocks_max=cap)
    plain = _plain_chain(*args, scal, blk_d=128, n_blocks_max=cap)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got, _fused(*args, scal, blk_d=128, n_blocks_max=cap))
    err = float((got - plain).abs().max()) / max(1.0, float(plain.abs().max()))
    assert err <= PLAIN_RTOL, (name, err)


@pytest.mark.chip
@pytest.mark.parametrize("case", CASES)
def test_card_fused_kernel_edges(card, case):
    """The CPU cases on the card: kernel against the CUDA chain, bit for bit."""
    cols, vals, W, y, blk_d, cap = _case(case)
    scal = TO.step_scalars(1e-4, 1000, cols.shape[1])
    args = _t(cols, vals, W, y, device=card)
    got = _fused(*args, scal, blk_d=blk_d, n_blocks_max=cap)
    want = _chain(*args, scal, blk_d=blk_d, n_blocks_max=cap)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.chip
@pytest.mark.parametrize("project", [True, False], ids=["project", "no_project"])
@pytest.mark.parametrize("m", [10, 1])
def test_card_dispatch_routes_give_the_same_bits(card, project, m):
    """``ops.ell_fleet_half_step`` on the card at CCAT's width, auto
    resolved to prefetch: one fused launch, W_half the CUDA chain's (then
    the ball projection) bit for bit, projected or not."""
    cols, vals, W, y = _planes(m, 1, CCAT_K, CCAT_D, seed=20 + m, zipf=True)
    bound = minibatch_block_bound(cols, vals, 1, d=CCAT_D)
    args = _t(W, cols, vals, y, device=card)
    before = TS.ell_grad_update_fused.launches
    got = TO.ell_fleet_half_step(*args, lam=1e-4, t=1000, project=project, schedule="auto",
                                 n_blocks_max=bound)
    assert TS.ell_grad_update_fused.launches == before + 1
    _, blk_d, cap = TO.resolve_ell_schedule("auto", B=1, k=CCAT_K, d=CCAT_D, n_blocks_max=bound)
    W_, cols_, vals_, y_ = args
    want = _chain(cols_, vals_, W_, y_, TO.step_scalars(1e-4, 1000, 1), blk_d=blk_d,
                  n_blocks_max=cap)
    torch.cuda.synchronize()
    assert torch.equal(got, project_ball(want, 1e-4) if project else want)
