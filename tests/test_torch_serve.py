"""The port's serving slice against the reference, on the CPU.

The port runs its kernels' plain versions (CPU tensors); the reference runs
its Pallas serving kernels in interpret mode (``interpret=True``,
``SvmServer(use_kernels=True)``), as ``tests/test_serve.py`` does. Inputs
are made with numpy and handed to both. Scores agree within 1e-5, labels
exactly.
"""
import os
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import checkpoint as R_ckpt  # noqa: E402
from repro import serve as R_serve  # noqa: E402
from repro.core.gadget import TrainState  # noqa: E402
from repro.kernels.hinge_subgrad import ops as RO  # noqa: E402
from repro.kernels.hinge_subgrad import predict as RP  # noqa: E402
from repro.serve import snapshot as R_snap  # noqa: E402
from repro.sparse import formats as R_fmt  # noqa: E402
from repro_torch import checkpoint as T_ckpt  # noqa: E402
from repro_torch import serve as T_serve  # noqa: E402
from repro_torch.kernels.hinge_subgrad import ops as TO  # noqa: E402
from repro_torch.kernels.hinge_subgrad import predict as TP  # noqa: E402
from repro_torch.kernels.hinge_subgrad import ref as TR  # noqa: E402
from repro_torch.serve import snapshot as T_snap  # noqa: E402
from repro_torch.sparse import formats as T_fmt  # noqa: E402
from tests.sparse_utils import ell_minibatch_planes  # noqa: E402

ATOL = 1e-5
BLK = 128


def _t(a):
    return torch.from_numpy(np.array(a))


def _planes(B, d, k, localized, seed):
    rng = np.random.default_rng(seed)
    X, cols, vals, _, _ = ell_minibatch_planes(1, B, d, k, localized, rng=rng)
    return X[0], np.asarray(cols[0]), np.asarray(vals[0])


def _weights(C, d, seed, tie=False):
    W = np.random.default_rng(seed).normal(size=(C, d)).astype(np.float32)
    if tie:
        W[C - 1] = W[0]  # the first and last classes tie on every row
    return W[0] if C == 1 else W


def _assert_same(port, ref):
    s_p, l_p = port
    s_r, l_r = ref
    assert tuple(s_p.shape) == np.shape(s_r)
    np.testing.assert_allclose(np.asarray(s_p), np.asarray(s_r), rtol=0, atol=ATOL)
    l_p = np.asarray(l_p)
    assert l_p.dtype == np.asarray(l_r).dtype
    np.testing.assert_array_equal(l_p, np.asarray(l_r))


# ----------------------------------------------------------- ell_predict


@pytest.mark.parametrize("B,d,C,k,localized", [
    (1, 130, 1, 3, False), (5, 700, 1, 9, True), (8, 300, 3, 12, False),
    (6, 700, 3, 9, True), (3, 1001, 3, 5, False), (8, 256, 1, 16, True)])
def test_ell_predict_matches_reference(B, d, C, k, localized):
    X, cols, vals = _planes(B, d, k, localized, seed=B + d + C + k)
    W = _weights(C, d, seed=d + C, tie=C > 1)
    ref = RO.ell_predict(jnp.asarray(W), jnp.asarray(cols), jnp.asarray(vals), interpret=True)
    port = TO.ell_predict(_t(W), _t(cols), _t(vals))
    _assert_same(port, ref)
    dense = TO.dense_predict(_t(W), _t(X))  # and the dense route on the same rows
    np.testing.assert_allclose(port[0].numpy(), dense[0].numpy(), rtol=0, atol=ATOL)
    np.testing.assert_array_equal(port[1].numpy(), dense[1].numpy())


def test_host_map_matches_device_map():
    B, d, k = 6, 700, 9
    _, cols, vals = _planes(B, d, k, True, seed=1)
    W = _weights(3, d, seed=2)
    n_blk = -(-d // BLK)
    bound = T_fmt.minibatch_block_bound(cols, vals, B, BLK, d=d)
    bm = T_fmt.block_map(cols[None], vals[None], BLK, n_blk, bound)[0]
    np.testing.assert_array_equal(bm, R_fmt.block_map(cols[None], vals[None], BLK, n_blk,
                                                      bound)[0])
    dev = TO.ell_block_map(_t(cols)[None], _t(vals)[None], blk_d=BLK, n_d_blocks=n_blk,
                           n_blocks_max=bound)[0]
    np.testing.assert_array_equal(dev.numpy(), bm)
    host = TO.ell_predict(_t(W), _t(cols), _t(vals), block_ids=_t(bm))
    device = TO.ell_predict(_t(W), _t(cols), _t(vals), n_blocks_max=bound)
    assert torch.equal(host[0], device[0]) and torch.equal(host[1], device[1])
    ref = RO.ell_predict(jnp.asarray(W), jnp.asarray(cols), jnp.asarray(vals),
                         block_ids=jnp.asarray(bm), interpret=True)
    _assert_same(host, ref)


def test_undersized_device_map_drops_the_same_entries():
    B, d, k = 6, 1001, 9
    _, cols, vals = _planes(B, d, k, False, seed=3)
    W = _weights(3, d, seed=4)
    n_blk = -(-d // BLK)
    live = len(np.unique(cols[vals != 0] // BLK))
    short = live - 1
    ref = RO.ell_predict(jnp.asarray(W), jnp.asarray(cols), jnp.asarray(vals),
                         n_blocks_max=short, interpret=True)
    port = TO.ell_predict(_t(W), _t(cols), _t(vals), n_blocks_max=short)
    _assert_same(port, ref)
    full = TO.ell_predict(_t(W), _t(cols), _t(vals), n_blocks_max=live)
    assert not torch.allclose(port[0], full[0])  # the short map really dropped entries
    assert live <= n_blk


@pytest.mark.parametrize("C", [1, 3])
def test_empty_batches_and_pad_rows(C):
    W = _weights(C, 100, seed=5)
    for k in (0, 3):
        cols, vals = np.zeros((4, k), np.int32), np.zeros((4, k), np.float32)
        ref = RO.ell_predict(jnp.asarray(W), jnp.asarray(cols), jnp.asarray(vals),
                             interpret=True)
        port = TO.ell_predict(_t(W), _t(cols), _t(vals))
        _assert_same(port, ref)
        np.testing.assert_array_equal(port[0].numpy(), np.zeros((4,) if C == 1 else (4, C)))
        np.testing.assert_array_equal(port[1].numpy(), np.ones(4) if C == 1 else np.zeros(4))


def test_class_ties_take_the_first_class():
    _, cols, vals = _planes(7, 300, 8, False, seed=6)
    W = _weights(3, 300, seed=7, tie=True)
    port = TO.ell_predict(_t(W), _t(cols), _t(vals))
    ref = RO.ell_predict(jnp.asarray(W), jnp.asarray(cols), jnp.asarray(vals), interpret=True)
    _assert_same(port, ref)
    assert not torch.any(port[1] == 2)


def _pad_to(a, mult, axis):
    pad = (-a.shape[axis]) % mult
    widths = [(0, 0)] * a.ndim
    widths[axis] = (0, pad)
    return np.pad(a, widths)


@pytest.mark.parametrize("case", ["sound", "short", "masked_class"])
def test_plain_version_matches_pallas_kernel_on_padded_inputs(case):
    """``ell_scores_prefetch_plain`` on unpadded inputs against the Pallas
    kernel on its (8, 128)-padded planes, its 128-lane class padding and its
    zero landing block."""
    B, d, k, C = 5, 900, 11, 4
    _, cols, vals = _planes(B, d, k, False, seed=8)
    W = _weights(C, d, seed=9)
    n_classes = C - 1 if case == "masked_class" else C
    if case == "masked_class":
        W[C - 1] = 100.0 * np.abs(W[C - 1])  # would win every row if counted
    n_blk = -(-d // BLK)
    live = len(np.unique(cols[vals != 0] // BLK))
    cap = live - 1 if case == "short" else live
    bids = TO.ell_block_map(_t(cols)[None], _t(vals)[None], blk_d=BLK, n_d_blocks=n_blk,
                            n_blocks_max=cap)[0].numpy()
    Wp = _pad_to(_pad_to(W, 128, 0), (n_blk + 1) * BLK, 1)
    s_r, l_r = RP.ell_scores_prefetch(
        jnp.asarray(_pad_to(_pad_to(cols, 8, 0), 128, 1)),
        jnp.asarray(_pad_to(_pad_to(vals, 8, 0), 128, 1)), jnp.asarray(Wp), jnp.asarray(bids),
        blk_d=BLK, n_d_blocks=n_blk, n_classes=n_classes, interpret=True)
    s_p, l_p = TP.ell_scores_prefetch(_t(cols), _t(vals), _t(W), _t(bids), blk_d=BLK,
                                      n_d_blocks=n_blk, n_classes=n_classes)
    assert s_p.shape == (B, C) and l_p.dtype == torch.int32
    np.testing.assert_allclose(s_p.numpy(), np.asarray(s_r)[:B, :C], rtol=0, atol=ATOL)
    np.testing.assert_array_equal(l_p.numpy(), np.asarray(l_r)[:B])
    every_entry = TR.ell_predict_scores_ref(_t(W), _t(cols), _t(vals))
    # a sound map counts every entry; the short one loses the dropped block's
    assert torch.allclose(s_p, every_entry, rtol=0, atol=ATOL) == (case != "short")


# ------------------------------------------------- host-side serving pieces


def test_resolve_block_cap_matches_reference():
    for B in (1, 3, 8):
        for k in (1, 5, 76):
            for n_d in (1, 7, 370):
                for cap in (None, 0, 1, 4, 40, 10_000):
                    assert TO.resolve_block_cap(B, k, n_d_blocks=n_d, n_blocks_max=cap) \
                        == RO.resolve_block_cap(B, k, n_d_blocks=n_d, n_blocks_max=cap)


def _rungs(buckets):
    return [(b.rows, b.k, b.n_blocks_max) for b in buckets]


def test_bucket_ladder_and_calibration_match_reference():
    for kw in [dict(k_max=76), dict(k_max=76, rows=8, min_k=19, d=47236),
               dict(k_max=5, min_k=16), dict(k_max=100, rows=3, min_k=7, d=900, blk_d=64),
               dict(k_max=1, d=10)]:
        assert _rungs(T_serve.bucket_ladder(**kw)) == _rungs(R_serve.bucket_ladder(**kw))
    with pytest.raises(ValueError):
        T_serve.bucket_ladder(0)
    with pytest.raises(ValueError):
        T_serve.Bucket(1, 0, 1)
    _, cols, vals = _planes(40, 2000, 30, True, seed=10)
    ladder = T_serve.bucket_ladder(30, rows=4, min_k=8, d=2000)
    for blk in (64, 128):
        got = T_serve.calibrate_buckets(ladder, cols, vals, 2000, blk_d=blk)
        want = R_serve.calibrate_buckets(R_serve.bucket_ladder(30, rows=4, min_k=8, d=2000),
                                         cols, vals, 2000, blk_d=blk)
        assert _rungs(got) == _rungs(want)
        assert all(b.n_blocks_max <= a.n_blocks_max for a, b in zip(ladder, got))


def test_pad_query_planes_matches_reference():
    rng = np.random.default_rng(11)
    queries = [(rng.choice(500, n, replace=False).astype(np.int64), rng.normal(size=n))
               for n in (3, 0, 7, 1)]
    for rows, k in ((4, 7), (8, 9)):
        got = T_fmt.pad_query_planes(queries, rows, k)
        want = R_fmt.pad_query_planes(queries, rows, k)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    for bad in ((queries, 3, 7), (queries, 4, 6), ([(np.arange(2), np.ones(3))], 1, 4)):
        with pytest.raises(ValueError):
            T_fmt.pad_query_planes(*bad)


@pytest.mark.parametrize("shape", [(50,), (3, 40), (2, 10)])
def test_int8_quantization_bit_equal(shape):
    w = np.random.default_rng(12).normal(size=shape).astype(np.float32)
    if len(shape) == 2:
        w[-1] = 0.0  # an all-zero class row: the scale floor
    q_t, s_t = T_snap.quantize_int8(w)
    q_r, s_r = R_snap.quantize_int8(w)
    assert q_t.dtype == q_r.dtype == np.int8 and np.asarray(s_t).dtype == np.float32
    np.testing.assert_array_equal(q_t, q_r)
    np.testing.assert_array_equal(s_t, s_r)
    np.testing.assert_array_equal(T_snap.dequantize_int8(q_t, s_t),
                                  R_snap.dequantize_int8(q_r, s_r))


SNAP = {"repro": R_snap, "repro_torch": T_snap}


@pytest.mark.parametrize("writer,reader", [("repro", "repro_torch"), ("repro_torch", "repro")])
@pytest.mark.parametrize("variant", ["f32", "int8", "multiclass_int8", "train_state"])
def test_serving_checkpoints_cross_load(tmp_path, writer, reader, variant):
    rng = np.random.default_rng(13)
    w = rng.normal(size=(3, 60) if variant == "multiclass_int8" else 60).astype(np.float32)
    kw = dict(lam=1e-3, quantize="int8" if "int8" in variant else None)
    W = rng.normal(size=(4, 60)).astype(np.float32)
    if variant == "train_state":
        kw["train_state"] = (TrainState(31, jnp.asarray(W), jnp.asarray(2 * W))
                             if writer == "repro" else SimpleNamespace(
                                 iteration=31, W=torch.from_numpy(W), W_sum=2 * torch.from_numpy(W)))
    src = SNAP[writer]
    path = src.to_checkpoint(src.Snapshot(31, w, 0.25), str(tmp_path), **kw)
    assert os.path.basename(path) == "step_000000031"
    got_w, got_extra = SNAP[reader].from_checkpoint(str(tmp_path))
    want_w, want_extra = SNAP[writer].from_checkpoint(str(tmp_path))
    assert got_extra == want_extra and got_w.dtype == np.float32
    np.testing.assert_array_equal(got_w, want_w)
    if variant == "train_state":
        ts = R_snap.train_state_from_checkpoint(str(tmp_path))
        assert ts.iteration == 31
        np.testing.assert_array_equal(np.asarray(ts.W_sum), 2 * W)
    if "int8" in variant:
        tree = R_ckpt.restore(str(tmp_path), {"w": np.zeros(w.shape, np.int8),
                                              "scale": np.zeros(w.shape[:-1], np.float32)})
        assert tree["w"].dtype == np.int8


def test_from_checkpoint_rejects_foreign_and_newer(tmp_path):
    T_ckpt.save(str(tmp_path / "a"), 0, {"w": np.zeros(4)})
    with pytest.raises(ValueError, match="serving export"):
        T_snap.from_checkpoint(str(tmp_path / "a"))
    T_ckpt.save(str(tmp_path / "b"), 0, {"w": np.zeros(4, np.float32)},
                extra={"kind": T_snap.SERVE_KIND, "serve_format": 99})
    with pytest.raises(ValueError, match="newer"):
        T_snap.from_checkpoint(str(tmp_path / "b"))
    with pytest.raises(ValueError, match="quantize"):
        T_snap.to_checkpoint(T_snap.Snapshot(1, np.zeros(3, np.float32), 0.0),
                             str(tmp_path / "c"), quantize="int4")


# ---------------------------------------------------------- a scripted run


def _poison_step(root, step):
    """A complete step dir whose contents can never load, pointed at."""
    path = os.path.join(root, f"step_{step:09d}")
    os.makedirs(path)
    with open(os.path.join(path, "manifest.json"), "w") as fh:
        fh.write("{ not json")
    with open(os.path.join(path, "arrays.npz"), "w") as fh:
        fh.write("not an npz")
    with open(os.path.join(root, "LATEST"), "w") as fh:
        fh.write(f"{step}\n")


@pytest.mark.parametrize("C", [1, 3])
def test_scripted_server_run_matches_reference(tmp_path, C):
    d = 640  # 5 d-blocks
    rng = np.random.default_rng(14 + C)

    def w_of():
        return rng.normal(size=(C, d) if C > 1 else d).astype(np.float32)

    w1, w2, w3 = w_of(), w_of(), w_of()
    root = str(tmp_path / "ckpts")
    T_snap.to_checkpoint(T_snap.Snapshot(10, w1, 0.5), root, keep=0)
    servers = {"repro": R_serve.SvmServer.watch(root, use_kernels=True, reload_quarantine=2),
               "repro_torch": T_serve.SvmServer.watch(root, device="cpu", reload_quarantine=2)}
    X, cols, vals = _planes(6, d, 8, True, seed=15)
    wide = np.arange(0, d, BLK, dtype=np.int32).reshape(1, -1)  # one entry per block

    def both(fn):
        out = {name: fn(srv) for name, srv in servers.items()}
        if isinstance(out["repro"], tuple):
            _assert_same(out["repro_torch"], out["repro"])
        else:
            assert out["repro_torch"] == out["repro"]

    both(lambda s: s.score(X))
    both(lambda s: s.score_sparse(cols, vals, n_blocks_max=4))
    both(lambda s: s.score_sparse(wide, np.ones_like(wide, np.float32), n_blocks_max=2))
    both(lambda s: s.swap_weights(w2))
    both(lambda s: s.set_plane("int8"))
    both(lambda s: s.score_sparse(cols, vals, n_blocks_max=4))
    T_snap.to_checkpoint(T_snap.Snapshot(20, w3, 0.4), root, keep=0)  # a forward publish
    both(lambda s: s.maybe_reload())
    both(lambda s: s.plane)
    both(lambda s: s.score(X))  # the new weights' int8 image
    both(lambda s: s.maybe_reload())  # unchanged pointer
    T_ckpt.point_latest(root, 10)  # a rollback
    both(lambda s: s.maybe_reload())
    both(lambda s: s.set_plane("f32"))
    _poison_step(root, 99)
    for _ in range(3):
        both(lambda s: s.maybe_reload())
    both(lambda s: s.quarantined_steps)
    both(lambda s: s.score_sparse(cols, vals, n_blocks_max=4))
    both(lambda s: s.meta["iteration"])
    np.testing.assert_array_equal(servers["repro_torch"].W, w1)

    stats = {name: srv.stats() for name, srv in servers.items()}
    assert stats["repro_torch"] == stats["repro"]
    assert stats["repro"]["swaps"] == 3 and stats["repro"]["quarantined"] == 1
    assert stats["repro"]["cap_overflows"] == 1 and stats["repro"]["distinct_shapes"] == 3

    def serve_series(srv):
        return {k: v for k, v in srv.registry.values().items() if k.startswith("serve.")}
    assert serve_series(servers["repro_torch"]) == serve_series(servers["repro"])


@pytest.mark.parametrize("C", [1, 3, 130])
def test_servers_label_nan_rows_as_the_reference(C):
    """Both servers on the kernel route, multiclass W (C, d): a query whose
    class scores hold a NaN is labelled 128·⌈C/128⌉, dense and sparse; the
    servers guard no query. Sparse entries lie in one 128-column block (see
    test_torch_predict.py: the reference's one-hot gather turns an infinite
    value into NaN in every other visited block)."""
    d = 300
    rng = np.random.default_rng(40 + C)
    W = rng.normal(size=(C, d)).astype(np.float32)
    X = (rng.normal(size=(6, d)) / np.sqrt(d)).astype(np.float32)
    X[1, 4] = np.nan
    X[2, 6] = np.inf
    W[C - 1, 6] = 0.0  # row 2: class C - 1 NaN, the others +-inf
    cols = rng.integers(0, BLK, size=(6, 5)).astype(np.int32)
    vals = rng.normal(size=(6, 5)).astype(np.float32)
    vals[1, 0] = np.nan
    vals[3, 2] = np.nan
    servers = {"repro": R_serve.SvmServer(W, use_kernels=True),
               "repro_torch": T_serve.SvmServer(W, device="cpu")}
    for fn in (lambda s: s.score(X), lambda s: s.score_sparse(cols, vals)):
        port, ref = fn(servers["repro_torch"]), fn(servers["repro"])
        _assert_same(port, ref)
        assert np.isnan(port[0][1]).all()
    nan_label = 128 * -(-C // 128)
    assert servers["repro_torch"].score(X)[1][[1, 2]].tolist() == [nan_label] * 2
    assert servers["repro_torch"].score_sparse(cols, vals)[1][[1, 3]].tolist() == [nan_label] * 2


def test_kernel_and_oracle_routes_agree():
    d = 300
    w = np.random.default_rng(16).normal(size=d).astype(np.float32)
    X, cols, vals = _planes(5, d, 6, False, seed=17)
    a = T_serve.SvmServer(w, device="cpu")
    b = T_serve.SvmServer(w, device="cpu", use_kernels=False)
    _assert_same(a.score(X), b.score(X))
    _assert_same(a.score_sparse(cols, vals), b.score_sparse(cols, vals))
    # the launch accounting lands beside the serve counters, on the kernel route only
    assert a.registry.value("kernel.launches", kernel="ell_predict") == 1
    assert b.registry.value("kernel.launches", kernel="ell_predict") == 0


def test_server_validation():
    srv = T_serve.SvmServer(np.zeros(8, np.float32), device="cpu")
    with pytest.raises(ValueError, match="d=4"):
        srv.score(np.zeros((2, 4), np.float32))
    with pytest.raises(ValueError, match=r"\(d,\) or \(C, d\)"):
        T_serve.SvmServer(np.zeros((2, 3, 4), np.float32), device="cpu")
    with pytest.raises(ValueError):
        T_serve.SvmServer(np.zeros(8, np.float32), device="cpu", reload_quarantine=0)
    with pytest.raises(ValueError):
        srv.swap_weights(np.zeros(16, np.float32))
    with pytest.raises(ValueError):
        srv.set_plane("fp16")
    with pytest.raises(RuntimeError):
        srv.maybe_reload()
