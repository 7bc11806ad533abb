"""The serving slice end to end on the CPU, across the two packages: train
a small CCAT-shaped ELL run in each (the reference on its interpret-mode
Pallas kernels, the port on its plain versions, fed the reference's own
draws), export each with its own ``to_checkpoint``, load each in the other
package's ``SvmServer``, and score the test queries through the same
calibrated buckets: labels identical, scores within 1e-5."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import serve as R_serve  # noqa: E402
from repro.core import gadget as G  # noqa: E402
from repro.data import svm_datasets as R_ds  # noqa: E402
from repro_torch import serve as T_serve  # noqa: E402
from repro_torch.core import gadget as TG  # noqa: E402
from repro_torch.sparse.formats import pad_query_planes  # noqa: E402
from tests.test_torch_gadget import _reference_draws  # noqa: E402

M, ITERS, D, K = 4, 40, 640, 12
ROWS = 8


def _ccat_shaped(seed=0):
    """CCAT's feature model (Zipf columns, nonnegative unit rows, its label
    noise and balance) at d = 640 and 12 entries a row."""
    spec = dataclasses.replace(R_ds.PAPER_DATASETS["ccat"], d=D, sparsity=K / D)
    rng = np.random.default_rng(seed)
    w_star = np.abs(rng.normal(size=D)).astype(np.float32)
    X_tr, y_tr = R_ds._gen_split_ell(spec, 400, w_star, rng)
    X_te, y_te = R_ds._gen_split_ell(spec, 100, w_star, rng)
    return X_tr, y_tr, X_te, y_te, spec.lam


def _queries(X_te, ragged):
    """The test rows as (cols, vals) queries; ``ragged`` cuts the even ones
    to a third of their features, as ``examples/serve_batched.py`` does."""
    out = []
    for i in range(X_te.shape[0]):
        live = X_te.vals[i] != 0
        nnz = int(live.sum())
        if ragged and i % 2 == 0:
            nnz = max(1, nnz // 3)
        out.append((X_te.cols[i][live][:nnz], X_te.vals[i][live][:nnz]))
    return out


def _serve(srv, buckets, queries):
    """Route each query to the smallest bucket with k >= its nnz, pad
    batches of ``rows`` with ``pad_query_planes`` and score them through
    ``scorer_for()``. Returns scores and labels in query order and the
    buckets served."""
    score_fn = srv.scorer_for()
    by_bucket = {}
    for qi, (c, _) in enumerate(queries):
        b = next(b for b in buckets if b.k >= len(c))
        by_bucket.setdefault(b, []).append(qi)
    scores, labels = np.zeros(len(queries), np.float32), np.zeros(len(queries), np.float32)
    for b, ids in by_bucket.items():
        for s in range(0, len(ids), b.rows):
            chunk = ids[s:s + b.rows]
            cols, vals = pad_query_planes([queries[i] for i in chunk], b.rows, b.k)
            sc, lb = score_fn(b, cols, vals)
            scores[chunk], labels[chunk] = sc[:len(chunk)], lb[:len(chunk)]
    return scores, labels, set(by_bucket)


@pytest.fixture(scope="module")
def exports(tmp_path_factory):
    X_tr, y_tr, X_te, y_te, lam = _ccat_shaped()
    P, y, nc = R_ds.partition(X_tr, y_tr, M, seed=0)
    common = dict(lam=lam, batch_size=2, gossip_rounds=3, topology="random",
                  epsilon=0.0, check_every=20, max_iters=ITERS, seed=1)
    rcfg = G.GadgetConfig(use_kernels=True, **common)
    ref = G.gadget_train(P, jnp.asarray(y), rcfg, n_counts=nc)
    ids, mix = _reference_draws(rcfg, y, nc, ITERS)
    port = TG.gadget_train(P, y, TG.GadgetConfig(**common), n_counts=nc, device="cpu",
                           draws=TG.RecordedDraws(ids, mix))
    root = tmp_path_factory.mktemp("exports")
    r_snap = R_serve.Snapshot(ref.iters, np.asarray(ref.w_consensus),
                              float(ref.objective_trace[-1]))
    t_snap = T_serve.Snapshot(port.iters, port.w_consensus.numpy(),
                              float(port.objective_trace[-1]))
    R_serve.to_checkpoint(r_snap, str(root / "repro"), lam=lam)
    T_serve.to_checkpoint(t_snap, str(root / "repro_torch"), lam=lam)
    sample = P.cols.reshape(-1, K), P.vals.reshape(-1, K)
    buckets = T_serve.calibrate_buckets(
        T_serve.bucket_ladder(K, rows=ROWS, min_k=K // 4, d=D), *sample, D)
    r_buckets = R_serve.calibrate_buckets(
        R_serve.bucket_ladder(K, rows=ROWS, min_k=K // 4, d=D), *sample, D)
    assert [(b.rows, b.k, b.n_blocks_max) for b in buckets] == \
        [(b.rows, b.k, b.n_blocks_max) for b in r_buckets]
    return dict(root=root, X_te=X_te, y_te=y_te, buckets=buckets, r_buckets=r_buckets,
                ref=ref, port=port)


def test_trained_runs_agree(exports):
    np.testing.assert_allclose(exports["port"].w_consensus.numpy(),
                               np.asarray(exports["ref"].w_consensus), rtol=0, atol=1e-5)


@pytest.mark.parametrize("ragged", [False, True], ids=["whole", "ragged"])
def test_each_export_serves_in_the_other_package(exports, ragged):
    root = exports["root"]
    queries = _queries(exports["X_te"], ragged)
    t_srv = T_serve.SvmServer.load(str(root / "repro"), device="cpu")
    r_srv = R_serve.SvmServer.load(str(root / "repro_torch"), use_kernels=True)
    assert t_srv.meta == R_serve.SvmServer.load(str(root / "repro")).meta
    s_t, l_t, served_t = _serve(t_srv, exports["buckets"], queries)
    s_r, l_r, served_r = _serve(r_srv, exports["r_buckets"], queries)
    np.testing.assert_allclose(s_t, s_r, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(l_t, l_r)
    assert len(served_t) == len(served_r) == (2 if ragged else 1)
    st_t, st_r = t_srv.stats(), r_srv.stats()
    assert st_t == st_r
    assert st_t["distinct_shapes"] <= len(exports["buckets"])
    # the scores are the model's: a gather-dot of the served weights
    w = t_srv.W
    want = np.array([(v * w[c]).sum() for c, v in queries], np.float32)
    np.testing.assert_allclose(s_t, want, rtol=0, atol=1e-5)
    if not ragged:
        acc = float(np.mean(l_t == exports["y_te"]))
        assert acc == float(np.mean(np.where(want >= 0, 1.0, -1.0) == exports["y_te"]))
