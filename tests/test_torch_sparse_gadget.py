"""The port's sparse GADGET path against the JAX reference, on the CPU.

The port trains the reference's own ``EllPartitions`` with its kernels'
plain versions; the reference runs its sparse Pallas kernels in interpret
mode (``use_kernels=True``). The port replays the reference's own draws
(``_batch_ids`` and ``_iter_mixing``) through ``RecordedDraws``, and runs
are compared at a fixed iteration count (ε = 0).
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import gadget as G  # noqa: E402
from repro.data import svm_datasets as R_ds  # noqa: E402
from repro.kernels.hinge_subgrad import ops as RO  # noqa: E402
from repro.sparse import formats as R_fmt  # noqa: E402
from repro_torch.core import gadget as TG  # noqa: E402
from repro_torch.data import svm_datasets as T_ds  # noqa: E402
from repro_torch.kernels.hinge_subgrad import ops as TO  # noqa: E402
from repro_torch.kernels.hinge_subgrad import sparse as TS  # noqa: E402
from tests.test_torch_gadget import _assert_match, _reference_draws  # noqa: E402

M, B, ITERS, CHECK = 4, 4, 40, 15
N_COUNTS = np.array([97, 90, 85, 97])


def _reuters_ell():
    """Reuters-shaped ELL partitions (the reference's own EllPartitions) with
    non-uniform counts: node i's rows past N_COUNTS[i] are pads (0, 0), y=0."""
    ds = R_ds.make_dataset("reuters", scale=0.05, seed=0, sparse=True)
    P, y, _ = R_ds.partition(ds.X_train, ds.y_train, M, seed=3)
    cols, vals, y = P.cols.copy(), P.vals.copy(), y.copy()
    for i, c in enumerate(N_COUNTS):
        cols[i, c:], vals[i, c:], y[i, c:] = 0, 0.0, 0.0
    return R_fmt.EllPartitions(cols, vals, P.d), y, ds.lam


def _cfg_pair(lam, topology, fused, schedule, **kw):
    common = dict(lam=lam, batch_size=B, gossip_rounds=2, topology=topology,
                  epsilon=0.0, check_every=CHECK, max_iters=ITERS, seed=3, fused=fused,
                  sparse_schedule=schedule)
    common.update(kw)
    return G.GadgetConfig(use_kernels=True, **common), TG.GadgetConfig(**common)


# a half fraction of topology × fused × schedule: every pair of their
# values meets once, at half the reference's interpret-mode compiles
@pytest.mark.parametrize("topology,fused,schedule", [
    ("random", True, "sweep"), ("random", False, "prefetch"),
    ("exponential", True, "prefetch"), ("exponential", False, "sweep")])
def test_sparse_trajectory_matches_reference_kernels(topology, fused, schedule):
    P, y, lam = _reuters_ell()
    rcfg, tcfg = _cfg_pair(lam, topology, fused, schedule)
    ref = G.gadget_train(P, jnp.asarray(y), rcfg, n_counts=N_COUNTS)
    ids, mix = _reference_draws(rcfg, y, N_COUNTS, ITERS)
    draws = TG.RecordedDraws(ids, mix if topology == "random" else None)
    port = TG.gadget_train(P, y, tcfg, n_counts=N_COUNTS, device="cpu", draws=draws)
    _assert_match(ref, port)


@pytest.mark.parametrize("topology", ["random", "exponential"])
def test_sparse_matches_dense_on_densified_partitions(topology):
    """The bar of the reference's sparse-vs-dense test: the same draws on
    the ELL planes and on their dense form land on one consensus."""
    P, y, lam = _reuters_ell()
    X = np.stack([R_fmt.ELL(c, v, (c.shape[0], P.d)).to_dense()
                  for c, v in zip(P.cols, P.vals)])
    cfg = TG.GadgetConfig(lam=lam, batch_size=B, gossip_rounds=3, topology=topology,
                          epsilon=0.0, check_every=50, max_iters=100, seed=4)
    sparse = TG.gadget_train(P, y, cfg, n_counts=N_COUNTS, device="cpu")
    dense = TG.gadget_train(X, y, cfg, n_counts=N_COUNTS, device="cpu")
    assert float((sparse.w_consensus - dense.w_consensus).abs().max()) <= 1e-5
    np.testing.assert_allclose(sparse.objective_trace, dense.objective_trace, atol=1e-5)


def test_port_partitions_train_like_reference_partitions():
    """The port's own generator and EllPartitions give the same run as the
    reference's objects, bit for bit."""
    ds = T_ds.make_dataset("reuters", scale=0.05, seed=0, sparse=True)
    P, y, nc = T_ds.partition(ds.X_train, ds.y_train, M, seed=3)
    r_ds = R_ds.make_dataset("reuters", scale=0.05, seed=0, sparse=True)
    rP, ry, _ = R_ds.partition(r_ds.X_train, r_ds.y_train, M, seed=3)
    cfg = TG.GadgetConfig(lam=ds.lam, batch_size=B, topology="ring", epsilon=0.0,
                          check_every=10, max_iters=20)
    a = TG.gadget_train(P, y, cfg, n_counts=nc, device="cpu")
    b = TG.gadget_train(rP, ry, cfg, n_counts=nc, device="cpu")
    assert torch.equal(a.W, b.W)
    np.testing.assert_array_equal(a.objective_trace, b.objective_trace)


def test_quick_ccat_width_resolves_auto_to_prefetch(monkeypatch):
    """At CCAT's width (d = 47,236, k = 76) and the paper's B = 1 the auto
    schedule is the prefetch schedule, its half-step the fused entry with
    the data's bound once an iteration, and a short run matches the
    reference."""
    ds = R_ds.make_dataset("ccat", scale=0.0005, seed=0, sparse=True)
    P, y, nc = R_ds.partition(ds.X_train, ds.y_train, M, seed=0)
    k = P.cols.shape[-1]
    bound = P.block_bound(1)
    assert (P.d, k) == (47236, 76)
    assert TO.resolve_ell_schedule("auto", B=1, k=k, d=P.d, n_blocks_max=bound) \
        == RO.resolve_ell_schedule("auto", B=1, k=k, d=P.d, n_blocks_max=bound) \
        == ("prefetch", 128, bound)
    common = dict(lam=ds.lam, batch_size=1, gossip_rounds=4, topology="random",
                  epsilon=0.0, check_every=5, max_iters=10, seed=0)
    rcfg = G.GadgetConfig(use_kernels=True, **common)
    ref = G.gadget_train(P, jnp.asarray(y), rcfg, n_counts=nc)
    ids, mix = _reference_draws(rcfg, y, nc, 10)
    calls = []
    real = TS.ell_grad_update_fused

    def spy(*a, **kw):
        calls.append(kw["n_blocks_max"])
        return real(*a, **kw)

    monkeypatch.setattr(TS, "ell_grad_update_fused", spy)
    port = TG.gadget_train(P, y, TG.GadgetConfig(**common), n_counts=nc, device="cpu",
                           draws=TG.RecordedDraws(ids, mix))
    assert calls == [bound] * 10  # the prefetch half-step, once per iteration
    _assert_match(ref, port)
