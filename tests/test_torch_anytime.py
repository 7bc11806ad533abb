"""The port's anytime export on the CPU: the segment stream, resume from a
train state, the snapshot ring, checkpointed train states and the live
publisher.

Within the port the stream is ``gadget_train`` bit for bit and a killed and
resumed run is the uninterrupted one bit for bit, for any chunking: the
port's draws are keyed on the global iteration. Against the reference the
snapshot ring is held at 1e-5 on recorded draws (the reference's own device
ring and host loop are not bit-equal), iterations exact, and checkpoints
carry a train state across the two packages both ways.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import checkpoint as ref_ckpt  # noqa: E402
from repro.core import gadget as G  # noqa: E402
from repro.data import svm_datasets as R_ds  # noqa: E402
from repro.serve import snapshot as ref_snap  # noqa: E402
from repro_torch import checkpoint as t_ckpt  # noqa: E402
from repro_torch.core import gadget as TG  # noqa: E402
from repro_torch.core.faults import FaultPlan  # noqa: E402
from repro_torch.serve import publisher as t_pub  # noqa: E402
from repro_torch.serve import snapshot as t_snap  # noqa: E402
from repro_torch.telemetry import TrainTelemetry  # noqa: E402
from tests.test_torch_gadget import _reference_draws  # noqa: E402

M, N_I, D = 4, 20, 24
N_COUNTS = np.array([20, 17, 20, 15])


def _data(seed=0):
    rng = np.random.default_rng(seed)
    w_true = rng.normal(size=D)
    X = (rng.normal(size=(M, N_I, D)) / np.sqrt(D)).astype(np.float32)
    y = np.sign(X @ w_true).astype(np.float32)
    y[y == 0] = 1.0
    for i, c in enumerate(N_COUNTS):
        X[i, c:], y[i, c:] = 0.0, 0.0
    return X, y


def _ell():
    ds = R_ds.make_dataset("reuters", scale=0.03, seed=0, sparse=True)
    P, y, _ = R_ds.partition(ds.X_train, ds.y_train, M, seed=1)
    return P, y, ds.lam


def _cfg(**kw):
    base = dict(lam=1e-2, batch_size=3, gossip_rounds=2, topology="random", epsilon=0.0,
                check_every=6, max_iters=23, seed=2)
    base.update(kw)
    return TG.GadgetConfig(**base)


def _stream(X, y, cfg, seg, **kw):
    return list(TG.gadget_train_stream(X, y, cfg, segment_iters=seg, n_counts=kw.pop(
        "n_counts", N_COUNTS), device="cpu", **kw))


def _same(a, b):
    return torch.equal(torch.as_tensor(a), torch.as_tensor(b))


FAULTS = FaultPlan(drop_prob=0.3, drop="message", dead_nodes=(2,), seed=4)


@pytest.mark.parametrize("faults", [None, FAULTS], ids=["clean", "faulted"])
@pytest.mark.parametrize("topology,fused", [("random", True), ("random", False),
                                            ("ring", True), ("exponential", False)])
@pytest.mark.parametrize("seg", [1, 5, 6, 23, 40])
def test_stream_bit_matches_gadget_train(seg, topology, fused, faults):
    """Any segment length, against gadget_train at its own check_every: the
    final W, W_sum and consensus bit for bit."""
    X, y = _data()
    cfg = _cfg(topology=topology, fused=fused, faults=faults)
    mono = TG.gadget_train(X, y, cfg, n_counts=N_COUNTS, device="cpu")
    segs = _stream(X, y, cfg, seg)
    assert [s.iteration for s in segs][-1] == mono.iters == 23
    assert all(not s.done for s in segs[:-1]) and segs[-1].done
    assert _same(segs[-1].W, mono.W)
    assert _same(segs[-1].W_sum / mono.iters, mono.W_avg)
    assert _same(segs[-1].w_consensus, mono.w_consensus)


@pytest.mark.parametrize("schedule", ["prefetch", "sweep"])
def test_stream_bit_matches_gadget_train_ell(schedule):
    P, y, lam = _ell()
    cfg = _cfg(lam=lam, sparse_schedule=schedule, max_iters=30, check_every=10)
    mono = TG.gadget_train(P, y, cfg, device="cpu")
    for seg in (7, 10):
        segs = _stream(P, y, cfg, seg, n_counts=None)
        assert _same(segs[-1].W, mono.W) and _same(segs[-1].w_consensus, mono.w_consensus)


def test_stream_segment_readings():
    X, y = _data(seed=1)
    cfg = _cfg(max_iters=12, faults=FaultPlan(drop_prob=0.3, drop="message", seed=1))
    segs = _stream(X, y, cfg, 5, telemetry=TrainTelemetry())
    assert [s.iteration for s in segs] == [5, 10, 12]
    for s in segs:
        assert s.w_consensus.dtype == np.float32 and s.w_consensus.shape == (D,)
        assert s.mass < 1.0 and s.telemetry.mass_min == pytest.approx(s.mass)
        assert s.telemetry.mass_max >= s.telemetry.mass_min and s.telemetry.drops > 0
        assert s.telemetry.objective == pytest.approx(s.objective)
    # the stream's ε and objective are gadget_train's readings at the same cadence
    mono = TG.gadget_train(X, y, cfg._replace(check_every=5), n_counts=N_COUNTS, device="cpu")
    np.testing.assert_array_equal([s.epsilon for s in segs], mono.eps_trace.astype(np.float64))
    np.testing.assert_array_equal([s.objective for s in segs],
                                  mono.objective_trace.astype(np.float64))


def test_stream_epsilon_stop_and_validation():
    X, y = _data()
    segs = _stream(X, y, _cfg(epsilon=1e9), 4)
    assert len(segs) == 1 and segs[0].done and segs[0].iteration == 4
    with pytest.raises(ValueError):
        next(TG.gadget_train_stream(X, y, _cfg(), segment_iters=0, device="cpu"))
    with pytest.raises(ValueError):
        next(TG.gadget_train_stream(X, y, _cfg(max_iters=0), segment_iters=4, device="cpu"))
    with pytest.raises(ValueError):
        next(TG.gadget_train_stream(X, y, _cfg(topology="moebius"), segment_iters=4,
                                    device="cpu"))


@pytest.mark.parametrize("faults", [None, FAULTS], ids=["clean", "faulted"])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_kill_and_resume_bit_identical(fused, faults):
    """Stop after a segment, rebuild a TrainState, continue (also through a
    checkpoint): the final W bit for bit the uninterrupted run's."""
    X, y = _data(seed=2)
    cfg = _cfg(fused=fused, faults=faults)
    full = _stream(X, y, cfg, 4)
    first = next(TG.gadget_train_stream(X, y, cfg, segment_iters=4, n_counts=N_COUNTS,
                                        device="cpu"))
    state = TG.TrainState(first.iteration, first.W, first.W_sum)
    resumed = _stream(X, y, cfg, 4, resume=state)
    assert [s.iteration for s in resumed] == [s.iteration for s in full[1:]]
    assert _same(resumed[-1].W, full[-1].W) and _same(resumed[-1].W_sum, full[-1].W_sum)
    # resuming with another segment length changes nothing either
    assert _same(_stream(X, y, cfg, 7, resume=state)[-1].W, full[-1].W)


def test_resume_through_checkpoint_bit_identical(tmp_path):
    P, y, lam = _ell()
    cfg = _cfg(lam=lam, max_iters=24)
    full = _stream(P, y, cfg, 8, n_counts=None)
    seg = full[1]
    t_snap.to_checkpoint(t_snap.Snapshot(seg.iteration, seg.w_consensus, seg.objective),
                         str(tmp_path), train_state=TG.TrainState(seg.iteration, seg.W,
                                                                  seg.W_sum))
    state = t_snap.train_state_from_checkpoint(str(tmp_path))
    assert state.iteration == 16 and isinstance(state.W, np.ndarray)
    resumed = _stream(P, y, cfg, 8, n_counts=None, resume=state)
    assert [s.iteration for s in resumed] == [24]
    assert _same(resumed[-1].W, full[-1].W)


def test_resume_validation():
    X, y = _data()
    cfg = _cfg()
    bad = TG.TrainState(4, torch.zeros((2, 3)), torch.zeros((2, 3)))
    with pytest.raises(ValueError, match="does not match"):
        next(TG.gadget_train_stream(X, y, cfg, segment_iters=4, device="cpu", resume=bad))
    neg = TG.TrainState(-1, torch.zeros((M, D)), torch.zeros((M, D)))
    with pytest.raises(ValueError, match=">= 0"):
        next(TG.gadget_train_stream(X, y, cfg, segment_iters=4, device="cpu", resume=neg))
    past = TG.TrainState(30, torch.ones((M, D)), torch.ones((M, D)))
    segs = _stream(X, y, cfg, 4, resume=past)  # nothing left: one idle segment
    assert len(segs) == 1 and segs[0].done and segs[0].iteration == 30
    assert segs[0].epsilon == 0.0 and _same(segs[0].W, torch.ones((M, D)))


# ------------------------------------------------------------ snapshot ring


@pytest.mark.parametrize("every,slots,iters", [(5, 8, 23), (4, 3, 23), (6, 2, 24),
                                               (40, 4, 23), (1, 4, 7)])
def test_snapshot_ring_matches_reference(every, slots, iters):
    """The ring against the reference's on the same draws: iterations and
    count exact, weights and objectives at 1e-5, and the decoded snapshots
    (wrap, the final iterate appended once)."""
    X, y = _data(seed=3)
    common = dict(lam=1e-2, batch_size=3, gossip_rounds=2, topology="random", epsilon=0.0,
                  check_every=6, max_iters=iters, seed=2)
    rcfg = G.GadgetConfig(use_kernels=False, **common)
    ref = G.gadget_train(X, y, rcfg, n_counts=N_COUNTS, snapshot_every=every,
                         snapshot_slots=slots)
    ids, mix = _reference_draws(rcfg, y, N_COUNTS, iters)
    port = TG.gadget_train(X, y, TG.GadgetConfig(**common), n_counts=N_COUNTS, device="cpu",
                           draws=TG.RecordedDraws(ids, mix), snapshot_every=every,
                           snapshot_slots=slots)
    r, p = ref.snapshots, port.snapshots
    assert (p.every, p.count, p.final_iteration, p.slots) == (r.every, r.count,
                                                              r.final_iteration, r.slots)
    np.testing.assert_array_equal(p.iterations, r.iterations)
    np.testing.assert_allclose(p.W, r.W, rtol=0, atol=1e-5)
    np.testing.assert_allclose(p.objectives, r.objectives, rtol=1e-5)
    np.testing.assert_allclose(p.final_w, r.final_w, rtol=0, atol=1e-5)
    np.testing.assert_allclose(p.final_objective, r.final_objective, rtol=1e-5)
    got, want = t_snap.snapshots_from(port), ref_snap.snapshots_from(ref)
    assert [s.iteration for s in got] == [s.iteration for s in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.w, w.w, rtol=0, atol=1e-5)
    assert t_snap.latest(port).iteration == iters


def test_snapshots_bit_match_stream_and_leave_trajectory():
    X, y = _data(seed=4)
    cfg = _cfg(faults=FAULTS, max_iters=24)
    plain = TG.gadget_train(X, y, cfg, n_counts=N_COUNTS, device="cpu")
    snap = TG.gadget_train(X, y, cfg, n_counts=N_COUNTS, device="cpu", snapshot_every=6,
                           snapshot_slots=3)
    assert _same(plain.W, snap.W) and plain.snapshots is None
    segs = {s.iteration: s for s in _stream(X, y, cfg, 6)}
    decoded = t_snap.snapshots_from(snap)
    assert [s.iteration for s in decoded] == [12, 18, 24]
    for s in decoded:
        np.testing.assert_array_equal(s.w, segs[s.iteration].w_consensus)
    with pytest.raises(ValueError, match="no snapshots"):
        t_snap.snapshots_from(plain)
    with pytest.raises(ValueError):
        TG.gadget_train(X, y, cfg, device="cpu", snapshot_every=0)
    zero = TG.gadget_train(X, y, cfg._replace(max_iters=0), device="cpu", snapshot_every=3)
    assert zero.snapshots.count == 0 and t_snap.latest(zero).objective == 1.0


# ------------------------------------------------------ checkpointed state


def test_train_state_crosses_packages_both_ways(tmp_path):
    rng = np.random.default_rng(5)
    W, W_sum = rng.normal(size=(M, D)).astype(np.float32), rng.normal(size=(M, D)).astype(
        np.float32)
    w = W.mean(axis=0)
    t_root, r_root = str(tmp_path / "port"), str(tmp_path / "ref")
    t_snap.to_checkpoint(t_snap.Snapshot(9, w, 0.5), t_root, quantize="int8",
                         train_state=TG.TrainState(9, torch.from_numpy(W),
                                                   torch.from_numpy(W_sum)))
    got = ref_snap.train_state_from_checkpoint(t_root)
    assert got.iteration == 9
    np.testing.assert_array_equal(np.asarray(got.W), W)
    np.testing.assert_array_equal(np.asarray(got.W_sum), W_sum)
    ref_snap.to_checkpoint(ref_snap.Snapshot(11, w, 0.4), r_root,
                           train_state=G.TrainState(11, jnp.asarray(W), jnp.asarray(W_sum)))
    back = t_snap.train_state_from_checkpoint(r_root)
    assert back.iteration == 11
    np.testing.assert_array_equal(back.W, W)
    np.testing.assert_array_equal(back.W_sum, W_sum)
    assert t_snap.latest_train_state(r_root).iteration == 11
    assert ref_ckpt.read_latest(t_root) == t_ckpt.read_latest(t_root) == 9


def test_train_state_probe_cold_start(tmp_path):
    assert t_snap.latest_train_state(str(tmp_path / "none")) is None
    root = str(tmp_path / "plain")
    t_snap.to_checkpoint(t_snap.Snapshot(3, np.zeros(D, np.float32), 1.0), root)
    assert t_snap.latest_train_state(root) is None
    with pytest.raises(ValueError, match="no train state"):
        t_snap.train_state_from_checkpoint(root)


# ---------------------------------------------------------------- publisher


def test_publisher_publishes_monotone_versions(tmp_path):
    X, y = _data()
    root = str(tmp_path / "ckpts")
    cfg = _cfg(max_iters=20)
    pub = t_pub.TrainPublisher(X, y, cfg, root=root, segment_iters=5, n_counts=N_COUNTS,
                               device="cpu", trace=True).start()
    final = pub.join()
    assert pub.error is None and not pub.running
    assert pub.published == [5, 10, 15, 20]
    assert final.iteration == 20 and final.done
    assert t_ckpt.read_latest(root) == 20
    for step in pub.published:
        w, extra = t_snap.from_checkpoint(root, step)
        assert extra["iteration"] == step and w.shape == (D,) and "trace" in extra
        assert extra["lam"] == pytest.approx(cfg.lam)
    mono = TG.gadget_train(X, y, cfg._replace(check_every=5), n_counts=N_COUNTS, device="cpu")
    np.testing.assert_array_equal(t_snap.from_checkpoint(root)[0], mono.w_consensus.numpy())
    assert pub.registry.value("publish.segments") == 4


def test_publisher_surfaces_training_errors(tmp_path):
    X, y = _data()
    pub = t_pub.TrainPublisher(X, y, _cfg(topology="moebius"), root=str(tmp_path),
                               segment_iters=5, device="cpu").start()
    with pytest.raises(RuntimeError):
        pub.wait(timeout=30)
    assert pub.error is not None
    with pytest.raises(RuntimeError):
        pub.join()


def test_publisher_retry_recovers_then_poisoned_root_fails(tmp_path, monkeypatch):
    real = t_pub.to_checkpoint
    left = {"n": 2}

    def flaky(*a, **kw):
        if left["n"] > 0:
            left["n"] -= 1
            raise OSError("transient write failure")
        return real(*a, **kw)

    monkeypatch.setattr(t_pub, "to_checkpoint", flaky)
    X, y = _data()
    root = str(tmp_path / "ckpts")
    pub = t_pub.TrainPublisher(X, y, _cfg(max_iters=10), root=root, segment_iters=5,
                               device="cpu", publish_retries=3,
                               publish_backoff=0.001).start()
    assert pub.join().done and pub.published == [5, 10] and pub.publish_retries_used == 2
    monkeypatch.setattr(t_pub, "to_checkpoint", real)
    blocker = tmp_path / "not-a-dir"
    blocker.write_text("")
    bad = t_pub.TrainPublisher(X, y, _cfg(max_iters=10), root=str(blocker), segment_iters=5,
                               device="cpu", publish_retries=2, publish_backoff=0.001).start()
    with pytest.raises(RuntimeError):
        bad.join()
    assert isinstance(bad.error, OSError) and bad.publish_retries_used == 2
    with pytest.raises(ValueError):
        t_pub.TrainPublisher(X, y, _cfg(), root=str(tmp_path), segment_iters=5,
                             resume="not-latest")


def test_publisher_kill_resume_latest_and_fresh_fallback(tmp_path):
    """resume="latest" with no checkpoint trains fresh; after a run killed
    at iteration 10 it continues from the embedded state, bit for bit the
    uninterrupted run."""
    X, y = _data(seed=6)
    cfg = _cfg(max_iters=20, faults=FAULTS)
    root = str(tmp_path / "ckpts")
    first = t_pub.TrainPublisher(X, y, cfg._replace(max_iters=10), root=root,
                                 segment_iters=5, n_counts=N_COUNTS, device="cpu",
                                 save_train_state=True, resume="latest").start()
    first.join()
    assert first.resumed_from is None and first.published == [5, 10]
    second = t_pub.TrainPublisher(X, y, cfg, root=root, segment_iters=5, n_counts=N_COUNTS,
                                  device="cpu", save_train_state=True,
                                  resume="latest").start()
    final = second.join()
    assert second.resumed_from == 10 and second.published == [15, 20]
    full = _stream(X, y, cfg, 5)
    assert _same(final.W, full[-1].W)
    assert t_snap.train_state_from_checkpoint(root).iteration == 20
