"""The port's serving queue (``MicroBatcher``) against the reference.

Each test runs one script on both packages: the same seeded numpy queries,
one fake clock injected into each batcher, and each package's ``SvmServer``
on the CPU at a small d (the reference through its jitted plain scorer, the
port through its kernels' plain versions). The two must agree on every typed
fate and rejection, on the result dicts (scores within 1e-5, labels
exactly), on ``stats()`` key for key (the fake clock makes the latency keys
deterministic too) and on the batcher registry's counters.
"""
import dataclasses
import math
import threading
import time
import tracemalloc

import numpy as np
import pytest

pytest.importorskip("torch")

from repro import serve as R_serve  # noqa: E402
from repro.sparse import formats as R_fmt  # noqa: E402
from repro.telemetry import trace as R_trace  # noqa: E402
from repro.telemetry.registry import Registry as R_Registry  # noqa: E402
from repro_torch import serve as T_serve  # noqa: E402
from repro_torch.sparse import formats as T_fmt  # noqa: E402
from repro_torch.telemetry import trace as T_trace  # noqa: E402
from repro_torch.telemetry.registry import Registry as T_Registry  # noqa: E402

ATOL = 1e-5
D = 640          # 5 d-blocks of 128
K_MAX = 24


class Pkg:
    """One package's serving pieces."""

    def __init__(self, serve, fmt, trace, registry, server):
        self.serve, self.fmt, self.trace, self.Registry = serve, fmt, trace, registry
        self.server = server


PKGS = {
    "repro": Pkg(R_serve, R_fmt, R_trace, R_Registry,
                 lambda W, **kw: R_serve.SvmServer(W, use_kernels=False, **kw)),
    "repro_torch": Pkg(T_serve, T_fmt, T_trace, T_Registry,
                       lambda W, **kw: T_serve.SvmServer(W, device="cpu", **kw)),
}


def weights(C=1, d=D, seed=0):
    W = np.random.default_rng(seed).normal(size=(C, d)).astype(np.float32)
    return W[0] if C == 1 else W


def queries(n, seed, *, d=D, k_max=K_MAX, min_nnz=1):
    """n seeded ragged queries: sorted distinct columns, normal values."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        nnz = int(rng.integers(min_nnz, k_max + 1))
        cols = np.sort(rng.choice(d, size=nnz, replace=False)).astype(np.int32)
        out.append((cols, rng.normal(size=nnz).astype(np.float32)))
    return out


class Rig:
    """A batcher in front of a server, on a fake clock, logging every
    outcome in a form both packages can be compared on."""

    def __init__(self, name, *, W=None, buckets=None, tracer=None, registry=None,
                 ladder_rows=4, **mb_kw):
        self.name = name
        self.pkg = p = PKGS[name]
        self.clock = {"t": 0.0}
        clk = self.now
        self.server = p.server(weights() if W is None else W)
        if buckets is None:
            buckets = p.serve.bucket_ladder(K_MAX, rows=ladder_rows, min_k=4, d=D)
        self.mb = p.serve.MicroBatcher(buckets, clock=clk, registry=registry,
                                       tracer=tracer, **mb_kw)
        self.log = []

    def now(self):
        return self.clock["t"]

    def submit(self, cols, vals, **kw):
        try:
            rid = self.mb.submit(cols, vals, **kw)
        except self.pkg.serve.QueryRejected as e:
            self.log.append(("rejected", e.reason, e.nnz, e.k_max, e.pending, e.max_pending))
            return None
        self.log.append(("submitted", rid))
        return rid

    def submit_csr(self, csr, **kw):
        try:
            rids = self.mb.submit_csr(csr, **kw)
        except self.pkg.serve.QueryRejected as e:
            self.log.append(("rejected_csr", e.reason, e.nnz, e.k_max, self.mb.pending))
            return None
        self.log.append(("submitted_csr", tuple(rids)))
        return rids

    def drain(self, score_fn=None):
        out = self.mb.drain(score_fn or self.server.scorer_for())
        self.log.append(("drain", fates(out)))
        return out


def fates(out):
    """{rid: (fate, payload)} for a drain's result dict."""
    res = {}
    for rid, r in out.items():
        if isinstance(r, tuple):
            res[rid] = ("delivered", (np.asarray(r[0]), np.asarray(r[1])))
        else:
            res[rid] = (type(r).__name__, dataclasses.asdict(r))
    return res


def assert_same_value(a, b, where):
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), where
        for k in a:
            assert_same_value(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same_value(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, where
        if a.dtype.kind == "f" and b.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=0, atol=ATOL, err_msg=where)
        else:
            np.testing.assert_array_equal(a, b, err_msg=where)
    elif isinstance(a, float) and isinstance(b, float) and math.isnan(a):
        assert math.isnan(b), where
    else:
        assert a == b, (where, a, b)


def assert_same_label_dtypes(port, ref):
    """Labels of delivered results carry the reference's dtype."""
    for (kind, payload), (_, ref_payload) in zip(port.values(), ref.values()):
        if kind == "delivered":
            assert payload[1].dtype == ref_payload[1].dtype


def assert_rigs_agree(rigs):
    port, ref = rigs["repro_torch"], rigs["repro"]
    assert_same_value(port.log, ref.log, "log")
    for (op, *rest), (_, *ref_rest) in zip(port.log, ref.log):
        if op == "drain":
            assert_same_label_dtypes(rest[0], ref_rest[0])
    assert_same_value(port.mb.stats(), ref.mb.stats(), "stats")
    assert port.mb.registry.values() == ref.mb.registry.values()
    assert port.server.stats()["distinct_shapes"] == ref.server.stats()["distinct_shapes"]


def both(script, **rig_kw):
    """Run ``script(rig)`` on a rig of each package; returns the rigs."""
    rigs = {name: Rig(name, **rig_kw) for name in PKGS}
    for rig in rigs.values():
        script(rig)
    assert_rigs_agree(rigs)
    return rigs


def reconciles(mb):
    st = mb.stats()
    assert st["submitted"] == st["delivered"] + st["shed"] + st["deadline_missed"] + st["pending"]
    return st


# ------------------------------------------------------------------ drain


@pytest.mark.parametrize("calibrated", [False, True])
def test_unbounded_drain_matches_reference(calibrated):
    qs = queries(37, seed=1)
    sample = queries(64, seed=2)

    def script(rig):
        if calibrated:
            fmt = rig.pkg.fmt
            cols, vals = fmt.pad_query_planes(sample, len(sample), K_MAX)
            rig.mb = rig.pkg.serve.MicroBatcher(
                rig.pkg.serve.calibrate_buckets(rig.mb.buckets, cols, vals, D), clock=rig.now)
        for c, v in qs[:20]:
            rig.clock["t"] += 0.25
            rig.submit(c, v)
        rig.clock["t"] += 1.0
        rig.drain()
        for c, v in qs[20:]:
            rig.clock["t"] += 0.5
            rig.submit(c, v)
        rig.drain()
        rig.drain()  # nothing pending: an empty result
        reconciles(rig.mb)

    rigs = both(script)
    st = rigs["repro_torch"].mb.stats()
    assert st["delivered"] == 37 and st["batches"] >= 4 and len(st["per_bucket_latency_ms"]) > 1
    assert st["latency_p50_ms"] > 0
    delivered = {}
    for op, *rest in rigs["repro_torch"].log:
        if op == "drain":
            delivered.update(rest[0])
    W = weights()
    assert sorted(delivered) == list(range(37))
    for rid, (kind, (score, label)) in delivered.items():
        c, v = qs[rid]
        assert kind == "delivered"
        np.testing.assert_allclose(score, (v * W[c]).sum(), rtol=0, atol=ATOL)


@pytest.mark.parametrize("C", [1, 3])
def test_multiclass_results_match_reference(C):
    qs = queries(11, seed=3 + C)

    def script(rig):
        for c, v in qs:
            rig.submit(c, v)
        rig.drain()

    both(script, W=weights(C, seed=C))


# --------------------------------------------------------------- admission


def test_reject_new_matches_reference():
    qs = queries(12, seed=4)

    def script(rig):
        for c, v in qs[:5]:
            rig.submit(c, v)  # the last two raise queue-full
        rig.drain()
        for c, v in qs[5:]:
            rig.submit(c, v)
        rig.drain()
        st = reconciles(rig.mb)
        assert st["rejected"] == 6 and st["queue_peak"] == 3

    both(script, max_pending=3, admission="reject-new")


def test_shed_oldest_matches_reference():
    qs = queries(14, seed=5)

    def script(rig):
        for i, (c, v) in enumerate(qs):
            rig.clock["t"] += 0.1
            rig.submit(c, v)
            if i == 8:
                rig.drain()
        rig.drain()
        st = reconciles(rig.mb)
        assert st["shed"] == 8 and st["delivered"] == 6 and st["queue_peak"] == 3

    rigs = both(script, max_pending=3, admission="shed-oldest")
    sheds = [p for op, *r in rigs["repro_torch"].log if op == "drain"
             for kind, p in r[0].values() if kind == "Shed"]
    assert all(s["reason"] == "shed-oldest" and s["t_shed"] >= s["t_submit"] for s in sheds)


def test_block_matches_reference():
    """``block`` parks a submitter until a drain frees a slot, and times out
    into a typed rejection. The submitter thread's exception, if any, is
    re-raised here."""
    qs = queries(4, seed=6)

    def script(rig):
        rig.submit(*qs[0])
        rig.submit(*qs[1])
        t0 = time.monotonic()
        rig.submit(*qs[2])  # block-timeout after 0.05 s of real time
        assert time.monotonic() - t0 >= 0.04
        rig.mb.block_timeout = None
        errors, rids = [], []

        def submitter():
            try:
                rids.append(rig.mb.submit(*qs[3]))
            except BaseException as e:  # handed to the main thread
                errors.append(e)

        th = threading.Thread(target=submitter, daemon=True)
        th.start()
        time.sleep(0.05)
        assert th.is_alive() and rig.mb.pending == 2  # parked, nothing lost
        rig.drain()
        th.join(timeout=10)
        assert not th.is_alive()
        if errors:
            raise errors[0]
        rig.log.append(("submitted", rids[0]))  # logged here: the log's order is the script's
        rig.drain()
        st = reconciles(rig.mb)
        assert st["rejected"] == 1 and st["delivered"] == 3

    both(script, max_pending=2, admission="block", block_timeout=0.05)


def test_knob_validation_matches_reference():
    for name, p in PKGS.items():
        b = p.serve.bucket_ladder(8, rows=2, min_k=4)
        for kw, match in (({"admission": "drop-all"}, "admission"),
                          ({"max_pending": 0}, "max_pending"),
                          ({"default_timeout": 0.0}, "default_timeout")):
            with pytest.raises(ValueError, match=match):
                p.serve.MicroBatcher(b, **kw)
        with pytest.raises(ValueError, match="at least one bucket"):
            p.serve.MicroBatcher(())
        mb = p.serve.MicroBatcher(b)
        with pytest.raises(ValueError, match="not one of"):
            mb.degrade_to(p.serve.Bucket(2, 5, 10))
        assert issubclass(p.serve.QueryRejected, ValueError)
    assert T_serve.ADMISSION_POLICIES == R_serve.ADMISSION_POLICIES


# ------------------------------------------------------------- deadlines


def test_deadlines_match_reference():
    """Deadlines from ``default_timeout`` and per request, expiry at the
    drain and at the re-check before each launch (the score function moves
    the clock on, as a slow batch would): expired work never reaches the
    score function."""
    qs = queries(16, seed=7, k_max=4)

    def script(rig):
        calls = []
        score = rig.server.scorer_for()

        def slow(b, cols, vals):
            calls.append(b.k)
            rig.clock["t"] += 1.0
            return score(b, cols, vals)

        for i, (c, v) in enumerate(qs):
            rig.submit(c, v, deadline=(None if i % 5 == 0 else 20.0 if i % 5 == 1 else None))
            rig.clock["t"] += 0.1
        rig.clock["t"] = 2.95  # the default timeout of the first ones has passed
        out = rig.drain(slow)
        dead = [r for r in out.values() if isinstance(r, rig.pkg.serve.DeadlineExceeded)]
        assert dead and len(calls) == rig.mb.stats()["batches"]
        assert all(d.t_expired >= d.deadline for d in dead)
        reconciles(rig.mb)

    rigs = both(script, default_timeout=3.0, ladder_rows=2)
    st = rigs["repro_torch"].mb.stats()
    assert st["deadline_missed"] > 0 and st["delivered"] > 0


@pytest.mark.parametrize("seed", range(8))
def test_deadline_expiry_schedules_match_reference(seed):
    """Random submit / advance / drain schedules: a request expires iff its
    deadline passed at drain time, every rid gets one result, and both
    packages log the same outcomes."""
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(rng.integers(5, 30)):
        op = int(rng.integers(0, 3))
        ops.append((op, int(rng.integers(0, 2)), float(rng.integers(0, 5)),
                    float(rng.integers(0, 4))))
    qs = queries(len(ops), seed=100 + seed)

    def script(rig):
        open_reqs = {}
        for i, (op, immortal, dl, step) in enumerate(ops):
            if op == 0:
                deadline = None if immortal else rig.clock["t"] + dl
                open_reqs[rig.submit(*qs[i], deadline=deadline)] = deadline
            elif op == 1:
                rig.clock["t"] += step
            else:
                now = rig.clock["t"]
                out = rig.drain()
                assert sorted(out) == sorted(open_reqs)
                for rid, deadline in open_reqs.items():
                    expired = deadline is not None and now >= deadline
                    assert isinstance(out[rid], rig.pkg.serve.DeadlineExceeded) == expired
                open_reqs.clear()
                reconciles(rig.mb)
        rig.drain()
        assert reconciles(rig.mb)["pending"] == 0

    both(script)


# --------------------------------------------------------------- submit_csr


@pytest.mark.parametrize("container", ["own", "scipy"])
def test_submit_csr_all_or_nothing_matches_reference(container):
    X = np.zeros((6, D), np.float32)
    rng = np.random.default_rng(8)
    for i in range(6):
        nnz = 30 if i == 3 else int(rng.integers(1, 10))  # row 3 is wider than k = 24
        X[i, rng.choice(D, size=nnz, replace=False)] = rng.normal(size=nnz)
    good = np.delete(X, 3, axis=0)

    def make(rig, M):
        if container == "scipy":
            from scipy.sparse import csr_matrix
            return csr_matrix(M)
        return rig.pkg.fmt.CSR.from_dense(M)

    def script(rig):
        rig.clock["t"] = 1.0
        assert rig.submit_csr(make(rig, X)) is None
        assert rig.mb.pending == 0 and rig.mb.stats()["submitted"] == 0
        assert len(rig.submit_csr(make(rig, good), deadline=5.0)) == 5
        rig.drain()
        st = reconciles(rig.mb)
        assert st["rejected"] == 1 and st["delivered"] == 5

    both(script)


# ------------------------------------------------------------ degradation


def test_degraded_routing_truncates_ties_as_reference():
    """Under ``degrade_to`` a wide query keeps its k largest |values|, chosen
    by the reference's argpartition call, so ties keep the same features;
    the scores say which features were kept."""
    cols = np.arange(0, 640, 64, dtype=np.int32)  # 10 features, 10 weights
    vals = np.array([1.0, -1.0, 0.5, 1.0, -2.0, 1.0, -1.0, 0.25, 1.0, -1.0], np.float32)
    W = (2.0 ** np.arange(D) % 1021).astype(np.float32)  # distinct per column

    def script(rig):
        rig.mb.degrade_to(rig.mb.buckets[0])  # k = 4
        rid = rig.submit(cols, vals)
        rig.submit(cols[:3], vals[:3])  # narrow enough: not truncated
        out = rig.drain()
        assert rig.mb.stats()["truncated"] == 1
        rig.kept_score = float(np.asarray(out[rid][0]).reshape(()))
        rig.mb.degrade_to(None)
        rig.submit(cols, vals)
        rig.drain()

    rigs = both(script, W=W)
    port = rigs["repro_torch"]
    keep = np.argpartition(np.abs(vals), len(vals) - 4)[-4:]
    keep.sort()
    assert port.kept_score == pytest.approx(float((vals[keep] * W[cols[keep]]).sum()), abs=ATOL)
    assert port.kept_score == rigs["repro"].kept_score


# --------------------------------------------------------------- failures


def test_score_failures_redeliver_as_reference():
    qs = queries(8, seed=9, k_max=4)

    def script(rig):
        state = {"calls": 0, "fails": 0}
        score = rig.server.scorer_for()

        def flaky(b, cols, vals):
            state["calls"] += 1
            if state["calls"] % 2 == 0 and state["fails"] < 3:
                state["fails"] += 1
                raise RuntimeError("boom")
            return score(b, cols, vals)

        for c, v in qs:
            rig.submit(c, v)
        for _ in range(3):
            with pytest.raises(RuntimeError, match="boom"):
                rig.mb.drain(flaky)
            assert rig.mb.pending > 0  # the failed and unreached batches requeued
            rig.log.append(("failed", rig.mb.pending))
        rig.drain(flaky)
        st = reconciles(rig.mb)
        assert st["delivered"] == 8 and st["pending"] == 0

    both(script, ladder_rows=2)


# -------------------------------------------------------------------- soak


def _pump(mb, n, score_fn):
    cols = np.array([1, 2], np.int32)
    vals = np.array([1.0, 0.5], np.float32)
    for i in range(n):
        mb.submit(cols, vals)
        assert mb.pending <= 64
        if i % 512 == 0:
            mb.drain(score_fn)
    mb.drain(score_fn)


def _ok(b, cols, vals):
    return np.zeros(b.rows, np.float32), np.ones(b.rows, np.float32)


def test_shedding_soak_flat_memory():
    """50k submissions against a 64-slot shed-oldest queue: pending never
    exceeds the bound, the ledger drains, memory stays flat (bounded
    histograms and queue), and the counts are the reference's."""
    stats = {}
    for name, p in PKGS.items():
        mb = p.serve.MicroBatcher((p.serve.Bucket(4, 4, 16),), max_pending=64,
                                  admission="shed-oldest", clock=lambda: 0.0)
        _pump(mb, 10_000, _ok)  # warm every structure before measuring
        if name == "repro_torch":
            tracemalloc.start()
            base, _ = tracemalloc.get_traced_memory()
        _pump(mb, 40_000, _ok)
        if name == "repro_torch":
            now, _ = tracemalloc.get_traced_memory()
            tracemalloc.stop()
            assert now - base < 256 * 1024, f"the batcher grew {(now - base) / 1024:.0f} KiB"
        stats[name] = reconciles(mb)
    assert_same_value(stats["repro_torch"], stats["repro"], "stats")
    st = stats["repro_torch"]
    assert st["submitted"] == 50_000 and st["pending"] == 0 and st["queue_peak"] <= 64
    assert st["delivered"] + st["shed"] == 50_000
