"""The training loop's profiler ranges (``repro_torch.telemetry.region``) on
the CPU: under a CPU ``torch.profiler`` a tiny dense and a tiny ELL stream
record every ``gadget.*`` range, nested as the loop nests them (the
fused random mix collapsed in ``gadget.draws``, under faults after
``gadget.faults``), one
``gadget.step`` an iteration, none of them a user annotation and none open
across a ``next()``; the ranges leave the stream bit for bit; a region
costs under a microsecond with no profiler; and a ``train.segment`` record
brackets its segment's range on the profiler's clock."""
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch._C._profiler import _RecordFunctionFast  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import telemetry as ttm  # noqa: E402
from repro_torch.core import gadget as TG  # noqa: E402
from repro_torch.core.faults import FaultPlan  # noqa: E402
from repro_torch.data import svm_datasets as ds  # noqa: E402

M, N_I, D = 4, 20, 24
SEG, ITERS = 6, 12  # two segments
NEXT = "test.next"  # the consumer's range around each next()
PLAN = FaultPlan(drop_prob=0.3, drop="message", dead_nodes=(2,), seed=4)

# each range and the range it nests in
PARENT = {"gadget.trainer": "gadget.segment", "gadget.check": "gadget.segment",
          "gadget.sync": "gadget.segment", "gadget.draws": "gadget.trainer",
          "gadget.faults": "gadget.trainer", "gadget.collapse": "gadget.trainer",
          "gadget.step": "gadget.trainer", "gadget.gather": "gadget.step",
          "gadget.half_step": "gadget.step", "gadget.mix": "gadget.step",
          "gadget.projection": "gadget.step", "gadget.segment": NEXT}


def _dense():
    rng = np.random.default_rng(0)
    X = (rng.normal(size=(M, N_I, D)) / np.sqrt(D)).astype(np.float32)
    y = np.sign(X @ rng.normal(size=D)).astype(np.float32)
    y[y == 0] = 1.0
    return X, y


def _ell():
    data = ds.make_dataset("reuters", scale=0.03, seed=0, sparse=True)
    P, y, _ = ds.partition(data.X_train, data.y_train, M, seed=1)
    return P, y


CASES = {"dense": (_dense, {}), "dense-faulted": (_dense, {"faults": PLAN}),
         "dense-faulted-unfused": (_dense, {"faults": PLAN, "fused": False}),
         "ell": (_ell, {"sparse_schedule": "prefetch"})}


def _stream(case, **kw):
    make, cfg_kw = CASES[case]
    X, y = make()
    cfg = TG.GadgetConfig(lam=1e-2, batch_size=3, gossip_rounds=2, topology="random",
                          epsilon=0.0, max_iters=ITERS, seed=2, **cfg_kw)
    return TG.gadget_train_stream(X, y, cfg, segment_iters=SEG, device="cpu", **kw)


def _drain(stream) -> list:
    """Every segment, each ``next()`` inside a ``test.next`` range."""
    out = []
    while True:
        with _RecordFunctionFast(NEXT):
            seg = next(stream, None)
        if seg is None:
            return out
        out.append(seg)


def _ranges(prof) -> list:
    """The profiler's ``gadget.*`` and ``test.next`` ranges as
    (name, start_ns, end_ns, is_user_annotation)."""
    return [(e.name(), e.start_ns(), e.end_ns(), e.is_user_annotation())
            for e in prof.profiler.kineto_results.events()
            if e.name().startswith("gadget.") or e.name() == NEXT]


def _inside(r, outer) -> bool:
    return outer[1] <= r[1] and r[2] <= outer[2]


@pytest.mark.parametrize("case", list(CASES))
def test_stream_records_every_range_nested(case):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        segs = _drain(_stream(case))
    assert [s.iteration for s in segs] == [SEG, ITERS]
    ranges = _ranges(prof)
    names = {r[0] for r in ranges}
    want = set(PARENT) | {NEXT}
    _, cfg_kw = CASES[case]
    if "faults" not in cfg_kw:
        want -= {"gadget.faults"}
    if cfg_kw.get("fused") is False:  # the rounds mixed in order: nothing collapsed
        want -= {"gadget.collapse"}
    assert names == want
    assert sum(r[0] == "gadget.step" for r in ranges) == ITERS
    assert sum(r[0] == "gadget.segment" for r in ranges) == len(segs)
    assert not any(r[3] for r in ranges if r[0].startswith("gadget."))
    for r in ranges:
        if r[0] in PARENT:  # within one range of its parent: gadget.segment within one next()
            assert any(_inside(r, p) for p in ranges if p[0] == PARENT[r[0]]), r[0]


@pytest.mark.parametrize("case", ["dense-faulted", "ell"])
def test_ranges_leave_the_stream_bit_for_bit(case):
    plain = list(_stream(case))
    with profile(activities=[ProfilerActivity.CPU]):
        traced = list(_stream(case))
    assert len(plain) == len(traced)
    for a, b in zip(plain, traced):
        assert a.iteration == b.iteration and a.done == b.done
        assert (a.objective, a.epsilon, a.mass) == (b.objective, b.epsilon, b.mass)
        assert torch.equal(a.W, b.W) and torch.equal(a.W_sum, b.W_sum)
        np.testing.assert_array_equal(a.w_consensus, b.w_consensus)


def test_region_costs_under_a_microsecond_with_no_profiler():
    region, n = ttm.region, 100_000
    best = float("inf")
    for _ in range(10):  # the least of ten runs: a loaded machine slows some
        t0 = time.perf_counter()
        for _ in range(n):
            with region("gadget.step"):
                pass
        best = min(best, (time.perf_counter() - t0) / n)
    assert best < 1e-6, f"{best * 1e6:.3f} us a region"


class _ListSink:
    def __init__(self):
        self.records = []

    def emit(self, rec):
        self.records.append(rec)


def test_train_segment_record_brackets_its_range():
    """``[start, ts]`` of each ``train.segment`` record holds its segment's
    ``gadget.segment`` range on the profiler's clock, within 1 ms."""
    reg, sink = ttm.Registry(), _ListSink()
    reg.attach_sink(sink)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        segs = _drain(_stream("dense", trace=True, trace_registry=reg))
    spans = [r for r in sink.records if r["name"] == "train.segment"]
    ranges = sorted((r[1], r[2]) for r in _ranges(prof) if r[0] == "gadget.segment")
    assert len(spans) == len(ranges) == len(segs)
    for rec, (start_ns, end_ns) in zip(spans, ranges):
        assert rec["start"] <= rec["ts"]
        assert rec["start"] - 1e-3 <= start_ns * 1e-9 and end_ns * 1e-9 <= rec["ts"] + 1e-3


def test_span_records_carry_their_start():
    """``Span``, ``TracedSpan`` and ``emit_span`` stamp ``start`` on
    ``time.time()``, the clock of ``ts``: the start of the timed block, or
    the end less ``seconds``."""
    reg, sink = ttm.Registry(), _ListSink()
    reg.attach_sink(sink)
    before = time.time()
    with reg.span("publish.seconds", iteration=1):
        time.sleep(0.01)
    with ttm.TracedSpan(reg, "publish.seconds", ttm.TraceContext.new(), iteration=2):
        time.sleep(0.01)
    ttm.emit_span(reg, "serve.swap", ttm.TraceContext.new(), 0.5, version=3)
    after = time.time()
    for rec in sink.records[:2]:
        assert before <= rec["start"] <= rec["ts"] - 0.009 and rec["ts"] <= after
    swap = sink.records[2]
    assert abs(swap["start"] - (swap["ts"] - 0.5)) < 1e-3
