"""The readers of the program's host ranges (``gadget.*``) on synthetic
traces, and the ranges against the benchmark's own spans: every host
operator inside a ``layer:<x>`` span of ``layers.json`` lies inside the
program's ``gadget.<x>`` range too, so the two split the device's work
alike."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from perfbench import spec, trace

READERS = {name: spec.load_reader(name) for name in
           ("host_us_per_launch", "half_step_host_us", "mix_host_us")}


def _trace(host) -> trace.Trace:
    """Two iterations, ten device operations, each 0.1 ms from 1 ms on."""
    ops = [trace.Op("kernel", 1e-3 * (1 + i), 1e-3 * (1 + i) + 1e-4, "other") for i in range(10)]
    return trace.Trace(2, 0.02, ops, host)


RANGES = [("gadget.segment", 0.0, 0.015), ("gadget.sync", 0.011, 0.015),
          ("gadget.half_step", 0.001, 0.0015), ("gadget.half_step", 0.006, 0.0065),
          ("gadget.mix", 0.002, 0.0022), ("gadget.mix", 0.007, 0.0074),
          ("aten::mm", 0.002, 0.0021), ("cudaLaunchKernel", 0.0061, 0.0062)]


def test_readers_on_a_synthetic_trace():
    ctx = {"trace": _trace(RANGES)}
    # (15 - 4) ms of host over 10 operations; 2 x 0.5 ms and 0.2 + 0.4 ms over 2 iterations
    assert READERS["host_us_per_launch"](ctx) == pytest.approx(1100.0)
    assert READERS["half_step_host_us"](ctx) == pytest.approx(500.0)
    assert READERS["mix_host_us"](ctx) == pytest.approx(300.0)


@pytest.mark.parametrize("host", [[], [("aten::mm", 0.002, 0.0021)],
                                  [("gadget.sync", 0.011, 0.015)]],
                         ids=["empty", "aten-only", "sync-only"])
def test_readers_read_nothing_without_their_ranges(host):
    ctx = {"trace": _trace(host)}
    assert {name: read(ctx) for name, read in READERS.items()} == dict.fromkeys(READERS)


def test_breakdown_names_gaps_after_the_program_range():
    """An idle gap inside a ``gadget.*`` range, where no operator runs, is
    put down to the range, not to ``python``."""
    host = [("gadget.segment", 0.0, 0.02), ("gadget.step", 0.0011, 0.0019)]
    gaps = dict(trace.breakdown(_trace(host))["idle_gaps"])
    assert gaps["gadget.step"] == pytest.approx(9e-4)
    assert "python" not in gaps and gaps["gadget.segment"] > 0


def _stream(case):
    from repro_torch.core.faults import FaultPlan
    from repro_torch.core.gadget import GadgetConfig, gadget_train_stream
    from repro_torch.data import svm_datasets as ds
    data = ds.make_dataset("reuters", scale=0.03, seed=0, sparse=case == "ell")
    X, y, _ = ds.partition(data.X_train, data.y_train, 4, seed=1)
    faults = FaultPlan(drop_prob=0.3, drop="link", seed=4) if case == "faulted" else None
    cfg = GadgetConfig(lam=1e-2, batch_size=1, gossip_rounds=4, topology="random",
                       epsilon=0.0, max_iters=10, seed=2, faults=faults)
    return gadget_train_stream(X, y, cfg, segment_iters=5, device="cpu")


@pytest.mark.parametrize("case", ["dense", "ell", "faulted"])
def test_every_operator_of_a_layer_span_is_inside_its_program_range(case):
    run = _stream(case)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with trace.spans():
            segs = list(run)
    assert segs[-1].iteration == 10
    events = [(e.name(), e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()]
    ranges: dict = {}
    for name, s, e in events:
        for prefix in (trace.PREFIX, "gadget."):
            if name.startswith(prefix):
                ranges.setdefault((prefix, name[len(prefix):]), []).append((s, e))
    layers = {layer for prefix, layer in ranges if prefix == trace.PREFIX}
    assert layers == {e["layer"] for e in trace.TABLE["spans"]} - (
        set() if case == "faulted" else {"faults"})
    ops = np.array([(s, e) for name, s, e in events if name.startswith("aten::")])
    for layer in layers:
        def within(kind):
            spans = np.array(ranges.get((kind, layer), []), dtype=np.int64).reshape(-1, 2)
            return ((spans[None, :, 0] <= ops[:, None, 0])
                    & (ops[:, None, 1] <= spans[None, :, 1])).any(axis=1)
        inside = within(trace.PREFIX)
        assert inside.any(), layer
        assert within("gadget.")[inside].all(), layer
