"""The device trace of a short steady sub-window, read from torch.profiler
in memory (nothing is written to disk), and what the per-layer readers take
from it: the device operations with their intervals and layers, the traced
window, the busy time and the idle gaps with what the host was doing.

Layers come from ``layers.json``. Its ``spans`` name functions of the
program that :func:`spans` wraps, while it is open, in a profiler range
named ``layer:<layer>``: the benchmark's own spans around the calls into
each layer. A device operation belongs to the innermost range open when
the host issued its launch (matched by the launch's correlation id). Its
``kernels`` rules, patterns on operation names, come first: the port's own
kernels launch through ctypes. An operation that nothing claims is
``other``.
"""
from __future__ import annotations

import contextlib
import functools
import importlib
import json
import re
from pathlib import Path
from typing import Callable, NamedTuple

import numpy as np
import torch

TABLE = json.loads(Path(__file__).with_name("layers.json").read_text())
TOP = 10
GAPS = 200
PREFIX = "layer:"


class Op(NamedTuple):
    name: str
    start: float  # seconds from the window's start
    end: float
    layer: str


class Trace(NamedTuple):
    iters: int           # iterations the traced window ran
    window_s: float      # the traced window's length
    ops: list            # device operations (kernels, copies, sets), as Op
    host: list           # host operators as (name, start, end)

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in merged([(o.start, o.end) for o in self.ops]))

    def layer_seconds(self, layer: str) -> float:
        return sum(o.end - o.start for o in self.ops if o.layer == layer)


def merged(spans: list) -> list:
    """The union of intervals, as sorted disjoint intervals."""
    out: list = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def layer_of(name: str, span: str, rules: list = TABLE["kernels"]) -> str:
    """The layer of a device operation named ``name`` launched inside a range
    of layer ``span`` ("" outside every range)."""
    for rule in rules:
        if re.search(rule["kernel"], name) and rule.get("within", span) == span:
            return rule["layer"]
    return span or "other"


@contextlib.contextmanager
def spans(table: list = TABLE["spans"]):
    """Wrap each listed function of the program in a profiler range named
    after its layer while the block runs."""
    saved = []

    def ranged(fn, layer):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with torch.profiler.record_function(PREFIX + layer):
                return fn(*args, **kwargs)
        return call

    try:
        for entry in table:
            module, _, attr = entry["call"].partition(":")
            owner = importlib.import_module(module)
            *path, name = attr.split(".")
            for part in path:
                owner = getattr(owner, part)
            fn = owner.__dict__[name] if isinstance(owner, type) else getattr(owner, name)
            saved.append((owner, name, fn))
            setattr(owner, name, ranged(fn, entry["layer"]))
        yield
    finally:
        for owner, name, fn in reversed(saved):
            setattr(owner, name, fn)


def record(fn: Callable[[], int], *, layered: bool) -> Trace:
    """Profile ``fn`` (which runs iterations and returns how many) between
    two device syncs and read the trace; ``layered`` opens :func:`spans`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with spans() if layered else contextlib.nullcontext():
            torch.cuda.synchronize()
            iters = fn()
            torch.cuda.synchronize()
    events = prof.profiler.kineto_results.events()
    cpu, dev = [], []
    for e in events:
        (dev if e.device_type() == DeviceType.CUDA else cpu).append(e)
    dev = [e for e in dev if e.end_ns() > e.start_ns() and not e.name().startswith(PREFIX)]
    if not dev:
        raise RuntimeError("the profiler recorded no device operation")
    t0 = min(e.start_ns() for e in events)
    t1 = max(e.end_ns() for e in events)
    ranges = [e for e in cpu if e.name().startswith(PREFIX)]
    r_start = np.array([e.start_ns() for e in ranges], dtype=np.int64)
    r_end = np.array([e.end_ns() for e in ranges], dtype=np.int64)
    # the runtime and driver calls that issued each operation (cudaLaunchKernel,
    # cuLaunchKernel for cuBLAS, cudaMemcpyAsync, ...)
    issued = {e.correlation_id(): e.start_ns() for e in cpu
              if e.name().startswith("cu") and e.correlation_id() > 0}

    def span_of(e) -> str:
        at = issued.get(e.correlation_id())
        if at is None or not ranges:
            return ""
        open_ = np.flatnonzero((r_start <= at) & (r_end >= at))
        if not open_.size:
            return ""
        inner = open_[np.argmin(r_end[open_] - r_start[open_])]
        return ranges[inner].name()[len(PREFIX):]

    ops = [Op(e.name(), (e.start_ns() - t0) * 1e-9, (e.end_ns() - t0) * 1e-9,
              layer_of(e.name(), span_of(e))) for e in dev]
    host = [(e.name(), (e.start_ns() - t0) * 1e-9, (e.end_ns() - t0) * 1e-9) for e in cpu
            if e.end_ns() > e.start_ns() and not e.name().startswith(PREFIX)]
    return Trace(iters, (t1 - t0) * 1e-9, ops, host)


def breakdown(tr: Trace) -> dict:
    """The device operations that took most time, and the ``GAPS`` longest
    idle gaps summed by the innermost host operator running at each gap's
    middle ("python" where none runs)."""
    by_op: dict[str, float] = {}
    for o in tr.ops:
        by_op[o.name] = by_op.get(o.name, 0.0) + (o.end - o.start)
    busy = merged([(o.start, o.end) for o in tr.ops])
    edges = [0.0] + [x for s, e in busy for x in (s, e)] + [tr.window_s]
    gaps = sorted(((s, e) for s, e in zip(edges[::2], edges[1::2]) if e > s),
                  key=lambda g: g[0] - g[1])[:GAPS]
    names = [h[0] for h in tr.host]
    starts = np.array([h[1] for h in tr.host])
    ends = np.array([h[2] for h in tr.host])
    by_host: dict[str, float] = {}
    for s, e in gaps:
        mid = 0.5 * (s + e)
        live = np.flatnonzero((starts <= mid) & (ends >= mid))
        what = names[live[np.argmin(ends[live] - starts[live])]] if live.size else "python"
        by_host[what] = by_host.get(what, 0.0) + (e - s)

    def top(d: dict) -> list:
        return [[k[:120], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]

    return {"device_ops": top(by_op), "idle_gaps": top(by_host)}
