"""Bucketed micro-batcher: variable-nnz sparse queries → fixed pad shapes.

A copy of ``repro.serve.batcher`` (the port imports nothing of ``repro``).
Serving traffic is ragged (each query carries its own nonzero count), and
the batcher quantizes the raggedness away: a small fixed ladder of
``(rows, k, n_blocks_max)`` :class:`Bucket` shapes, each query routed to the
narrowest bucket whose ``k`` fits its nnz, batches padded with the inert
``(col=0, val=0)`` convention (``formats.pad_query_planes``; pad rows score
0 and are dropped before results are returned). The server therefore sees
at most ``len(buckets)`` shapes, whatever arrives; ``SvmServer`` counts
them in ``stats()["distinct_shapes"]``.

``n_blocks_max`` is each bucket's grid cap for the touched-block predict
kernel (``ell_scores_prefetch``). :func:`calibrate_buckets` derives it from
a sample of representative queries (the sum of the ``rows`` largest
per-row distinct-block counts, the sound bound training uses); uncalibrated
buckets fall back to the structural ``min(rows·k, n_d_blocks)``.

Accounting: every request is stamped at submit and at result-ready. The
score function returns host arrays (``SvmServer.score_sparse`` copies the
scores off the card, which waits for the kernel), so the done stamp comes
after the device work. Submit→done latency goes into bounded log-bucket
histograms on the batcher's registry (one aggregate series and one per
bucket), so :meth:`MicroBatcher.stats` reports p50/p90/p99 and drain
throughput with flat memory.

Overload policy: the queue is **bounded** when ``max_pending`` is set.
Admission follows :attr:`MicroBatcher.admission`: ``reject-new`` raises a
typed :class:`QueryRejected` at submit, ``shed-oldest`` evicts the head of
the queue and delivers a typed :class:`Shed` result for it, ``block``
parks the submitting thread until a drain frees space. Every request can
carry a **deadline** (absolute time on the batcher clock, defaulted from
``default_timeout``): drains drop expired requests *before* padding and
launch and deliver typed :class:`DeadlineExceeded` results, so a burst
never spends kernel launches on dead work. Every stage has a counter
(``serve.submitted`` / ``serve.rejected{reason=…}`` / ``serve.shed`` /
``serve.deadline_missed`` / ``serve.delivered``), and ``submitted ==
delivered + shed + deadline_missed + pending`` holds at every drain
boundary.
"""
from __future__ import annotations

import math
import threading
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np

from repro_torch.sparse.formats import (DEFAULT_BUCKET_BLK_D, minibatch_block_bound,
                                        pad_query_planes, row_block_counts)
from repro_torch.telemetry import trace as tmtr
from repro_torch.telemetry.registry import Registry

__all__ = ["Bucket", "bucket_ladder", "calibrate_buckets", "MicroBatcher",
           "QueryRejected", "Shed", "DeadlineExceeded", "ADMISSION_POLICIES"]

#: Admission policies for a bounded (``max_pending``) queue, in the order of
#: how much the *submitter* learns: ``reject-new`` pushes back synchronously
#: (typed raise), ``shed-oldest`` accepts and sacrifices the stalest queued
#: request (typed :class:`Shed` result), ``block`` applies backpressure by
#: parking the submitting thread until a drain frees a slot.
ADMISSION_POLICIES = ("reject-new", "shed-oldest", "block")


class QueryRejected(ValueError):
    """Typed submit-time rejection: the query never entered the queue.

    ``reason`` is one of ``"oversize"`` (nnz exceeds the widest bucket —
    malformed traffic; carries ``nnz`` and ``k_max``), ``"queue-full"``
    (bounded queue at capacity under the ``reject-new`` policy; carries
    ``pending`` and ``max_pending``) or ``"block-timeout"`` (``block``
    policy waited ``block_timeout`` real seconds without a slot freeing).
    Subclasses :class:`ValueError` so pre-typed callers that caught the
    old bare ``ValueError`` keep working unchanged.
    """

    def __init__(self, message: str, *, reason: str, nnz: int | None = None,
                 k_max: int | None = None, pending: int | None = None,
                 max_pending: int | None = None):
        super().__init__(message)
        self.reason = reason
        self.nnz = nnz
        self.k_max = k_max
        self.pending = pending
        self.max_pending = max_pending


@dataclass(frozen=True)
class Shed:
    """Typed drain result for a request evicted by ``shed-oldest`` admission:
    it was accepted at ``t_submit`` but sacrificed at ``t_shed`` to admit
    newer work under a full queue. Delivered through the same
    ``drain() -> {rid: result}`` channel as scores, so every accepted
    request's fate is observable."""

    rid: int
    t_submit: float
    t_shed: float
    reason: str = "shed-oldest"


@dataclass(frozen=True)
class DeadlineExceeded:
    """Typed drain result for a request whose deadline passed before it was
    scored: dropped at ``t_expired`` *before* padding/launch, so expired
    work never costs a kernel launch."""

    rid: int
    t_submit: float
    deadline: float
    t_expired: float


@dataclass(frozen=True)
class Bucket:
    """One static serving shape: batches of ``rows`` queries padded to ``k``
    nonzeros each, scored with a ``n_blocks_max``-slot touched-block map."""

    rows: int
    k: int
    n_blocks_max: int

    def __post_init__(self):
        if self.rows < 1 or self.k < 1 or self.n_blocks_max < 1:
            raise ValueError(f"degenerate bucket {self}")


def bucket_ladder(k_max: int, *, rows: int = 8, min_k: int = 16, d: int = None,
                  blk_d: int = DEFAULT_BUCKET_BLK_D) -> tuple[Bucket, ...]:
    """Doubling-``k`` ladder up to ``k_max``: [min_k, 2·min_k, …, ≥ k_max].

    A doubling ladder bounds pad waste at 2× while keeping the shape set
    logarithmic in ``k_max``. ``n_blocks_max`` defaults
    to each rung's structural cap — tighten with :func:`calibrate_buckets`.
    """
    if k_max < 1:
        raise ValueError("k_max must be >= 1")
    n_d_blocks = -(-d // blk_d) if d else None
    ks = []
    k = min(min_k, k_max)
    while k < k_max:
        ks.append(k)
        k *= 2
    ks.append(k_max)

    def cap(k):
        structural = rows * k
        return max(1, min(structural, n_d_blocks) if n_d_blocks else structural)

    return tuple(Bucket(rows, k, cap(k)) for k in ks)


def calibrate_buckets(buckets, sample_cols: np.ndarray, sample_vals: np.ndarray,
                      d: int, *, blk_d: int = DEFAULT_BUCKET_BLK_D
                      ) -> tuple[Bucket, ...]:
    """Tighten every bucket's ``n_blocks_max`` from representative queries.

    ``sample_cols/vals``: (n, k) ELL planes of typical traffic (e.g. a slice
    of the training set). The cap per bucket is
    ``minibatch_block_bound(sample, batch_size=rows)``: sound for any
    ``rows`` sample-like queries, and on Zipf/frequency-ranked text features
    far below the structural bound, which lets the sparse predict kernel
    skip most of w."""
    counts = row_block_counts(sample_cols, sample_vals, blk_d)
    return tuple(
        Bucket(b.rows, b.k, minibatch_block_bound(
            sample_cols, sample_vals, b.rows, blk_d, d=d, counts=counts))
        for b in buckets)


@dataclass
class _Request:
    rid: int
    cols: np.ndarray
    vals: np.ndarray
    t_submit: float
    deadline: float | None = None
    t_done: float | None = None
    scores: np.ndarray | None = None
    label: np.ndarray | None = None


@dataclass
class MicroBatcher:
    """FIFO request queue drained in bucketed, padded batches.

    ``score_fn(bucket, cols, vals)`` — supplied per drain, typically
    ``SvmServer.scorer_for`` — receives exactly ``(bucket.rows, bucket.k)``
    planes and returns ``(scores, labels)`` for every row (pad rows included;
    the batcher drops them). Results are host arrays (``np.asarray``) before
    the done stamp, so latency includes device time, not launch time.

    ``registry`` (optional :class:`repro_torch.telemetry.Registry`): where the
    latency histograms and request/batch counters live — pass the process
    default to fold serving latency into a unified dump, or leave None for a
    private registry per batcher (stats are identical either way).

    Overload knobs (all off by default: an unconfigured batcher is an
    unbounded FIFO):

    * ``max_pending`` — queue capacity; ``None`` keeps the queue unbounded.
    * ``admission`` — what :meth:`submit` does at capacity (one of
      :data:`ADMISSION_POLICIES`; default ``reject-new``).
    * ``default_timeout`` — seconds on the batcher clock after which an
      accepted request expires unless scored; per-request ``deadline=``
      overrides it. ``None`` disables default deadlines.
    * ``block_timeout`` — real-time cap for the ``block`` policy's wait
      (``None`` parks the submitter until a drain frees a slot).

    Tracing: ``tracer`` (optional
    :class:`repro_torch.telemetry.trace.RequestTracer`) samples submissions into
    per-request fate traces — one ``serve.request`` span per sampled request,
    closed by its terminal fate (``delivered`` with the executed bucket and
    the degrade rung at execution, ``shed``, ``deadline``, or ``rejected``
    with the rejection reason) — and each scored batch gets a
    ``serve.score.seconds`` span that closes even when ``score_fn`` raises
    (error-annotated). ``tracer=None`` (default) adds nothing to the hot
    path.

    Submit and drain are thread-safe (one condition variable guards the
    queue and the result ledger); ``score_fn`` runs *outside* the lock so
    an open-loop submitter thread is never serialized behind a kernel
    launch.
    """

    buckets: tuple[Bucket, ...]
    clock: callable = time.monotonic
    registry: Registry | None = None
    max_pending: int | None = None
    admission: str = "reject-new"
    default_timeout: float | None = None
    block_timeout: float | None = None
    tracer: tmtr.RequestTracer | None = None
    _queue: deque = field(default_factory=deque, repr=False)
    _next_rid: int = 0
    _undelivered: dict = field(default_factory=dict, repr=False)
    _batches: int = 0
    _requests: int = 0
    _padded_rows: int = 0
    _drain_seconds: float = 0.0
    _queue_peak: int = 0
    _degraded_bucket: Bucket | None = field(default=None, repr=False)
    _cond: threading.Condition = field(default_factory=threading.Condition,
                                       repr=False)

    def __post_init__(self):
        if not self.buckets:
            raise ValueError("need at least one bucket")
        if self.admission not in ADMISSION_POLICIES:
            raise ValueError(f"admission must be one of {ADMISSION_POLICIES}, "
                             f"got {self.admission!r}")
        if self.max_pending is not None and self.max_pending < 1:
            raise ValueError(f"max_pending must be >= 1, got {self.max_pending}")
        if self.default_timeout is not None and self.default_timeout <= 0:
            raise ValueError(
                f"default_timeout must be > 0, got {self.default_timeout}")
        self.buckets = tuple(sorted(self.buckets, key=lambda b: b.k))
        if self.registry is None:
            self.registry = Registry(clock=self.clock)

    def _latency_hist(self, bucket_label: str):
        return self.registry.histogram("serve.latency_seconds",
                                       bucket=bucket_label)

    def bucket_for(self, nnz: int) -> Bucket:
        """Narrowest bucket that fits ``nnz`` nonzeros; raises a typed
        :class:`QueryRejected` (``reason="oversize"``, carrying the query's
        nnz and the widest rung's k) when none does."""
        for b in self.buckets:
            if b.k >= nnz:
                return b
        self.registry.counter("serve.rejected", reason="oversize").inc()
        raise QueryRejected(
            f"query with {nnz} nonzeros exceeds the widest bucket "
            f"(k={self.buckets[-1].k}) — add a wider rung",
            reason="oversize", nnz=int(nnz), k_max=self.buckets[-1].k)

    # ----------------------------------------------------------- admission

    def _admit_locked(self, n_new: int = 1) -> None:
        """Enforce ``max_pending`` for ``n_new`` incoming requests (caller
        holds the lock). ``reject-new`` raises; ``shed-oldest`` evicts from
        the queue head into typed :class:`Shed` results; ``block`` waits on
        the condition until drains free enough slots (or ``block_timeout``
        real seconds pass)."""
        if self.max_pending is None:
            return
        if self.admission == "reject-new":
            if len(self._queue) + n_new > self.max_pending:
                self.registry.counter("serve.rejected",
                                      reason="queue-full").inc(n_new)
                raise QueryRejected(
                    f"queue full ({len(self._queue)}/{self.max_pending} "
                    f"pending) — reject-new admission",
                    reason="queue-full", pending=len(self._queue),
                    max_pending=self.max_pending)
        elif self.admission == "shed-oldest":
            while len(self._queue) + n_new > self.max_pending and self._queue:
                victim = self._queue.popleft()
                self._undelivered[victim.rid] = Shed(
                    rid=victim.rid, t_submit=victim.t_submit,
                    t_shed=self.t_now())
                self.registry.counter("serve.shed").inc()
                if self.tracer is not None:
                    self.tracer.finish(victim.rid, "shed")
        else:  # block: park the submitter until a drain frees a slot
            t_end = (time.monotonic() + self.block_timeout
                     if self.block_timeout is not None else None)
            while len(self._queue) + n_new > self.max_pending:
                remaining = None if t_end is None else t_end - time.monotonic()
                if remaining is not None and remaining <= 0:
                    self.registry.counter("serve.rejected",
                                          reason="block-timeout").inc(n_new)
                    raise QueryRejected(
                        f"queue full ({len(self._queue)}/{self.max_pending} "
                        f"pending) after blocking {self.block_timeout}s",
                        reason="block-timeout", pending=len(self._queue),
                        max_pending=self.max_pending)
                self._cond.wait(remaining)

    def submit(self, cols, vals, *, deadline: float | None = None) -> int:
        """Enqueue one query (1-D cols/vals of its nonzero features).

        ``deadline`` (optional): absolute time on the batcher clock after
        which the request is dead — an expired request is dropped at drain
        (before any padding or kernel launch) and delivered as a typed
        :class:`DeadlineExceeded` result. Defaults to ``t_now() +
        default_timeout`` when the batcher has a ``default_timeout``, else
        no deadline. Oversize queries and ``reject-new``/``block-timeout``
        admission failures raise :class:`QueryRejected` without enqueuing."""
        cols = np.asarray(cols, np.int32).reshape(-1)
        vals = np.asarray(vals, np.float32).reshape(-1)
        try:
            self.bucket_for(len(cols))  # reject oversize at submit, not drain
            with self._cond:
                self._admit_locked()
                now = self.t_now()
                if deadline is None and self.default_timeout is not None:
                    deadline = now + self.default_timeout
                rid = self._next_rid
                self._next_rid += 1
                if self.tracer is not None:
                    # before the request is in the queue: a drain on another
                    # thread must not deliver it before its trace exists (the
                    # reference starts it after the lock, and so loses fates)
                    self.tracer.start(rid)
                self._queue.append(_Request(rid, cols, vals, now,
                                            deadline=deadline))
                self.registry.counter("serve.submitted").inc()
                self._queue_peak = max(self._queue_peak, len(self._queue))
        except QueryRejected as e:
            if self.tracer is not None:
                # refused at the door: no rid, zero-duration rejected span
                self.tracer.reject(reason=e.reason)
            raise
        return rid

    def submit_csr(self, csr, *, deadline: float | None = None) -> list[int]:
        """Enqueue every row of a CSR chunk; returns the request ids in row
        order. The streaming ingestion path: feed
        ``data.libsvm.iter_libsvm_chunks`` chunks straight in, so a serving
        replica never materializes its query set — each row's (cols, vals)
        slice views the chunk's arrays (copied into the pad planes only at
        drain). ``csr`` is anything with CSR attributes ``data`` / ``indices``
        / ``indptr`` (``repro_torch.sparse.CSR``, scipy.sparse.csr_matrix).

        All-or-nothing on validity: **every** row's nnz is checked against
        the widest bucket before anything is enqueued, so an oversize row in
        the middle of a chunk raises :class:`QueryRejected` with zero rows
        queued. Admission (``max_pending``) is still enforced per row — a
        ``reject-new`` queue-full raise mid-chunk keeps the rows admitted
        before it.
        ``deadline`` applies to every row of the chunk."""
        indptr = np.asarray(csr.indptr)
        indices = np.asarray(csr.indices, np.int32)
        data = np.asarray(csr.data, np.float32)
        nnz = np.diff(indptr)
        widest = self.buckets[-1].k
        bad = np.nonzero(nnz > widest)[0]
        if bad.size:
            self.registry.counter("serve.rejected",
                                  reason="oversize").inc(int(bad.size))
            if self.tracer is not None:
                self.tracer.reject(reason="oversize")
            raise QueryRejected(
                f"chunk row {int(bad[0])} with {int(nnz[bad[0]])} nonzeros "
                f"exceeds the widest bucket (k={widest}) — "
                f"{int(bad.size)} oversize row(s), nothing enqueued",
                reason="oversize", nnz=int(nnz[bad[0]]), k_max=widest)
        return [
            self.submit(indices[indptr[i]:indptr[i + 1]],
                        data[indptr[i]:indptr[i + 1]], deadline=deadline)
            for i in range(len(indptr) - 1)
        ]

    def t_now(self) -> float:
        """Current time on the batcher's clock (injectable for tests)."""
        return self.clock()

    @property
    def pending(self) -> int:
        """Number of submitted-but-undrained requests in the queue."""
        return len(self._queue)

    # ---------------------------------------------------------- degradation

    def degrade_to(self, bucket: Bucket | None) -> None:
        """Route **all** traffic to one rung (the overload ladder's cheapest-
        bucket step): queries wider than ``bucket.k`` are truncated to their
        ``k`` largest-|value| features at drain time (counted in
        ``serve.truncated`` — an explicit accuracy-for-latency trade), so
        every launch uses that one shape. ``None`` restores
        normal narrowest-fit routing. Takes effect from the next drain;
        queued requests keep their full feature lists until then."""
        if bucket is not None and bucket not in self.buckets:
            raise ValueError(f"{bucket} is not one of this batcher's buckets")
        self._degraded_bucket = bucket

    def _route(self, r: _Request) -> tuple[Bucket, _Request]:
        """Pick the bucket for one request, applying degraded routing."""
        b = self._degraded_bucket
        if b is None:
            return self.bucket_for(len(r.cols)), r
        if len(r.cols) > b.k:
            keep = np.argpartition(np.abs(r.vals), len(r.vals) - b.k)[-b.k:]
            keep.sort()  # preserve column order in the truncated planes
            r.cols, r.vals = r.cols[keep], r.vals[keep]
            self.registry.counter("serve.truncated").inc()
        return b, r

    # --------------------------------------------------------------- drain

    def _expire(self, reqs: list[_Request], now: float) -> list[_Request]:
        """Split off expired requests: each becomes a typed
        :class:`DeadlineExceeded` result (+ ``serve.deadline_missed``);
        returns the still-live ones."""
        live = []
        for r in reqs:
            if r.deadline is not None and now >= r.deadline:
                with self._cond:
                    self._undelivered[r.rid] = DeadlineExceeded(
                        rid=r.rid, t_submit=r.t_submit, deadline=r.deadline,
                        t_expired=now)
                self.registry.counter("serve.deadline_missed").inc()
                if self.tracer is not None:
                    self.tracer.finish(r.rid, "deadline")
            else:
                live.append(r)
        return live

    def drain(self, score_fn) -> dict[int, tuple[np.ndarray, np.ndarray]]:
        """Score every pending request; returns {rid: result}.

        A result is a ``(scores, label)`` tuple for scored requests, or a
        typed :class:`Shed` / :class:`DeadlineExceeded` record for accepted
        requests the overload policy dropped — callers distinguish with
        ``isinstance``. Requests are grouped by bucket in FIFO order and
        emitted in full ``bucket.rows``-sized pad shapes — partial tail
        batches still launch at the bucket shape (pad rows are inert), so
        shapes stay static. Expired requests are dropped before padding (and
        re-checked per batch right before each launch), so dead work never
        reaches the device.

        If ``score_fn`` raises, the exception propagates but no request or
        result is lost: batches not yet scored (including the failing one)
        go back on the queue, and results scored before the failure are held
        and delivered by the next successful drain."""
        t0 = self.t_now()
        with self._cond:
            popped = list(self._queue)
            self._queue.clear()
            self._cond.notify_all()  # freed slots: wake block-policy submitters
        by_bucket: dict[Bucket, list[_Request]] = {}
        for r in self._expire(popped, self.t_now()):
            bucket, r = self._route(r)
            by_bucket.setdefault(bucket, []).append(r)
        batches = [
            (bucket, reqs[i:i + bucket.rows])
            for bucket, reqs in by_bucket.items()
            for i in range(0, len(reqs), bucket.rows)
        ]
        n_scored = 0
        try:
            for bucket, chunk in batches:
                # deadline re-check at launch time: a long multi-batch drain
                # must not launch work that died while earlier batches ran
                chunk = self._expire(chunk, self.t_now())
                batches[n_scored] = (bucket, chunk)
                if not chunk:
                    n_scored += 1
                    continue
                cols, vals = pad_query_planes(
                    [(r.cols, r.vals) for r in chunk], bucket.rows, bucket.k)
                if self.tracer is not None:
                    # the span closes on the exception path too: a flaky
                    # score_fn raise still records it, error-annotated
                    with tmtr.TracedSpan(self.registry, "serve.score.seconds",
                                         tmtr.TraceContext.new(),
                                         bucket=f"k{bucket.k}"):
                        scores, labels = score_fn(bucket, cols, vals)
                        scores = np.asarray(scores)  # force inside the span
                        labels = np.asarray(labels)
                else:
                    scores, labels = score_fn(bucket, cols, vals)
                    scores, labels = np.asarray(scores), np.asarray(labels)  # host arrays
                t_done = self.t_now()
                self._batches += 1
                self._padded_rows += bucket.rows - len(chunk)
                self.registry.counter("serve.batches",
                                      bucket=f"k{bucket.k}").inc()
                agg = self._latency_hist("all")
                per = self._latency_hist(f"k{bucket.k}")
                rung = (int(self.tracer.registry.value("serve.degrade_rung")
                            or 0) if self.tracer is not None else 0)
                with self._cond:
                    for j, r in enumerate(chunk):
                        r.scores, r.label, r.t_done = scores[j], labels[j], t_done
                        self._undelivered[r.rid] = (r.scores, r.label)
                        lat = t_done - r.t_submit
                        agg.observe(lat)
                        per.observe(lat)
                    self._requests += len(chunk)
                    self.registry.counter("serve.delivered").inc(len(chunk))
                if self.tracer is not None:
                    for r in chunk:
                        self.tracer.finish(r.rid, "delivered",
                                           bucket=f"k{bucket.k}", rung=rung)
                n_scored += 1
        finally:
            with self._cond:
                for bucket, chunk in batches[n_scored:]:
                    self._queue.extend(chunk)
            self._drain_seconds += self.t_now() - t0
        with self._cond:
            out, self._undelivered = self._undelivered, {}
        return out

    # --------------------------------------------------------------- stats

    def stats(self) -> dict:
        """Latency/throughput over everything drained so far.

        Percentiles come from the bounded log-bucket histograms (bucket upper
        edges, within one ~19% growth factor of exact — the overflow bucket
        reports the true max), never from raw per-request lists:
        ``latency_p50/p90/p99_ms`` over all traffic plus a
        ``per_bucket_latency_ms`` breakdown keyed ``k<bucket.k>``. Overload
        accounting rides along: ``submitted`` / ``delivered`` / ``shed`` /
        ``deadline_missed`` / ``rejected`` counter totals, the live
        ``pending`` depth and its high-water mark ``queue_peak`` — at every
        drain boundary ``submitted == delivered + shed + deadline_missed +
        pending`` (rejected requests were never admitted)."""
        n = self._requests

        def pct(h, q):
            if h is None or not h.count:
                return float("nan")
            return float(h.quantile(q) * 1e3)

        def cnt(name, **labels):
            return int(self.registry.value(name, **labels) or 0)

        agg = self.registry.get("serve.latency_seconds", bucket="all")
        per_bucket = {}
        for b in self.buckets:
            hb = self.registry.get("serve.latency_seconds", bucket=f"k{b.k}")
            if hb is not None and hb.count:
                per_bucket[f"k{b.k}"] = {
                    "count": hb.count,
                    "p50_ms": pct(hb, 0.50),
                    "p90_ms": pct(hb, 0.90),
                    "p99_ms": pct(hb, 0.99),
                    "max_ms": float(hb.max * 1e3) if math.isfinite(hb.max) else float("nan"),
                }
        return {
            "requests": n,
            "batches": self._batches,
            "padded_rows": self._padded_rows,
            "pad_fraction": (self._padded_rows / max(1, n + self._padded_rows)),
            "latency_p50_ms": pct(agg, 0.50),
            "latency_p90_ms": pct(agg, 0.90),
            "latency_p99_ms": pct(agg, 0.99),
            "per_bucket_latency_ms": per_bucket,
            "queries_per_sec": n / self._drain_seconds if self._drain_seconds else float("nan"),
            "drain_seconds": self._drain_seconds,
            "pending": len(self._queue),
            "queue_peak": self._queue_peak,
            "submitted": cnt("serve.submitted"),
            "delivered": cnt("serve.delivered"),
            "shed": cnt("serve.shed"),
            "deadline_missed": cnt("serve.deadline_missed"),
            "rejected": sum(cnt("serve.rejected", reason=r)
                            for r in ("oversize", "queue-full",
                                      "block-timeout")),
            "truncated": cnt("serve.truncated"),
        }
