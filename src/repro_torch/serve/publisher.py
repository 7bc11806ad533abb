"""Live checkpoint publisher: train in the background, flush every segment.

A port of ``repro.serve.publisher`` (the port imports nothing of
``repro``). The producing half of the live train-to-serve loop:
:class:`TrainPublisher` runs :func:`repro_torch.core.gadget.gadget_train_stream`
(its trajectory one ``gadget_train`` call's, bit for bit) in a daemon
thread, and at every segment boundary exports the current consensus model
through :func:`repro_torch.serve.snapshot.to_checkpoint`:

  * **versioned** — the checkpoint step is the global training iteration, so
    versions are strictly monotone across a run;
  * **atomic** — ``repro_torch.checkpoint`` stages in a temp dir and publishes via
    one ``os.rename``, so a concurrently-polling server never sees a torn
    checkpoint;
  * **discoverable** — each save advances the root's ``LATEST`` pointer,
    which ``SvmServer.watch(root).maybe_reload()`` polls between drains.

Publish cadence is ``segment_iters`` (training iterations per checkpoint);
``keep=0`` (the default here, unlike the offline exporter) retains every
version so a reader can never race a rotation and rollback targets survive.

Hardening (the fault-tolerance layer):

  * **Publish retries** — transient checkpoint-write failures (full disk,
    flaky network filesystem) are retried with capped exponential backoff
    before the run is declared failed; attempts are counted in
    :attr:`publish_retries_used`.
  * **Error surfacing** — a training-thread exception is captured, flagged
    via :attr:`error`, and re-raised by *both* :meth:`join` and :meth:`wait`
    — a supervisor parked on either call can never mistake a crashed run for
    a finished one. The publisher itself never kills the serving process
    that owns it.
  * **Crash-resume** — ``save_train_state=True`` embeds the full per-node
    :class:`~repro_torch.core.gadget.TrainState` in every checkpoint, and
    ``resume="latest"`` (or an explicit ``TrainState``) continues a killed
    run from its last published state, bit-identical to the uninterrupted
    trajectory (the stream keys its draws on the global iteration counter).
"""
from __future__ import annotations

import threading
import time

import numpy as np

from repro_torch import checkpoint as ckpt
from repro_torch.core.gadget import (GadgetConfig, NonFiniteWeightsError, SegmentResult,
                                     TrainState, gadget_train_stream)
from repro_torch.serve.snapshot import Snapshot, latest_train_state, to_checkpoint
from repro_torch.telemetry import trace as tmtr
from repro_torch.telemetry.registry import Registry
from repro_torch.telemetry.train import TrainTelemetry

__all__ = ["TrainPublisher"]


class TrainPublisher:
    """Background trainer that publishes a servable checkpoint per segment.

    ``X_parts``/``y_parts``/``cfg``/``n_counts`` follow the
    ``gadget_train`` conventions (dense (m, n_i, d) or ``EllPartitions``
    planes; (m, n_i) ±1 labels with 0 on pad rows); ``device`` (CUDA unless
    given) and ``draws`` pass through to the stream. ``root`` is the
    checkpoint directory the serving side watches. ``segment_iters`` sets
    the publish cadence; ``quantize`` (None | "int8") and ``keep`` pass
    through to :func:`~repro_torch.serve.snapshot.to_checkpoint`.

    Fault tolerance:

    * ``publish_retries`` / ``publish_backoff`` / ``publish_backoff_cap`` —
      each checkpoint write gets ``1 + publish_retries`` attempts, sleeping
      ``publish_backoff * 2**k`` (capped) between them; only the final
      failure propagates. :attr:`publish_retries_used` counts retries spent.
    * ``save_train_state=True`` embeds the resumable
      :class:`~repro_torch.core.gadget.TrainState` in every checkpoint.
    * ``resume`` — an explicit ``TrainState``, or ``"latest"`` to probe
      ``root`` for the newest embedded state (falling back to a fresh run
      when none exists); the resolved choice is recorded in
      :attr:`resumed_from` (the resume iteration, or None for fresh).

    Telemetry: ``telemetry`` (a :class:`repro_torch.telemetry.TrainTelemetry`)
    forwards to the stream, attaching per-segment flight-recorder readings to
    every ``SegmentResult``; ``registry`` is where the publisher's own series
    land — a ``publish.seconds`` span per flushed segment plus
    ``publish.segments`` / ``publish.retries`` counters, and the segment's
    disagreement/objective/drop readings mirrored beside them. Private per
    publisher by default; pass a shared registry for a unified dump.

    Tracing: ``trace=True`` turns on version-lineage tracing — the stream
    roots one :class:`~repro_torch.telemetry.trace.TraceContext` per segment
    (``train.segment`` span on :attr:`registry`), each publish extends it
    with a ``publish.seconds`` span (plus one ``publish.attempt`` child span
    per write attempt, error-annotated on OSError retries — same trace_id
    across attempts) and a ``publish.visible`` event marking the LATEST
    pointer handoff (emitted immediately before the pointer write, so every
    watcher swap timestamp causally follows it — the checkpoint is written
    unpointed and only becomes observable at the handoff), and the context
    is embedded in the checkpoint manifest
    (``extra["trace"]``) so the serving watcher's swap span links back. On
    ``resume="latest"`` the fresh run starts new traces but stamps the prior
    run's trace_id onto the first segment span as ``resumed_from_trace``.
    ``trace=False`` (default) emits nothing — byte-identical telemetry to
    the pre-tracing publisher.

    Lifecycle: ``start()`` launches the daemon thread and returns ``self``;
    ``join()`` blocks until training converges (or ``cfg.max_iters``) and
    returns the final :class:`~repro_torch.core.gadget.SegmentResult`. Both
    ``join()`` and a completed ``wait(timeout)`` re-raise a training-thread
    exception. ``published`` grows by one step number per flushed checkpoint
    (monotone — append-only under the GIL, safe to read concurrently).
    """

    def __init__(self, X_parts, y_parts, cfg: GadgetConfig = GadgetConfig(), *,
                 root: str, segment_iters: int, n_counts=None, device=None, draws=None,
                 quantize: str | None = None, keep: int = 0,
                 save_train_state: bool = False,
                 resume: TrainState | str | None = None,
                 publish_retries: int = 3, publish_backoff: float = 0.05,
                 publish_backoff_cap: float = 1.0,
                 telemetry: TrainTelemetry | None = None,
                 registry: Registry | None = None,
                 trace: bool = False):
        if resume is not None and resume != "latest" \
                and not isinstance(resume, TrainState):
            raise ValueError(
                f"resume must be None, 'latest', or a TrainState; got {resume!r}")
        if publish_retries < 0:
            raise ValueError(f"publish_retries must be >= 0, got {publish_retries}")
        self.root = root
        self.cfg = cfg
        self.segment_iters = int(segment_iters)
        self.quantize = quantize
        self.keep = int(keep)
        self.save_train_state = bool(save_train_state)
        self.resume = resume
        self.resumed_from: int | None = None
        self.publish_retries = int(publish_retries)
        self.publish_backoff = float(publish_backoff)
        self.publish_backoff_cap = float(publish_backoff_cap)
        self.publish_retries_used = 0
        self.telemetry = telemetry
        # publish.* series land here: one "publish.seconds" span per flushed
        # segment, "publish.segments" / "publish.retries" counters, and the
        # per-segment train.* gauges the stream writes when telemetry is on.
        self.registry = registry if registry is not None else Registry()
        self.trace = bool(trace)
        self._trace_link: str | None = None
        self._data = (X_parts, y_parts, n_counts)
        self._device, self._draws = device, draws
        self.published: list[int] = []
        self.final: SegmentResult | None = None
        self.error: BaseException | None = None
        self._done = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="gadget-train-publisher")

    # ----------------------------------------------------------- lifecycle

    def start(self) -> "TrainPublisher":
        """Launch the training thread (idempotence not attempted — one
        publisher is one training run). Returns ``self`` for chaining."""
        self._thread.start()
        return self

    def _resolve_resume(self) -> TrainState | None:
        """Materialize the ``resume`` argument into a TrainState (or None).

        When tracing and resuming from the watched root, also recover the
        prior run's trace_id from the resume checkpoint's manifest — the
        fresh run's first segment span links back to it
        (``resumed_from_trace``)."""
        if self.resume is None:
            return None
        state = (latest_train_state(self.root) if self.resume == "latest"
                 else self.resume)
        self.resumed_from = None if state is None else int(state.iteration)
        if self.trace and state is not None and self.resume == "latest":
            try:
                extra = ckpt.read_manifest(self.root).get("extra") or {}
                prior = tmtr.TraceContext.from_extra(extra.get("trace"))
                self._trace_link = prior.trace_id if prior else None
            except (OSError, ValueError):
                self._trace_link = None
        return state

    def _run(self) -> None:
        X_parts, y_parts, n_counts = self._data
        try:
            for seg in gadget_train_stream(X_parts, y_parts, self.cfg,
                                           segment_iters=self.segment_iters,
                                           n_counts=n_counts, device=self._device,
                                           draws=self._draws,
                                           resume=self._resolve_resume(),
                                           telemetry=self.telemetry,
                                           trace=self.trace,
                                           trace_link=self._trace_link,
                                           trace_registry=self.registry):
                self._publish(seg)
                self.final = seg
        except BaseException as e:  # surfaced via join()/wait()/error
            self.error = e
        finally:
            self._done.set()

    def _publish(self, seg: SegmentResult) -> None:
        if not np.all(np.isfinite(np.asarray(seg.w_consensus))):
            # Defense in depth: the stream raises its own typed failure at
            # the segment boundary, so this only fires when a caller hands
            # _publish a crafted/corrupted segment — either way a NaN plane
            # must never become a published checkpoint a watcher would swap
            # in. Surfaced like any training failure via join()/wait().
            self.registry.counter("publish.nonfinite").inc()
            raise NonFiniteWeightsError(seg.iteration, context="publish")
        snap = Snapshot(iteration=seg.iteration, w=seg.w_consensus,
                        objective=seg.objective)
        train_state = None
        if self.save_train_state:
            train_state = TrainState(iteration=seg.iteration, W=seg.W,
                                     W_sum=seg.W_sum)
        # The publish span is a child of the segment's lineage root; its
        # context rides into the checkpoint manifest so the serving watcher
        # can link its swap span back. TracedSpan (vs the plain registry
        # span) closes on the exception path too — a final-attempt OSError
        # still records the span, error-annotated.
        pub_ctx = seg.trace.child() if seg.trace is not None else None
        span_cm = (tmtr.TracedSpan(self.registry, "publish.seconds", pub_ctx,
                                   iteration=seg.iteration)
                   if pub_ctx is not None
                   else self.registry.span("publish.seconds",
                                           iteration=seg.iteration))
        with span_cm:
            for attempt in range(self.publish_retries + 1):
                t_att = time.monotonic()
                try:
                    # point=False: the checkpoint is complete on disk but
                    # invisible to pointer-following watchers until the
                    # explicit handoff below — publish records must land
                    # before any swap can observe the version, or chain
                    # timestamps go non-monotone under thread scheduling.
                    to_checkpoint(snap, self.root, quantize=self.quantize,
                                  keep=self.keep, lam=self.cfg.lam,
                                  train_state=train_state,
                                  trace=(pub_ctx.to_extra()
                                         if pub_ctx is not None else None),
                                  point=False)
                    if pub_ctx is not None:
                        tmtr.emit_span(self.registry, "publish.attempt",
                                       pub_ctx.child(),
                                       time.monotonic() - t_att,
                                       attempt=attempt)
                    break
                except OSError as e:
                    if pub_ctx is not None:
                        # per-attempt child span, same trace_id as the run:
                        # the retry story is reconstructable from the JSONL
                        tmtr.emit_span(self.registry, "publish.attempt",
                                       pub_ctx.child(),
                                       time.monotonic() - t_att,
                                       attempt=attempt,
                                       error=f"OSError: {e}")
                    if attempt == self.publish_retries:
                        raise
                    self.publish_retries_used += 1
                    self.registry.counter("publish.retries").inc()
                    time.sleep(min(self.publish_backoff * 2 ** attempt,
                                   self.publish_backoff_cap))
        if pub_ctx is not None:
            # emitted after the publish span record closes and BEFORE the
            # pointer handoff, so chain timestamps are causally monotone:
            # segment-end < publish-end <= visible <= pointer-land <= swap
            tmtr.emit_event(self.registry, "publish.visible", pub_ctx,
                            iteration=seg.iteration)
        # the handoff: only now can a watcher's maybe_reload observe the
        # version (monotone by construction — publisher steps only grow)
        ckpt.point_latest(self.root, seg.iteration)
        self.registry.counter("publish.segments").inc()
        if seg.telemetry is not None:
            # Mirror the segment's flight-recorder readings next to the
            # publish series, so one registry tells the whole producer story.
            self.registry.gauge("train.final_disagreement").set(
                seg.telemetry.disagreement)
            self.registry.gauge("train.objective").set(seg.telemetry.objective)
            self.registry.counter("train.fault_drops").inc(seg.telemetry.drops)
        self.published.append(seg.iteration)

    def _raise_error(self) -> None:
        if self.error is not None:
            raise RuntimeError("training thread failed") from self.error

    def wait(self, timeout: float | None = None) -> bool:
        """Block until training finishes (or ``timeout`` seconds); True when
        done. Re-raises the captured training-thread error once the run is
        done, so a supervisor parked here cannot mistake a crash for
        success; a timeout returns False without consuming the error."""
        done = self._done.wait(timeout)
        if done:
            self._raise_error()
        return done

    def join(self, timeout: float | None = None) -> SegmentResult | None:
        """Join the training thread and return the final segment result.

        Re-raises a training-thread exception here, on the caller's thread.
        Returns None only when ``timeout`` expired before completion."""
        self._thread.join(timeout)
        self._raise_error()
        return self.final if self._done.is_set() else None

    @property
    def running(self) -> bool:
        """True while the training thread is alive."""
        return self._thread.is_alive()
