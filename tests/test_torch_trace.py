"""The port's causal tracing against the reference: ``RequestTracer`` fates
behind the batcher, ``lineage_chains`` / ``format_chain`` and the
``python -m repro_torch.telemetry.trace`` CLI.

Tracers are compared by fates and counts (trace ids are random); lineage
assembly and the CLI run on the same records in both packages and must
print the same text.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

from repro import checkpoint as R_ckpt  # noqa: E402
from repro import serve as R_serve  # noqa: E402
from repro import telemetry as R_tm  # noqa: E402
from repro.core.gadget import GadgetConfig as R_Config  # noqa: E402
from repro.telemetry import trace as R_trace  # noqa: E402
from repro_torch import checkpoint as T_ckpt  # noqa: E402
from repro_torch import serve as T_serve  # noqa: E402
from repro_torch import telemetry as T_tm  # noqa: E402
from repro_torch.core.gadget import GadgetConfig as T_Config  # noqa: E402
from repro_torch.telemetry import trace as T_trace  # noqa: E402
from tests.test_torch_batcher import PKGS, Rig, queries, reconciles  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TRACE = {"repro": R_trace, "repro_torch": T_trace}
TM = {"repro": R_tm, "repro_torch": T_tm}


def _sinked(name, path, clock=None):
    reg = PKGS[name].Registry() if clock is None else PKGS[name].Registry(clock=clock)
    reg.attach_sink(TM[name].JsonlSink(str(path)))
    return reg


def _records(reg, name, path):
    reg.detach_sink()
    return TM[name].read_jsonl(str(path))


# --------------------------------------------------------- RequestTracer


@pytest.mark.parametrize("sample", [1.0, 0.5])
def test_batcher_fates_match_reference(tmp_path, sample):
    """Shed, oversize, deadline and delivered requests behind a traced
    batcher: the traced fates equal the batcher's counters (every request
    sampled) and the reference's, and so do the spans on the sink."""
    qs = queries(9, seed=21, k_max=4)
    out = {}
    for name in PKGS:
        path = tmp_path / f"{name}.jsonl"
        clock = {"t": 0.0}
        reg = _sinked(name, path, clock=lambda: clock["t"])  # spans on the fake clock
        tracer = TRACE[name].RequestTracer(reg, sample=sample, seed=3, clock=lambda: clock["t"])
        rig = Rig(name, registry=reg, tracer=tracer, max_pending=3, admission="shed-oldest",
                  ladder_rows=2)
        rig.clock = clock
        for c, v in qs[:5]:
            rig.submit(c, v)  # 5 into 3 slots: 2 shed
        rig.submit(np.arange(30, dtype=np.int32), np.ones(30, np.float32))  # oversize
        rig.submit(*qs[5], deadline=1.0)
        clock["t"] = 2.0
        rig.drain()
        st = reconciles(rig.mb)
        fates = tracer.fate_counts()
        if sample == 1.0:
            assert fates == {"delivered": st["delivered"], "shed": st["shed"],
                             "deadline": st["deadline_missed"], "rejected": st["rejected"]}
            assert reg.value("trace.requests") == st["submitted"] + st["rejected"]
        recs = _records(reg, name, path)
        spans = [r for r in recs if r["name"] == "serve.request"]
        assert len(spans) == reg.value("trace.requests")
        out[name] = dict(
            fates=fates, requests=reg.value("trace.requests"), pending=tracer.pending,
            kept=sorted((r["rid"] if r["rid"] is not None else -1, r["fate"],
                         r.get("bucket"), r.get("rung")) for r in tracer.sampled_fates()),
            spans=sorted((s["fields"].get("rid", -1), s["fields"]["fate"],
                          s["fields"].get("bucket"), s["fields"].get("rung"),
                          s["fields"].get("reason"), s["seconds"]) for s in spans),
            score_spans=sorted((r["fields"]["bucket"], r["seconds"]) for r in recs
                               if r["name"] == "serve.score.seconds"),
            log=rig.log)
    assert out["repro_torch"] == out["repro"]
    delivered = [s for s in out["repro_torch"]["spans"] if s[1] == "delivered"]
    assert all(s[2] == "k4" and s[3] == 0 for s in delivered)
    if sample == 1.0:
        assert len(delivered) == 2  # rids 3 and 4; rid 5 missed its deadline
    assert 0 < out["repro_torch"]["requests"] <= 7


def test_reservoir_matches_reference():
    """5,000 fates through a 32-slot reservoir: the same retained records
    (``random.Random(seed)`` draws the same slots), exact totals."""
    kept = {}
    for name, tr in TRACE.items():
        clock = {"t": 0.0}
        tracer = tr.RequestTracer(PKGS[name].Registry(), sample=0.7, reservoir=32, seed=9,
                                  clock=lambda: clock["t"])
        for rid in range(5000):
            tracer.start(rid)
            clock["t"] += 0.001
            tracer.finish(rid, "delivered" if rid % 7 else "shed", bucket=f"k{rid % 3}")
        assert len(tracer.sampled_fates()) == 32 and tracer.pending == 0
        kept[name] = (tracer.sampled_fates(), tracer.fate_counts(),
                      tracer.registry.value("trace.requests"))
    assert kept["repro_torch"] == kept["repro"]
    assert 3000 < kept["repro_torch"][2] < 4000


def test_sample_zero_unknown_rid_and_validation_as_reference(tmp_path):
    for name, tr in TRACE.items():
        path = tmp_path / f"{name}.jsonl"
        reg = _sinked(name, path)
        tracer = tr.RequestTracer(reg, sample=0.0)
        tracer.start(1)
        tracer.finish(1, "delivered")
        tracer.reject()
        assert _records(reg, name, path) == []
        assert reg.value("trace.requests") == 0
        tr.RequestTracer(reg).finish(999, "delivered")  # never started: a no-op
        for kw in ({"sample": 1.5}, {"reservoir": 0}):
            with pytest.raises(ValueError):
                tr.RequestTracer(reg, **kw)
    assert T_trace.RequestTracer(T_tm.Registry()).registry is not T_tm.default_registry()
    assert T_trace.RequestTracer().registry is T_tm.default_registry()


def test_score_raise_closes_span_as_reference(tmp_path):
    """A score function that raises still closes the batch's traced span,
    error-annotated, and leaves its requests pending."""
    qs = queries(2, seed=22, k_max=4)
    out = {}
    for name in PKGS:
        path = tmp_path / f"{name}.jsonl"
        reg = _sinked(name, path)
        tracer = TRACE[name].RequestTracer(reg, clock=lambda: 0.0)
        rig = Rig(name, registry=reg, tracer=tracer)

        def boom(b, cols, vals):
            raise RuntimeError("device lost")

        for q in qs:
            rig.submit(*q)
        with pytest.raises(RuntimeError, match="device lost"):
            rig.mb.drain(boom)
        assert rig.mb.pending == 2 and tracer.pending == 2
        out[name] = [(r["kind"], r["name"], r["fields"]) for r in _records(reg, name, path)]
    assert out["repro_torch"] == out["repro"]
    assert out["repro_torch"] == [("span", "serve.score.seconds",
                                   {"bucket": "k4", "error": "RuntimeError: device lost"})]


# ------------------------------------------------------------ lineage


def _chain(tr, version, t0=100.0, *, drop=(), swap_ts=None, attempts=()):
    """Hand-built lineage records for one version, as the trainer, publisher
    and server emit them."""
    root = tr.TraceContext.new()
    pub = root.child()
    swap = pub.child()
    f = tr._trace_fields
    out = [
        {"ts": t0, "kind": "span", "name": "train.segment", "labels": {}, "seconds": 0.5,
         "fields": {"iteration": version, "objective": 0.25}, **f(root)},
        *({"ts": t0 + 0.5 + 0.1 * i, "kind": "span", "name": "publish.attempt", "labels": {},
           "seconds": 0.01, "fields": {"attempt": i, **({"error": err} if err else {})},
           **f(pub.child())} for i, err in enumerate(attempts)),
        {"ts": t0 + 1, "kind": "span", "name": "publish.seconds", "labels": {},
         "seconds": 0.01, "fields": {"iteration": version}, **f(pub)},
        {"ts": t0 + 1.1, "kind": "event", "name": "publish.visible", "labels": {},
         "fields": {"iteration": version}, **f(pub)},
        {"ts": swap_ts if swap_ts is not None else t0 + 2, "kind": "span", "name": "serve.swap",
         "labels": {}, "seconds": 0.02, "fields": {"version": version}, **f(swap)},
        {"ts": t0 + 3, "kind": "event", "name": "serve.first_score", "labels": {},
         "fields": {"version": version}, **f(swap.child())},
        {"ts": t0 + 3.5, "kind": "span", "name": "serve.request", "labels": {},
         "seconds": 0.001, "fields": {"fate": "delivered", "rid": 4}, **f(swap.child())},
    ]
    return [r for r in out if r["name"] not in drop]


def _lineage_records(tr):
    root = tr.TraceContext.new()
    return (_chain(tr, 5, attempts=(None,))
            + _chain(tr, 10, t0=200.0, drop=("serve.swap", "serve.first_score"))
            + _chain(tr, 15, t0=300.0, swap_ts=250.0, attempts=("OSError: disk full", None))
            + _chain(tr, 20, t0=400.0, drop=("publish.visible",))
            + [{"ts": 1.0, "kind": "span", "name": "train.segment", "labels": {},
                "seconds": 0.1, "fields": {}, **tr._trace_fields(root)},  # no version
               {"ts": 2.0, "kind": "counter", "name": "serve.swaps", "labels": {}, "value": 3}])


def test_lineage_chains_and_format_chain_match_reference():
    recs = _lineage_records(T_trace)
    t_chains, r_chains = T_trace.lineage_chains(recs), R_trace.lineage_chains(recs)
    assert t_chains == r_chains
    assert sorted(t_chains) == [5, 10, 15, 20]
    flags = {v: (c["complete"], c["monotone"], len(c["attempts"])) for v, c in t_chains.items()}
    assert flags == {5: (True, True, 1), 10: (False, True, 0), 15: (True, False, 2),
                     20: (True, True, 0)}
    for version, chain in t_chains.items():
        text = T_trace.format_chain(version, chain)
        assert text == R_trace.format_chain(version, chain)
    assert "NON-MONOTONE" in T_trace.format_chain(15, t_chains[15])
    assert "ERROR OSError: disk full" in T_trace.format_chain(15, t_chains[15])
    assert T_trace.LINEAGE_NAMES == R_trace.LINEAGE_NAMES


@pytest.mark.parametrize("args", [[], ["--version", "5"], ["--version", "15"],
                                  ["--version", "7"], "empty"])
def test_cli_matches_reference(tmp_path, capsys, args):
    path = tmp_path / "run.jsonl"
    if args == "empty":
        path.write_text("")
        args = []
    else:
        with open(path, "w") as fh:
            for rec in _lineage_records(T_trace):
                fh.write(json.dumps(rec) + "\n")
    rc_t = T_trace.main([str(path), *args])
    out_t = capsys.readouterr().out
    rc_r = R_trace.main([str(path), *args])
    out_r = capsys.readouterr().out
    assert (rc_t, out_t) == (rc_r, out_r)
    assert rc_t == (1 if args == ["--version", "7"] or not path.stat().st_size else 0)


def test_cli_runs_as_a_module(tmp_path):
    path = tmp_path / "run.jsonl"
    with open(path, "w") as fh:
        for rec in _chain(T_trace, 5):
            fh.write(json.dumps(rec) + "\n")
    out = subprocess.run([sys.executable, "-m", "repro_torch.telemetry.trace", str(path)],
                         cwd=ROOT, capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines()[-1] == "1 chain(s), 1 complete"
    assert "segment-end" in out.stdout and "first-serve" in out.stdout


def _toy_parts(m=3, n_i=20, d=32, seed=0):
    rng = np.random.default_rng(seed)
    w_true = rng.normal(size=d)
    X = rng.normal(size=(m * n_i, d)).astype(np.float32)
    y = np.sign(X @ w_true).astype(np.float32)
    return X.reshape(m, n_i, d), y.reshape(m, n_i)


def test_lineage_end_to_end_matches_reference(tmp_path):
    """A traced publisher and a watching server behind one sink: every
    published version's chain is complete and monotone, from the JSONL
    alone, in both packages; the chains carry the same versions, stages and
    fields."""
    X, y = _toy_parts()
    cfg = dict(lam=1e-3, batch_size=3, gossip_rounds=2, max_iters=10, check_every=5,
               epsilon=0.0)
    runs = {
        "repro": (R_serve, R_ckpt, R_Config(**cfg, use_kernels=False), {},
                  {"use_kernels": False}),
        "repro_torch": (T_serve, T_ckpt, T_Config(**cfg), {"device": "cpu"},
                        {"device": "cpu"}),
    }
    shapes = {}
    for name, (serve, ckpt, gcfg, pub_kw, srv_kw) in runs.items():
        path = tmp_path / f"{name}.jsonl"
        reg = _sinked(name, path)
        root = str(tmp_path / name)
        pub = serve.TrainPublisher(X, y, gcfg, root=root, segment_iters=5, registry=reg,
                                   trace=True, **pub_kw).start()
        pub.join()
        srv = serve.SvmServer.watch(root, registry=reg, **srv_kw)
        Xq = np.random.default_rng(1).normal(size=(2, 32)).astype(np.float32)
        for step in pub.published:
            ckpt.point_latest(root, step)
            srv.maybe_reload()
            srv.score(Xq)
        chains = TRACE[name].lineage_chains(_records(reg, name, path))
        assert sorted(chains) == pub.published == [5, 10]
        for version, chain in chains.items():
            assert chain["complete"] and chain["monotone"], (name, version)
            assert chain["trace_id"] == ckpt.read_manifest(root, version)["extra"]["trace"]["trace_id"]
        shapes[name] = {v: {n: (r["kind"], sorted(r["fields"])) for n, r in c["events"].items()}
                        for v, c in chains.items()}
    assert shapes["repro_torch"] == shapes["repro"]


def test_trace_starts_before_a_drain_can_deliver():
    """A drain on another thread can run between a request's enqueue and
    the start of its trace. The reference starts the trace after releasing
    the queue's lock, so such a drain delivers a request that has no trace
    yet, and the trace started after it never closes. The port starts the
    trace first."""
    q = queries(3, seed=23, k_max=4)
    for name in PKGS:
        rig = Rig(name)
        score = rig.server.scorer_for()

        class Racing(TRACE[name].RequestTracer):
            def start(self, rid):
                if rid == 1:
                    rig.mb.drain(score)  # the drain thread runs here
                super().start(rid)

        tracer = Racing(PKGS[name].Registry(), clock=rig.now)
        rig.mb.tracer = tracer
        for c, v in q:
            rig.submit(c, v)
        rig.drain()
        st = reconciles(rig.mb)
        assert st["delivered"] == 3
        if name == "repro_torch":
            assert tracer.pending == 0 and tracer.fate_counts() == {"delivered": 3}
        else:  # the reference's ordering loses the fate of request 1
            assert tracer.pending == 1 and tracer.fate_counts() == {"delivered": 2}
