"""The port's training telemetry against the JAX reference, on the CPU: the
trace ring (scalar and per node) and the stream's segment readings on the
reference's recorded draws and failure masks (values at 1e-5, iterations,
counts and drops exact), telemetry on against off bit for bit, the
observatory's per-node numbers, the registry accounting, and the
Prometheus, JSONL and dump output against the reference's on the same
registry contents.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import telemetry as rtm  # noqa: E402
from repro.core import gadget as G  # noqa: E402
from repro.core.faults import FaultPlan as RefPlan  # noqa: E402
from repro.telemetry import dump as rdump  # noqa: E402
from repro.telemetry import observatory as robs  # noqa: E402
from repro_torch import telemetry as ttm  # noqa: E402
from repro_torch.core import gadget as TG  # noqa: E402
from repro_torch.core.faults import FaultPlan  # noqa: E402
from repro_torch.telemetry import dump as tdump  # noqa: E402
from repro_torch.telemetry import observatory as tobs  # noqa: E402
from tests.test_torch_faults import _ref_draws, _ref_masks  # noqa: E402

M, N_I, D, R = 5, 24, 32, 2
N_COUNTS = np.array([24, 20, 17, 24, 22])
PLAN = FaultPlan(drop_prob=0.3, drop="message", dead_nodes=(3,), seed=6)


def _data(seed=0):
    rng = np.random.default_rng(seed)
    w_true = rng.normal(size=D)
    X = (rng.normal(size=(M, N_I, D)) / np.sqrt(D)).astype(np.float32)
    y = np.sign(X @ w_true).astype(np.float32)
    y[y == 0] = 1.0
    for i, c in enumerate(N_COUNTS):
        X[i, c:], y[i, c:] = 0.0, 0.0
    return X, y


def _pair(topology="random", fused=True, plan=PLAN, iters=18, **kw):
    common = dict(lam=1e-2, batch_size=3, gossip_rounds=R, topology=topology, epsilon=0.0,
                  check_every=6, max_iters=iters, seed=1, fused=fused)
    common.update(kw)
    rcfg = G.GadgetConfig(use_kernels=False, faults=None if plan is None else RefPlan(*plan),
                          **common)
    return rcfg, TG.GadgetConfig(faults=plan, **common)


def _recorded(rcfg, y, plan, iters):
    ids, mix = _ref_draws(rcfg, y, N_COUNTS, iters)
    return TG.RecordedDraws(ids, mix, None if plan is None else _ref_masks(plan, iters, R, M))


def _assert_trace_match(p, r):
    assert (p.every, p.count, p.final_iteration) == (r.every, r.count, r.final_iteration)
    np.testing.assert_array_equal(p.iterations, r.iterations)
    np.testing.assert_array_equal(p.drops, r.drops)
    for name in ("disagreement", "mass_min", "mass_max", "objective"):
        np.testing.assert_allclose(getattr(p, name), getattr(r, name), rtol=1e-5, atol=1e-6,
                                   err_msg=name)
    np.testing.assert_allclose(p.final_disagreement, r.final_disagreement, rtol=1e-5)
    if r.node_disagreement is None:
        assert p.node_disagreement is None and p.node_mass is None and p.node_drops is None
        return
    np.testing.assert_array_equal(p.node_drops, r.node_drops)
    np.testing.assert_allclose(p.node_disagreement, r.node_disagreement, rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(p.node_mass, r.node_mass, rtol=0, atol=1e-5)


@pytest.mark.parametrize("per_node", [False, True], ids=["scalar", "per_node"])
@pytest.mark.parametrize("topology,fused,plan", [
    ("random", True, PLAN), ("random", False, PLAN), ("ring", True, PLAN),
    ("exponential", False, FaultPlan(0.2, "link", (), 2)), ("torus", True, None)])
@pytest.mark.parametrize("every,slots", [(1, 32), (4, 3)])
def test_ring_matches_reference(every, slots, topology, fused, plan, per_node):
    X, y = _data()
    rcfg, tcfg = _pair(topology, fused, plan)
    ref = G.gadget_train(X, y, rcfg, n_counts=N_COUNTS,
                         telemetry=rtm.TrainTelemetry(every, slots, per_node))
    port = TG.gadget_train(X, y, tcfg, n_counts=N_COUNTS, device="cpu",
                           draws=_recorded(rcfg, y, plan, 18),
                           telemetry=ttm.TrainTelemetry(every, slots, per_node))
    _assert_trace_match(port.telemetry, ref.telemetry)
    tr = port.telemetry
    if per_node:
        np.testing.assert_array_equal(tr.node_disagreement.max(axis=1), tr.disagreement)
        np.testing.assert_array_equal(tr.node_drops.sum(axis=1), tr.drops)
    if plan is not None and plan.dead_nodes and per_node:
        assert not tr.node_drops[:, plan.dead_nodes[0]].any()  # a dead sender sends nothing


@pytest.mark.parametrize("per_node", [False, True], ids=["scalar", "per_node"])
@pytest.mark.parametrize("plan", [None, PLAN], ids=["clean", "faulted"])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_telemetry_on_bit_identical_to_off(fused, plan, per_node):
    X, y = _data(seed=1)
    cfg = _pair(fused=fused, plan=plan)[1]
    off = TG.gadget_train(X, y, cfg, n_counts=N_COUNTS, device="cpu")
    on = TG.gadget_train(X, y, cfg, n_counts=N_COUNTS, device="cpu", snapshot_every=5,
                         telemetry=ttm.TrainTelemetry(every=2, slots=4, per_node=per_node))
    assert off.telemetry is None and on.telemetry.count == 4
    assert torch.equal(on.W, off.W) and torch.equal(on.W_avg, off.W_avg)
    np.testing.assert_array_equal(on.objective_trace, off.objective_trace)
    np.testing.assert_array_equal(on.mass_trace, off.mass_trace)
    assert list(on.telemetry.iterations) == [12, 14, 16, 18]


def test_sparse_telemetry_bit_identical():
    from repro_torch.data import svm_datasets as T_ds
    ds = T_ds.make_dataset("reuters", scale=0.03, seed=0, sparse=True)
    P, y, nc = T_ds.partition(ds.X_train, ds.y_train, 4, seed=3)
    cfg = TG.GadgetConfig(lam=ds.lam, batch_size=2, topology="random", max_iters=8,
                          check_every=4, epsilon=0.0, faults=FaultPlan(0.2, "link"))
    off = TG.gadget_train(P, y, cfg, n_counts=nc, device="cpu")
    on = TG.gadget_train(P, y, cfg, n_counts=nc, device="cpu",
                         telemetry=ttm.TrainTelemetry(per_node=True))
    assert torch.equal(on.W, off.W) and on.telemetry.count == 8
    np.testing.assert_allclose(on.telemetry.mass_min, 1.0, atol=1e-6)


@pytest.mark.parametrize("plan", [None, PLAN], ids=["clean", "faulted"])
def test_stream_segment_telemetry_matches_reference(plan):
    X, y = _data(seed=2)
    rcfg, tcfg = _pair(plan=plan, iters=14)
    ref = list(G.gadget_train_stream(X, y, rcfg, segment_iters=5, n_counts=N_COUNTS,
                                     telemetry=rtm.TrainTelemetry()))
    port = list(TG.gadget_train_stream(X, y, tcfg, segment_iters=5, n_counts=N_COUNTS,
                                       device="cpu", draws=_recorded(rcfg, y, plan, 14),
                                       telemetry=ttm.TrainTelemetry()))
    assert [s.iteration for s in port] == [s.iteration for s in ref] == [5, 10, 14]
    for p, r in zip(port, ref):
        assert p.telemetry.drops == r.telemetry.drops
        for name in ("disagreement", "mass_min", "mass_max", "objective"):
            np.testing.assert_allclose(getattr(p.telemetry, name), getattr(r.telemetry, name),
                                       rtol=1e-5, atol=1e-6, err_msg=name)
        np.testing.assert_allclose(p.w_consensus, np.asarray(r.w_consensus), atol=1e-5)
        np.testing.assert_allclose(p.mass, r.mass, atol=1e-5)
    ring = TG.gadget_train(X, y, tcfg, n_counts=N_COUNTS, device="cpu",
                           draws=_recorded(rcfg, y, plan, 14),
                           telemetry=ttm.TrainTelemetry(every=1, slots=14)).telemetry
    assert int(ring.drops.sum()) == sum(s.telemetry.drops for s in port)


def test_registry_accounting_matches_reference():
    X, y = _data(seed=3)
    rcfg, tcfg = _pair(topology="torus", plan=None, iters=8, check_every=8)
    rtm.reset()
    ttm.reset()
    G.gadget_train(X, y, rcfg, n_counts=N_COUNTS)
    TG.gadget_train(X, y, tcfg, n_counts=N_COUNTS, device="cpu")
    for name in ("train.iterations", "train.gossip_bytes"):
        assert ttm.default_registry().value(name) == rtm.default_registry().value(name) > 0
    assert ttm.default_registry().value("kernel.launches", kernel="fleet_half_step") == 8
    list(TG.gadget_train_stream(X, y, tcfg, segment_iters=3, n_counts=N_COUNTS,
                                device="cpu"))
    assert ttm.default_registry().value("train.iterations") == 16
    rtm.reset()
    ttm.reset()


def test_publish_trace_and_zero_iterations():
    X, y = _data()
    reg = ttm.Registry()
    tr = TG.gadget_train(X, y, _pair(plan=PLAN)[1], n_counts=N_COUNTS, device="cpu",
                         telemetry=ttm.TrainTelemetry()).telemetry
    ttm.publish_trace(tr, registry=reg)
    assert reg.value("train.final_disagreement") == tr.final_disagreement
    assert reg.value("train.objective") == tr.objective[-1]
    assert reg.value("train.fault_drops") == int(tr.drops.sum()) > 0
    zero = TG.gadget_train(X, y, _pair(plan=None, iters=0)[1], device="cpu",
                           telemetry=ttm.TrainTelemetry(per_node=True)).telemetry
    assert zero.count == 0 and zero.node_mass.shape == (0, M)
    with pytest.raises(ValueError):
        TG.gadget_train(X, y, _pair(plan=None)[1], device="cpu",
                        telemetry=ttm.TrainTelemetry(every=0))


# -------------------------------------------------------------- observatory


def test_observatory_numbers_match_reference():
    """analyze() on the port's decoded trace against the reference's on its
    own: per-node numbers and the mixing rate (the reference's faulted-fleet
    flags are not held, they fail the reference's own test)."""
    X, y = _data(seed=4)
    rcfg, tcfg = _pair(plan=PLAN, iters=30)
    tele = dict(every=3, slots=16, per_node=True)
    ref = G.gadget_train(X, y, rcfg, n_counts=N_COUNTS, telemetry=rtm.TrainTelemetry(**tele))
    port = TG.gadget_train(X, y, tcfg, n_counts=N_COUNTS, device="cpu",
                           draws=_recorded(rcfg, y, PLAN, 30),
                           telemetry=ttm.TrainTelemetry(**tele))
    rep_r, rep_p = robs.analyze(ref.telemetry), tobs.analyze(port.telemetry)
    assert [h.node for h in rep_p.nodes] == list(range(M))
    for hp, hr in zip(rep_p.nodes, rep_r.nodes):
        assert hp.drops == hr.drops
        np.testing.assert_allclose([hp.disagreement, hp.mass], [hr.disagreement, hr.mass],
                                   rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(rep_p.mixing_rate, rep_r.mixing_rate, rtol=1e-4)
    np.testing.assert_allclose(rep_p.mass_leak, rep_r.mass_leak, atol=1e-5)
    # on one and the same trace the copy is the reference, flags included
    assert tobs.analyze(ref.telemetry) == rep_r
    reg_t, reg_r = ttm.Registry(), rtm.Registry()
    tobs.publish_node_health(rep_r, reg_t)
    robs.publish_node_health(rep_r, reg_r)
    assert reg_t.values() == reg_r.values()
    with pytest.raises(ValueError, match="per-node"):
        tobs.analyze(port.telemetry._replace(node_mass=None))


# ------------------------------------------------------ export and dump CLI


def _fill(reg):
    reg.counter("serve.requests", bucket="8").inc(5)
    reg.counter("serve.requests", bucket="16").inc(2)
    reg.gauge("train.objective").set(0.4375)
    reg.gauge("train.mass_min").set(float("inf"))
    h = reg.histogram("publish.seconds")
    for v in (1e-4, 3e-3, 0.02, 0.02, 7.5):
        h.observe(v)
    with reg.span("train.segment", iteration=5):
        pass


def test_export_matches_reference(tmp_path):
    clock = iter(np.arange(0.0, 100.0, 0.25)).__next__
    reg_t, reg_r = ttm.Registry(clock=clock), rtm.Registry(clock=clock)
    _fill(reg_t)
    _fill(reg_r)
    assert ttm.to_prometheus(reg_t) == rtm.to_prometheus(reg_r)
    assert ttm.registry_records(reg_t, ts=1.5) == rtm.registry_records(reg_r, ts=1.5)
    pt, pr = tmp_path / "t.jsonl", tmp_path / "r.jsonl"
    assert ttm.dump_jsonl(reg_t, pt, ts=2.0) == rtm.dump_jsonl(reg_r, pr, ts=2.0)
    assert pt.read_text() == pr.read_text()
    assert ttm.read_jsonl(pt) == rtm.read_jsonl(pr)
    with ttm.JsonlSink(tmp_path / "sink.jsonl") as sink:
        reg_t.attach_sink(sink)
        with reg_t.span("publish.seconds", iteration=10):
            pass
        reg_t.detach_sink()
    rec = ttm.read_jsonl(tmp_path / "sink.jsonl")
    assert rec[0]["kind"] == "span" and rec[0]["name"] == "publish.seconds"
    assert ttm.write_prometheus(reg_t, tmp_path / "out.prom") == ttm.to_prometheus(reg_t)


@pytest.mark.parametrize("args", [[], ["--tail", "3"], ["--prometheus", "OUT"]],
                         ids=["summary", "tail", "prometheus"])
def test_dump_cli_matches_reference(tmp_path, capsys, args):
    reg = rtm.Registry()
    _fill(reg)
    path = tmp_path / "run.jsonl"
    rtm.dump_jsonl(reg, path, ts=3.0)
    with open(path, "a") as fh:
        fh.write(json.dumps({"ts": 4.0, "kind": "span", "name": "swap", "labels": {},
                             "seconds": 0.5}) + "\n")
    outs = []
    for name, mod in (("t", tdump), ("r", rdump)):
        argv = [str(tmp_path / f"{name}.prom") if a == "OUT" else a for a in args]
        assert mod.main([str(path)] + argv) == 0
        outs.append(capsys.readouterr().out.replace(str(tmp_path / f"{name}.prom"), "OUT"))
    assert outs[0] == outs[1] and outs[0]
    if args and args[0] == "--prometheus":
        assert (tmp_path / "t.prom").read_text() == (tmp_path / "r.prom").read_text()
    assert tdump.summarize(ttm.read_jsonl(path)) == rdump.summarize(rtm.read_jsonl(path))


def _schema_checker():
    """``tools/check_telemetry_schema.py``, the readers' contract, by path."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "tools" / "check_telemetry_schema.py"
    spec = importlib.util.spec_from_file_location("check_telemetry_schema", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_port_stream_meets_the_reference_schema(tmp_path):
    """A short traced port run streamed through the port's ``JsonlSink``
    (the publisher's segment, publish and attempt spans, the watching
    server's swap span linked through the manifest, then a registry dump)
    passes the schema checker the console and the observatory rely on: no
    record errors and no orphan parents."""
    from repro_torch.serve import SvmServer, TrainPublisher
    from repro_torch.telemetry.train import TrainTelemetry
    check = _schema_checker()
    X, y = _data()
    cfg = TG.GadgetConfig(lam=1e-2, batch_size=3, gossip_rounds=R, epsilon=0.0,
                          check_every=6, max_iters=18, seed=1, faults=PLAN)
    path = tmp_path / "run.jsonl"
    reg = ttm.Registry()
    with ttm.JsonlSink(path) as sink:
        reg.attach_sink(sink)
        pub = TrainPublisher(X, y, cfg, root=str(tmp_path / "ckpt"), segment_iters=6,
                             n_counts=N_COUNTS, device="cpu", registry=reg, trace=True,
                             telemetry=TrainTelemetry(every=2, slots=8)).start()
        pub.join()
        srv = SvmServer.watch(str(tmp_path / "ckpt"), device="cpu", registry=reg)
        srv.score(X[0, :4])
        reg.detach_sink()
    ttm.dump_jsonl(reg, path)
    records = ttm.read_jsonl(path)
    names = {r["name"] for r in records}
    assert {"train.segment", "publish.seconds", "publish.attempt", "serve.swap"} <= names
    assert any(r.get("parent_id") for r in records)
    assert check.validate_file(str(path)) == []
    assert check.validate_trace_linkage(list(enumerate(records, 1))) == []
