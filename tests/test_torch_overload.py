"""The port's ``DegradeLadder`` against the reference.

Both packages get the same pressure sequence (the same seeded queries
submitted and drained on one fake clock per package) in front of each
package's ``SvmServer`` on the CPU. The rung after every observation, the
``serve.degrade_*`` series, the served results (scores within 1e-5, labels
exactly) and the served shapes must agree.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

from tests.test_torch_batcher import (PKGS, Rig, assert_rigs_agree, assert_same_value,  # noqa: E402
                                      queries, reconciles, weights)


def ladder_rigs(*, max_pending=4, ladder_kw=None, **rig_kw):
    rigs = {name: Rig(name, max_pending=max_pending, admission="shed-oldest", **rig_kw)
            for name in PKGS}
    for rig in rigs.values():
        rig.ladder = rig.pkg.serve.DegradeLadder(rig.server, rig.mb, **(ladder_kw or {}))
    return rigs


def observe(rig):
    rung = rig.ladder.observe()
    rig.log.append(("rung", rung, rig.server.plane, rig.mb._degraded_bucket is not None))
    return rung


def ladder_series(rig):
    return {k: v for k, v in rig.server.registry.values().items()
            if k.startswith(("serve.degrade", "serve.plane_swaps"))}


def assert_ladders_agree(rigs):
    assert_rigs_agree(rigs)
    port, ref = rigs["repro_torch"], rigs["repro"]
    assert port.ladder.rung == ref.ladder.rung
    assert ladder_series(port) == ladder_series(ref)
    s_p, s_r = port.server.stats(), ref.server.stats()
    for key in ("degraded", "plane", "plane_swaps", "distinct_shapes", "queries", "batches"):
        assert s_p[key] == s_r[key], key


def test_hysteresis_rung_sequence_matches_reference():
    qs = queries(40, seed=11)
    rigs = ladder_rigs()
    for rig in rigs.values():
        it = iter(qs)
        rig.ladder.prepare()
        for _ in range(4):
            rig.submit(*next(it))  # pressure 1.0
        for _ in range(5):
            observe(rig)  # 0, 1, 1, 2, 2 (capped at max_rung)
        rig.drain()  # pressure 0
        for _ in range(4):
            observe(rig)  # 2, 1, 1, 0: recovery is hysteretic too
        for _ in range(3):
            rig.submit(*next(it))  # 0.75: at the high watermark
        observe(rig)
        observe(rig)
        rig.drain()
        rig.rungs = [e[1] for e in rig.log if e[0] == "rung"]
    assert_ladders_agree(rigs)
    port = rigs["repro_torch"]
    assert port.rungs == [0, 1, 1, 2, 2, 2, 1, 1, 0, 0, 1]
    reg = port.server.registry
    assert reg.value("serve.degrade_steps", direction="down") == 3
    assert reg.value("serve.degrade_steps", direction="up") == 2
    assert reg.value("serve.degrade_rung") == 1.0


@pytest.mark.parametrize("max_rung", [1, 2])
def test_in_band_pressure_and_max_rung_match_reference(max_rung):
    qs = queries(30, seed=12)
    rigs = ladder_rigs(ladder_kw={"max_rung": max_rung, "patience": 2})
    for rig in rigs.values():
        it = iter(qs)
        for fill in (4, 2, 4, 4, 4, 4, 1, 0, 0, 0, 0):
            if rig.mb.pending > fill:
                rig.drain()
            while rig.mb.pending < fill:
                rig.submit(*next(it))
            observe(rig)
    assert_ladders_agree(rigs)
    rungs = [e[1] for e in rigs["repro_torch"].log if e[0] == "rung"]
    # the band at 0.5 resets the first streak; max_rung caps the descent
    want = {1: [0, 0, 0, 1, 1, 1, 1, 0, 0, 0, 0], 2: [0, 0, 0, 1, 1, 2, 2, 1, 1, 0, 0]}
    assert rungs == want[max_rung]


def test_latency_slo_drives_the_ladder_as_reference():
    """No bounded queue: only the p99 against the SLO drives the ladder (the
    fake clock makes every latency the same in both packages)."""
    qs = queries(24, seed=13)
    rigs = {name: Rig(name) for name in PKGS}
    for rig in rigs.values():
        rig.ladder = rig.pkg.serve.DegradeLadder(rig.server, rig.mb, latency_slo_ms=50.0,
                                                 patience=1)
        it = iter(qs)
        for wait_s in (0.01, 0.2, 0.2, 0.01):
            for _ in range(6):
                rig.submit(*next(it))
            rig.clock["t"] += wait_s
            rig.drain()
            observe(rig)
        rig.log.append(("pressure", rig.ladder.pressure()))
    assert_ladders_agree(rigs)
    rungs = [e[1] for e in rigs["repro_torch"].log if e[0] == "rung"]
    assert rungs == [0, 1, 2, 2]  # p99 is a high-water mark: it stays blown


def test_transitions_add_no_shapes_and_serve_as_reference():
    """Warm every bucket at full service, then walk the ladder down and back:
    the int8 plane and the truncated routing serve the reference's results
    and the served shapes stay flat."""
    qs = queries(64, seed=14)
    rigs = ladder_rigs(max_pending=8)
    for rig in rigs.values():
        it = iter(qs)
        rig.ladder.prepare()
        for b in rig.mb.buckets:  # one query of each bucket's width: every shape warm
            cols = np.arange(b.k, dtype=np.int32) * 20
            rig.submit(cols, np.linspace(-1, 1, b.k).astype(np.float32))
        rig.drain()
        rig.shapes0 = rig.server.stats()["distinct_shapes"]
        for _ in range(8):
            rig.submit(*next(it))
        for _ in range(4):
            observe(rig)
        assert rig.ladder.rung == 2
        rig.drain()  # int8 plane, everything in the narrowest bucket, truncated
        for _ in range(6):
            observe(rig)
        assert rig.ladder.rung == 0
        for _ in range(8):
            rig.submit(*next(it))
        rig.drain()
        reconciles(rig.mb)
        assert rig.server.stats()["distinct_shapes"] == rig.shapes0
    assert_ladders_agree(rigs)
    st = rigs["repro_torch"].mb.stats()
    assert st["truncated"] > 0
    assert rigs["repro_torch"].server.stats()["plane_swaps"] >= 2


def test_ladder_trace_events_match_reference(tmp_path):
    qs = queries(8, seed=15)
    records = {}
    for name, rig in ladder_rigs(ladder_kw={"trace": True, "patience": 1}).items():
        path = tmp_path / f"{name}.jsonl"
        from repro_torch.telemetry.export import JsonlSink, read_jsonl
        rig.server.registry.attach_sink(JsonlSink(str(path)))
        for q in qs[:4]:
            rig.submit(*q)
        observe(rig)
        observe(rig)
        rig.drain()
        observe(rig)
        rig.server.registry.detach_sink()
        records[name] = [(r["kind"], r["name"], r["fields"]) for r in read_jsonl(str(path))
                         if r["name"] == "serve.degrade"]
    assert records["repro_torch"] == records["repro"]
    assert [f["rung"] for _, _, f in records["repro_torch"]] == [1, 2, 1]


def test_hot_swap_while_degraded_matches_reference():
    W2 = np.random.default_rng(16).normal(size=64).astype(np.float32)
    qs = queries(6, seed=17, d=64, k_max=8)
    planes = {}
    for name, p in PKGS.items():
        srv = p.server(weights(d=64))
        srv.set_plane("int8")
        srv.swap_weights(W2)
        assert srv.plane == "int8"
        cols, vals = p.fmt.pad_query_planes(qs, 8, 8)
        planes[name] = (np.asarray(srv._planes["int8"]), srv.score_sparse(cols, vals))
        q, scale = p.serve.quantize_int8(W2)
        np.testing.assert_array_equal(planes[name][0], p.serve.dequantize_int8(q, scale))
        srv.set_plane("f32")
        np.testing.assert_array_equal(np.asarray(srv._planes["f32"]), W2)
    np.testing.assert_array_equal(planes["repro_torch"][0], planes["repro"][0])
    assert_same_value(planes["repro_torch"][1], planes["repro"][1], "scores")


def test_ladder_knob_validation_matches_reference():
    for name, p in PKGS.items():
        srv = p.server(weights(d=64))
        mb = p.serve.MicroBatcher(p.serve.bucket_ladder(8, rows=2, min_k=4))
        for kw, match in (({"high": 0.2, "low": 0.5}, "low < high"),
                          ({"patience": 0}, "patience"), ({"max_rung": 3}, "max_rung"),
                          ({"latency_slo_ms": 0.0}, "latency_slo_ms")):
            with pytest.raises(ValueError, match=match):
                p.serve.DegradeLadder(srv, mb, **kw)
        with pytest.raises(ValueError, match="plane"):
            srv.set_plane("fp4")
        # no bounded queue and no SLO: observe() is inert
        lad = p.serve.DegradeLadder(srv, mb, patience=1)
        mb.submit(np.array([1], np.int32), np.array([1.0], np.float32))
        assert lad.pressure() == 0.0 and lad.observe() == 0
