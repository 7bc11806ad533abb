"""The port's five examples (``examples/torch_*.py``) against the
reference's (``examples/*.py``), on the CPU.

Each example is loaded by path; module constants are set on the loaded
module, never on the file. The same inputs go through both packages:
quickstart's Pegasos and GADGET at reuters scale 0.05 for 300 iterations;
``gadget_with_faults`` for 40 iterations in the example's three networks
(against the reference example's own function); serve_batched's train,
export and serve at its own CCAT scale; gossip_vs_allreduce's ``run`` for
3 steps from the reference's initial parameters; train_100m's config
field for field and 2 steps of a 2-layer, 128-wide cut of it against the
reference's jitted step from the same state. Then quickstart as a script.
Tolerances: weights 1e-5, labels and accuracies equal, losses 1e-5
relative, AdamW parameters by ``test_torch_train``'s rule.
"""
import dataclasses
import importlib.util
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import serve as R_serve  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.core import svm_objective as R_obj  # noqa: E402
from repro.core.gadget import GadgetConfig as RGadgetConfig  # noqa: E402
from repro.core.gadget import gadget_train as r_gadget_train  # noqa: E402
from repro.core.pegasos import pegasos_train as r_pegasos_train  # noqa: E402
from repro.core.resilience import FaultySim as RFaultySim  # noqa: E402
from repro.data import svm_datasets as R_ds  # noqa: E402
from repro.data.tokens import Batcher as RBatcher  # noqa: E402
from repro.data.tokens import TokenStreamConfig as RTokenStreamConfig  # noqa: E402
from repro.launch import steps as ref_steps  # noqa: E402
from repro.models.transformer import Model as RefModel  # noqa: E402
from repro_torch.convert import (model_params_to_torch, train_state_to_reference,  # noqa: E402
                                 train_state_to_torch)
from repro_torch.data import svm_datasets as T_ds  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402

from test_torch_train import ADAMW_LR_SHARE, OUTLIER_SHARE, as_reference  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for the port's small CPU ops: a pool of a thread
    a core in every test worker spins against the other workers (5× slower
    under six workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def load(name: str):
    """``examples/<name>.py`` as a fresh module of its own."""
    spec = importlib.util.spec_from_file_location(f"example_{name}", REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ------------------------------------------------------------- quickstart


def _correct(accuracy, n: int) -> int:
    """The count of right labels behind an f32 accuracy (the two packages
    round the mean differently in its last bit)."""
    return round(float(accuracy) * n)


def test_quickstart_matches_reference():
    """Pegasos and GADGET of the quickstart at reuters scale 0.05, 300
    iterations: w and W at 1e-5, the accuracies equal."""
    port = load("torch_quickstart")
    ds_t = T_ds.make_dataset("reuters", scale=0.05, seed=0)
    ds_r = R_ds.make_dataset("reuters", scale=0.05, seed=0)
    np.testing.assert_array_equal(ds_t.X_train, ds_r.X_train)
    n = 300
    Xte_r, yte_r = jnp.asarray(ds_r.X_test), jnp.asarray(ds_r.y_test)
    Xte_t, yte_t = torch.from_numpy(ds_t.X_test), torch.from_numpy(ds_t.y_test)

    cen_r = r_pegasos_train(jnp.asarray(ds_r.X_train), jnp.asarray(ds_r.y_train), lam=ds_r.lam,
                            n_iters=n, batch_size=port.BATCH)
    cen_t = port.centralized(ds_t, n_iters=n, device="cpu")
    np.testing.assert_allclose(cen_t.w.numpy(), np.asarray(cen_r.w), rtol=0, atol=ATOL)
    n_te = len(ds_r.y_test)
    assert _correct(port.obj.accuracy(cen_t.w, Xte_t, yte_t), n_te) == _correct(
        R_obj.accuracy(cen_r.w, Xte_r, yte_r), n_te)

    Xp, yp, nc = R_ds.partition(ds_r.X_train, ds_r.y_train, m=port.N_NODES)
    res_r = r_gadget_train(jnp.asarray(Xp), jnp.asarray(yp), n_counts=nc,
                           cfg=RGadgetConfig(lam=ds_r.lam, batch_size=port.BATCH,
                                             gossip_rounds=4, topology="random", epsilon=1e-3,
                                             max_iters=n, check_every=300))
    res_t = port.gadget(ds_t, n_iters=n, device="cpu")
    assert res_t.iters == res_r.iters == n
    np.testing.assert_allclose(res_t.W.numpy(), np.asarray(res_r.W), rtol=0, atol=ATOL)
    assert _correct(port.obj.accuracy(res_t.w_consensus, Xte_t, yte_t), n_te) == _correct(
        R_obj.accuracy(res_r.w_consensus, Xte_r, yte_r), n_te)
    for i in range(port.N_NODES):
        assert _correct(port.obj.accuracy(res_t.W[i], Xte_t, yte_t), n_te) == _correct(
            R_obj.accuracy(res_r.W[i], Xte_r, yte_r), n_te)


def test_quickstart_script_runs_alone():
    """``python examples/torch_quickstart.py --device cpu`` at the example's
    own sizes: exit 0 and its accuracy lines printed."""
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"), "OMP_NUM_THREADS": "1"}
    p = subprocess.run([sys.executable, str(REPO / "examples" / "torch_quickstart.py"),
                        "--device", "cpu"], capture_output=True, text=True, timeout=300,
                       env=env, cwd=REPO)
    assert p.returncode == 0, p.stdout[-2000:] + p.stderr[-2000:]
    accs = {name: float(a) for name, a in
            re.findall(r"^(centralized Pegasos|GADGET \(10 nodes\)) +acc=([0-9.]+)", p.stdout,
                       re.M)}
    assert set(accs) == {"centralized Pegasos", "GADGET (10 nodes)"}, p.stdout
    assert all(0.6 <= a <= 1.0 for a in accs.values()), accs
    assert "iters=1500" in p.stdout and "per-node accuracies:" in p.stdout


# -------------------------------------------------- fault-tolerant gossip


FAULT_CASES = {"clean": dict(drop_prob=0.0, seed=1),
               "20% link drops": dict(drop_prob=0.2, drop="link", seed=1),
               "2 dead nodes": dict(dead_nodes=(2, 5), seed=1)}


@pytest.fixture(scope="module")
def usps_parts():
    ds = R_ds.make_dataset("usps", scale=0.4, seed=0)
    Xp, yp, _ = R_ds.partition(ds.X_train, ds.y_train, 10)
    return ds.lam, Xp, yp


@pytest.mark.parametrize("case", list(FAULT_CASES))
def test_fault_tolerant_gossip_matches_reference(usps_parts, case):
    """``gadget_with_faults`` for 40 iterations against the reference
    example's own function on the same network: W at 1e-5."""
    ref, port = load("fault_tolerant_gossip"), load("torch_fault_tolerant_gossip")
    lam, Xp, yp = usps_parts
    sims = dict(port.cases())
    assert sims[case].plan == tuple(RFaultySim(10, "random", **FAULT_CASES[case]).plan)
    W_r = ref.gadget_with_faults(jnp.asarray(Xp), jnp.asarray(yp), lam,
                                 RFaultySim(10, "random", **FAULT_CASES[case]), n_iters=40)
    W_t = port.gadget_with_faults(torch.from_numpy(Xp), torch.from_numpy(yp), lam, sims[case],
                                  n_iters=40)
    assert W_t.dtype == torch.float32 and W_t.device.type == "cpu"
    np.testing.assert_allclose(W_t.numpy(), np.asarray(W_r), rtol=0, atol=ATOL)


# ---------------------------------------------------------- serve_batched


def test_serve_batched_matches_reference(tmp_path):
    """serve_batched's path at its own CCAT scale: the trained W at 1e-5,
    the served labels equal and scores within 1e-5 of the reference's same
    path, int8 agreement >= 0.9, every query delivered, at most one shape a
    bucket."""
    port = load("torch_serve_batched")
    ds, Pe, res = port.train(device="cpu")
    out = port.export_and_serve(ds, Pe, res, str(tmp_path / "port"), device="cpu")

    ds_r = R_ds.make_dataset("ccat", scale=port.SCALE, seed=0, sparse=True)
    np.testing.assert_array_equal(ds_r.X_test.cols, ds.X_test.cols)
    Pe_r, yp_r, nc_r = R_ds.partition(ds_r.X_train, ds_r.y_train, port.N_NODES, seed=0)
    cfg = RGadgetConfig(lam=ds_r.lam, batch_size=4, gossip_rounds=4, max_iters=60,
                        check_every=30, epsilon=0.0)
    res_r = r_gadget_train(Pe_r, jnp.asarray(yp_r), cfg, n_counts=nc_r, snapshot_every=15)
    assert res.iters == res_r.iters == 60
    np.testing.assert_allclose(res.W.numpy(), np.asarray(res_r.W), rtol=0, atol=ATOL)
    snaps_t, snaps_r = port.serve.snapshots_from(res), R_serve.snapshots_from(res_r)
    assert [s.iteration for s in snaps_t] == [s.iteration for s in snaps_r] == [15, 30, 45, 60]

    root = str(tmp_path / "ref")
    R_serve.to_checkpoint(R_serve.latest(res_r), root + "/f32", lam=ds_r.lam)
    srv = R_serve.SvmServer.load(root + "/f32")
    assert [(b.rows, b.k, b.n_blocks_max) for b in out["buckets"]] == [
        (b.rows, b.k, b.n_blocks_max) for b in R_serve.calibrate_buckets(
            R_serve.bucket_ladder(ds_r.X_test.k_max, rows=8,
                                  min_k=max(8, ds_r.X_test.k_max // 4), d=ds_r.d),
            Pe_r.cols.reshape(-1, Pe_r.cols.shape[-1])[:2000],
            Pe_r.vals.reshape(-1, Pe_r.vals.shape[-1])[:2000], ds_r.d)]
    mb = R_serve.MicroBatcher(out["buckets"])
    want = {}
    for i, (cols, vals) in enumerate(out["queries"]):
        mb.submit(cols, vals)
        if mb.pending >= port.DRAIN_AT:
            want.update(mb.drain(srv.scorer_for()))
    want.update(mb.drain(srv.scorer_for()))
    assert sorted(out["results"]) == sorted(want) and len(want) == port.N_QUERIES
    got_s = np.array([float(out["results"][r][0]) for r in sorted(want)])
    want_s = np.array([float(want[r][0]) for r in sorted(want)])
    np.testing.assert_allclose(got_s, want_s, rtol=0, atol=ATOL)
    np.testing.assert_array_equal([out["results"][r][1] for r in sorted(want)],
                                  [want[r][1] for r in sorted(want)])
    Xq = ds_r.X_test.take_rows(np.arange(32)).to_dense()
    s_r, l_r = srv.score(Xq)
    np.testing.assert_allclose(out["dense_scores"], s_r, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(out["labels_f32"], l_r)
    assert out["agree"] >= 0.9
    assert out["batcher"]["requests"] == port.N_QUERIES
    assert out["server"]["distinct_shapes"] <= len(out["buckets"])


# ----------------------------------------------------- gossip_vs_allreduce


@pytest.fixture(scope="module")
def gossip_pair():
    """Both modules' ``run`` at 3 steps in the three modes, the port from
    the reference's initial parameters."""
    ref, port = load("gossip_vs_allreduce"), load("torch_gossip_vs_allreduce")
    ref.STEPS = port.STEPS = 3
    cfg = ref_config("llama3-8b").reduced(n_layers=2, d_model=128)
    params = model_params_to_torch(cfg, jax.tree.map(np.asarray, RefModel(cfg).init(
        jax.random.PRNGKey(0))), "cpu")
    out = {}
    for mode, rounds in (("allreduce", 1), ("gossip", 1), ("gossip", 2)):
        out[mode, rounds] = (ref.run(mode, rounds),
                             port.run(mode, rounds, params=params, device="cpu"))
    return out


@pytest.mark.parametrize("mode,rounds", [("allreduce", 1), ("gossip", 1), ("gossip", 2)])
def test_gossip_vs_allreduce_matches_reference(gossip_pair, mode, rounds):
    """Losses within 1e-5 relative (AdamW steps three times from the same
    parameters), the replicas' disagreement within 1e-4."""
    (l_r, spread_r), (l_t, spread_t) = gossip_pair[mode, rounds]
    assert len(l_t) == len(l_r) == 3
    for a, b in zip(l_r, l_t, strict=True):
        assert abs(a - b) <= ATOL * max(1.0, abs(a)), (l_r, l_t)
    assert abs(spread_t - spread_r) <= 1e-4, (spread_r, spread_t)
    if mode == "gossip":
        assert spread_t > 0.0


# --------------------------------------------------------------- train_100m


def test_train_100m_config_matches_reference():
    port, ref = load("torch_train_100m"), load("train_100m")
    want = dataclasses.asdict(ref.build_100m())
    got = dataclasses.asdict(port.build_100m())
    assert got == want
    assert (got["n_layers"], got["d_model"], got["d_ff"], got["n_heads"], got["n_kv_heads"],
            got["head_dim"], got["vocab_size"]) == (8, 512, 2048, 8, 4, 64, 32000)


@pytest.mark.parametrize("consensus", ["allreduce", "gossip"])
def test_train_100m_steps_match_reference(consensus):
    """Two steps of a 2-layer, 128-wide cut of the 100M config through the
    example's ``train`` (AdamW, remat, G = 2 under gossip) against the
    reference's jitted step from the same state on the same batches."""
    port, ref = load("torch_train_100m"), load("train_100m")
    steps_, batch, seq = 2, 4, 32
    cfg = port.build_100m().reduced(n_layers=2, d_model=128)
    rcfg = ref.build_100m().reduced(n_layers=2, d_model=128)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg)
    tcfg = port.trainer_config(steps_, consensus, 2)
    model = Model(cfg, device="cpu")
    state0 = port.init_state(model, tcfg)
    rstate = as_reference(train_state_to_reference(cfg, tcfg, state0))
    state, losses = port.train(model, tcfg, state0, steps=steps_, batch=batch, seq=seq)

    rstep = jax.jit(ref_steps.make_train_step(RefModel(rcfg), ref_steps.TrainerConfig(
        **dataclasses.asdict(tcfg))))
    batcher = RBatcher(RTokenStreamConfig(cfg.vocab_size, seq, batch, seed=0))
    ref_losses = []
    for s in range(steps_):
        b = {k: jnp.asarray(v) for k, v in batcher.global_batch(s).items()}
        if consensus == "gossip":
            b = {k: v.reshape(2, batch // 2, seq) for k, v in b.items()}
        rstate, m = rstep(rstate, b)
        ref_losses.append(float(m["loss"]))
    for a, b in zip(ref_losses, losses, strict=True):
        assert abs(a - b) <= ATOL * max(1.0, abs(a)), (ref_losses, losses)
    want = train_state_to_torch(cfg, tcfg, jax.tree.map(np.asarray, rstate), device="cpu")
    assert int(state["step"]) == int(want["step"]) == steps_
    for w_tree, g_tree in ((want["opt"].mu, state["opt"].mu), (want["opt"].nu, state["opt"].nu)):
        for k in w_tree:
            np.testing.assert_allclose(g_tree[k].numpy(), w_tree[k].numpy(), rtol=0,
                                       atol=ATOL, err_msg=k)
    total = outliers = 0
    for k, w in want["params"].items():
        diff = (state["params"][k] - w).abs()
        assert float(diff.max()) <= max(ATOL, ADAMW_LR_SHARE * tcfg.lr), k
        total += diff.numel()
        outliers += int((diff > ATOL).sum())
    assert outliers <= OUTLIER_SHARE * total, (outliers, total)
