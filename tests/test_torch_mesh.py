"""The port's mesh paths on 4 gloo ranks against the reference's 4-device
``shard_map``, on the CPU.

One reference subprocess (4 forced host devices) and one port subprocess (4
ranks spawned over a ``file://`` rendezvous, gloo) run the same numpy data
and write an ``.npz`` each, under their own time limits. Compared at 1e-5:
the dense mesh step (plain, and the port's kernel path), the sparse mesh
step (prefetch) against the dense one, the four fault checks (an inert plan
bit-identical to no plan, a dead rank frozen at zero, message drops, an
out-of-range dead id raising at build), ``push_sum_mesh`` on a 1-D and a
2-D mesh, ``gossip_mix``, ``allreduce_grads`` and ``make_mesh_scorer``.
Then one-process checks: a world size that does not match the axis sizes
raises, and ``gossip_mix_stacked`` (bf16 payloads too) matches the
reference's.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import consensus as R_cons  # noqa: E402
from repro_torch.core import consensus as T_cons  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
ATOL = 1e-5
TIMEOUT_S = 300

# the data both scripts run on, made with numpy from fixed seeds
DATA = r"""
import numpy as np
M, N_I, D, STEPS = 4, 16, 24, 6
rng = np.random.default_rng(0)
w_true = rng.normal(size=D)
X = rng.normal(size=(M, N_I, D)).astype(np.float32)
y = np.sign(X @ w_true).astype(np.float32)
DS, KS, SPARSE_STEPS = 300, 6, 3
srng = np.random.default_rng(1)
s_cols = np.sort(np.stack([np.stack([srng.choice(DS, KS, replace=False) for _ in range(N_I)])
                           for _ in range(M)]), axis=-1).astype(np.int32)
s_vals = srng.normal(size=(M, N_I, KS)).astype(np.float32)
s_vals[:, ::5, -2:] = 0.0   # pad entries
s_cols[:, ::5, -2:] = 0
s_dense = np.zeros((M, N_I, DS), np.float32)
for i in range(M):
    for r in range(N_I):
        for c, v in zip(s_cols[i, r], s_vals[i, r]):
            s_dense[i, r, c] += v
s_y = np.sign(s_dense @ srng.normal(size=DS)).astype(np.float32)
s_y[s_y == 0] = 1.0
V = rng.normal(size=(M, 5)).astype(np.float32)
P = {"a": rng.normal(size=(M, 3, 2)).astype(np.float32), "b": rng.normal(size=(M, 7)).astype(np.float32)}
G_ = rng.normal(size=(M, 9)).astype(np.float32)
W_SCORE = rng.normal(size=(3, D)).astype(np.float32)
X_SCORE = rng.normal(size=(16, D)).astype(np.float32)
LAM, BATCH, ROUNDS, GOSSIP_STEP = 1e-2, 2, 2, 3
SUB_MESH_AXES = {"ar_data": ("data",), "ar_model": ("model",), "ar_both": ("data", "model")}
"""

REF_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as PS
from jax.experimental.shard_map import shard_map
from repro.core.consensus import allreduce_grads, gossip_mix
from repro.core.faults import FaultPlan
from repro.core.gadget import GadgetConfig, make_gadget_mesh_step
from repro.core.push_sum import push_sum_mesh
from repro.serve import make_mesh_scorer
from repro.sparse.formats import minibatch_block_bound
""" + DATA + r"""
out = {}
mesh = Mesh(np.array(jax.devices()), ("nodes",))
mesh2 = Mesh(np.array(jax.devices()).reshape(2, 2), ("pod", "data"))
cfg = GadgetConfig(lam=LAM, batch_size=BATCH, gossip_rounds=ROUNDS, use_kernels=False)

def train(step, Xs, ys, steps):
    sparse = isinstance(Xs, tuple)
    def per_node(w, a, b, yl, keys, t):
        X_local = (a[0], b[0]) if sparse else a[0]
        return step(w[0], X_local, yl[0], t, keys[0])[None]
    specs = (PS("nodes"),) * 5 + (PS(),)
    run = jax.jit(shard_map(per_node, mesh=mesh, in_specs=specs, out_specs=PS("nodes"),
                            check_rep=False))
    a, b = (Xs if sparse else (Xs, Xs))
    W = jnp.zeros((M, DS if sparse else Xs.shape[-1]), jnp.float32)
    for t in range(1, steps + 1):
        keys = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(0), t), M)
        W = run(W, jnp.asarray(a), jnp.asarray(b), jnp.asarray(ys), keys, jnp.int32(t))
    return np.asarray(W)

out["W_clean"] = train(make_gadget_mesh_step(cfg, {"nodes": M}), X, y, STEPS)
out["W_inert"] = train(make_gadget_mesh_step(
    cfg._replace(faults=FaultPlan(drop_prob=0.0, seed=7)), {"nodes": M}), X, y, STEPS)
out["W_dead"] = train(make_gadget_mesh_step(
    cfg._replace(faults=FaultPlan(dead_nodes=(2,), seed=7)), {"nodes": M}), X, y, STEPS)
out["W_drop"] = train(make_gadget_mesh_step(
    cfg._replace(faults=FaultPlan(drop_prob=0.5, drop="message", seed=7)), {"nodes": M}),
    X, y, STEPS)
out["W_link"] = train(make_gadget_mesh_step(
    cfg._replace(faults=FaultPlan(drop_prob=0.5, drop="link", dead_nodes=(1,), seed=3)),
    {"nodes": M}), X, y, STEPS)
try:
    make_gadget_mesh_step(cfg._replace(faults=FaultPlan(dead_nodes=(4,))), {"nodes": M})
    out["out_of_range_raised"] = np.array(False)
except ValueError:
    out["out_of_range_raised"] = np.array(True)

bound = minibatch_block_bound(s_cols.reshape(M, -1, KS), s_vals, BATCH, d=DS)
step_s = make_gadget_mesh_step(cfg._replace(use_kernels=True, sparse_schedule="prefetch"),
                               {"nodes": M}, sparse_block_bound=bound)
out["W_sparse"] = train(step_s, (s_cols, s_vals), s_y, SPARSE_STEPS)
out["W_sparse_dense"] = train(make_gadget_mesh_step(cfg, {"nodes": M}), s_dense, s_y,
                              SPARSE_STEPS)

def sharded(fn, m=mesh, spec=PS("nodes")):
    return jax.jit(shard_map(fn, mesh=m, in_specs=spec, out_specs=spec, check_rep=False))

for name, kw in (("ps_one", dict(n_rounds=1, t0=1)), ("ps_full", dict()),
                 ("ps_raw", dict(n_rounds=1, normalize=False))):
    out[name] = np.asarray(sharded(lambda v: push_sum_mesh(
        v[0], axis_sizes={"nodes": M}, **kw)[None])(jnp.asarray(V)))
spec2 = PS(("pod", "data"))
for name, n_rounds in (("ps2_one", 1), ("ps2_full", None), ("ps2_three", 3)):
    out[name] = np.asarray(sharded(lambda v: push_sum_mesh(
        v[0], axis_sizes={"pod": 2, "data": 2}, n_rounds=n_rounds, t0=1)[None],
        m=mesh2, spec=spec2)(jnp.asarray(V)))
mixed = sharded(lambda p: jax.tree.map(lambda x: x[None], gossip_mix(
    jax.tree.map(lambda x: x[0], p), jnp.int32(GOSSIP_STEP), axis_sizes={"nodes": M},
    rounds=1)))({k: jnp.asarray(v) for k, v in P.items()})
out["gm_a"], out["gm_b"] = np.asarray(mixed["a"]), np.asarray(mixed["b"])
out["ar"] = np.asarray(sharded(lambda g: allreduce_grads(g[0], ("nodes",))[None])(
    jnp.asarray(G_)))
mesh_dm = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
for name, axes in SUB_MESH_AXES.items():
    out[name] = np.asarray(sharded(lambda g: allreduce_grads(g[0], axes)[None], m=mesh_dm,
                                   spec=PS(("data", "model")))(jnp.asarray(G_)))
for name, W in (("sc_multi", W_SCORE), ("sc_binary", W_SCORE[0])):
    s, l = make_mesh_scorer(W, use_kernels=True)(jnp.asarray(X_SCORE))
    out[name + "_scores"], out[name + "_labels"] = np.asarray(s), np.asarray(l)
np.savez(sys.argv[1], **out)
print("REF_MESH_OK")
"""

PORT_SCRIPT = r"""
import os, sys, tempfile
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
""" + DATA + r"""

def rank_main(rank, rdv, path):
    torch.set_num_threads(1)
    from repro_torch.core import counter_rng as crng
    from repro_torch.core.consensus import allreduce_grads, gossip_mix
    from repro_torch.core.faults import FaultPlan
    from repro_torch.core.gadget import GadgetConfig, make_gadget_mesh_step
    from repro_torch.core.mesh import Mesh
    from repro_torch.core.push_sum import push_sum_mesh
    from repro_torch.serve import make_mesh_scorer
    from repro_torch.sparse.formats import minibatch_block_bound
    dist.init_process_group("gloo", init_method=f"file://{rdv}", rank=rank, world_size=M)
    mesh = Mesh({"nodes": M})
    mesh2 = Mesh({"pod": 2, "data": 2})
    cfg = GadgetConfig(lam=LAM, batch_size=BATCH, gossip_rounds=ROUNDS)
    out = {}

    def train(step, Xs, ys, steps):
        X_local = ((torch.from_numpy(Xs[0][rank]), torch.from_numpy(Xs[1][rank]))
                   if isinstance(Xs, tuple) else torch.from_numpy(Xs[rank]))
        y_local = torch.from_numpy(ys[rank])
        w = torch.zeros((DS if isinstance(Xs, tuple) else Xs.shape[-1],), dtype=torch.float32)
        for t in range(1, steps + 1):
            key = crng.fold_in(crng.fold_in(crng.prng_key(0), t), rank)
            w = step(w, X_local, y_local, t, key)
        return w.numpy()

    def plan(**kw):
        return cfg._replace(faults=FaultPlan(**kw))

    out["W_clean"] = train(make_gadget_mesh_step(cfg, {"nodes": M}, mesh=mesh,
                                                 use_kernels=False), X, y, STEPS)
    out["W_clean_kernels"] = train(make_gadget_mesh_step(cfg, {"nodes": M}, mesh=mesh),
                                   X, y, STEPS)
    out["W_inert"] = train(make_gadget_mesh_step(plan(drop_prob=0.0, seed=7), {"nodes": M},
                                                 mesh=mesh, use_kernels=False), X, y, STEPS)
    out["W_dead"] = train(make_gadget_mesh_step(plan(dead_nodes=(2,), seed=7), {"nodes": M},
                                                mesh=mesh, use_kernels=False), X, y, STEPS)
    out["W_drop"] = train(make_gadget_mesh_step(plan(drop_prob=0.5, drop="message", seed=7),
                                                {"nodes": M}, mesh=mesh, use_kernels=False),
                          X, y, STEPS)
    out["W_link"] = train(make_gadget_mesh_step(
        plan(drop_prob=0.5, drop="link", dead_nodes=(1,), seed=3), {"nodes": M}, mesh=mesh,
        use_kernels=False), X, y, STEPS)
    try:
        make_gadget_mesh_step(plan(dead_nodes=(4,)), {"nodes": M}, mesh=mesh)
        out["out_of_range_raised"] = np.array(False)
    except ValueError:
        out["out_of_range_raised"] = np.array(True)

    bound = minibatch_block_bound(s_cols.reshape(M, -1, KS), s_vals, BATCH, d=DS)
    step_s = make_gadget_mesh_step(cfg._replace(sparse_schedule="prefetch"), {"nodes": M},
                                   bound, mesh=mesh)
    out["W_sparse"] = train(step_s, (s_cols, s_vals), s_y, SPARSE_STEPS)
    out["W_sparse_dense"] = train(make_gadget_mesh_step(cfg, {"nodes": M}, mesh=mesh,
                                                        use_kernels=False),
                                  s_dense, s_y, SPARSE_STEPS)

    v = torch.from_numpy(V[rank])
    out["ps_one"] = push_sum_mesh(v, axis_sizes={"nodes": M}, n_rounds=1, t0=1,
                                  mesh=mesh).numpy()
    out["ps_full"] = push_sum_mesh(v, axis_sizes={"nodes": M}, mesh=mesh).numpy()
    out["ps_raw"] = push_sum_mesh(v, axis_sizes={"nodes": M}, n_rounds=1, normalize=False,
                                  mesh=mesh).numpy()
    for name, n_rounds in (("ps2_one", 1), ("ps2_full", None), ("ps2_three", 3)):
        out[name] = push_sum_mesh(v, axis_sizes={"pod": 2, "data": 2}, n_rounds=n_rounds,
                                  t0=1, mesh=mesh2).numpy()
    mixed = gossip_mix({k: torch.from_numpy(a[rank]) for k, a in P.items()}, GOSSIP_STEP,
                       axis_sizes={"nodes": M}, rounds=1, mesh=mesh)
    out["gm_a"], out["gm_b"] = mixed["a"].numpy(), mixed["b"].numpy()
    out["ar"] = allreduce_grads(torch.from_numpy(G_[rank]), ("nodes",), mesh=mesh).numpy()
    mesh_dm = Mesh({"data": 2, "model": 2})
    for name, axes in SUB_MESH_AXES.items():
        out[name] = allreduce_grads(torch.from_numpy(G_[rank]), axes, mesh=mesh_dm).numpy()
    for name, W in (("sc_multi", W_SCORE), ("sc_binary", W_SCORE[0])):
        s, l = make_mesh_scorer(W, mesh=mesh, device="cpu")(X_SCORE)
        out[name + "_scores"], out[name + "_labels"] = s.numpy(), l.numpy()
    out["staged"] = np.array(mesh.stats()["host_staged_bytes"])
    np.savez(f"{path}.rank{rank}.npz", **out)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    path = sys.argv[1]
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=rank_main, args=(r, os.path.join(tmp, "rdv"), path))
                 for r in range(M)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(240)
        for p in procs:
            if p.is_alive():
                p.kill()
        codes = [p.exitcode for p in procs]
    if codes != [0] * M:
        raise SystemExit(f"ranks exited {codes}")
    ranks = [dict(np.load(f"{path}.rank{r}.npz")) for r in range(M)]
    merged = {}
    for k in ranks[0]:
        if k.startswith(("sc_", "out_of_range", "staged")):
            merged[k] = ranks[0][k]  # every rank holds the whole result
        else:
            merged[k] = np.stack([rk[k] for rk in ranks])
    merged["sc_all_ranks_equal"] = np.array(all(
        np.array_equal(rk[k], ranks[0][k]) for rk in ranks for k in rk if k.startswith("sc_")))
    np.savez(path, **merged)
    print("PORT_MESH_OK")
"""


def _run(script: str, name: str, tmp_path_factory) -> dict:
    d = tmp_path_factory.mktemp(name)
    path, out = d / f"{name}.py", d / f"{name}.npz"
    path.write_text(script)
    env = {**os.environ, "PYTHONPATH": f"{REPO / 'src'}", "JAX_PLATFORMS": "cpu"}
    p = subprocess.run([sys.executable, str(path), str(out)], capture_output=True, text=True,
                       timeout=TIMEOUT_S, env=env, cwd=d)
    assert p.returncode == 0, p.stdout[-3000:] + p.stderr[-3000:]
    return dict(np.load(out))


@pytest.fixture(scope="module")
def ref_out(tmp_path_factory):
    return _run(REF_SCRIPT, "ref_mesh", tmp_path_factory)


@pytest.fixture(scope="module")
def port_out(tmp_path_factory):
    return _run(PORT_SCRIPT, "port_mesh", tmp_path_factory)


@pytest.mark.parametrize("key", ["W_clean", "W_inert", "W_dead", "W_drop", "W_link",
                                 "W_sparse", "W_sparse_dense", "ps_one", "ps_full", "ps_raw",
                                 "ps2_one", "ps2_full", "ps2_three", "gm_a", "gm_b", "ar",
                                 "sc_multi_scores", "sc_binary_scores"])
def test_mesh_output_matches_reference(ref_out, port_out, key):
    np.testing.assert_allclose(port_out[key], ref_out[key], atol=ATOL)


@pytest.mark.parametrize("key", ["ar_data", "ar_model", "ar_both"])
def test_allreduce_over_sub_mesh_matches_reference_pmean(ref_out, port_out, key):
    """``allreduce_grads`` over ("data",), ("model",) and both axes of a
    (data 2, model 2) mesh: the reference's ``pmean`` over the same axes at
    1e-6, and each rank's mean over exactly its slice."""
    np.testing.assert_allclose(port_out[key], ref_out[key], rtol=0, atol=1e-6)
    data = {}
    exec(DATA, data)  # noqa: S102 — the scripts' own data block
    g = data["G_"].reshape(2, 2, -1)  # rank = 2 · data + model
    axes = tuple(i for i, a in enumerate(("data", "model")) if a in data["SUB_MESH_AXES"][key])
    want = np.broadcast_to(g.mean(axis=axes, keepdims=True), g.shape).reshape(4, -1)
    np.testing.assert_allclose(port_out[key], want, rtol=0, atol=1e-6)


def test_mesh_kernel_step_matches_plain_reference(ref_out, port_out):
    np.testing.assert_allclose(port_out["W_clean_kernels"], ref_out["W_clean"], atol=ATOL)


def test_mesh_fault_checks(ref_out, port_out):
    for out in (ref_out, port_out):
        assert np.array_equal(out["W_inert"], out["W_clean"]), "inert plan perturbed the step"
        assert np.array_equal(out["W_dead"][2], np.zeros_like(out["W_dead"][2]))
        assert all(np.abs(out["W_dead"][i]).max() > 0 for i in (0, 1, 3))
        assert np.all(np.isfinite(out["W_drop"])) and np.abs(out["W_drop"]).max() > 0
        assert not np.array_equal(out["W_drop"], out["W_clean"])
        assert bool(out["out_of_range_raised"])


def test_mesh_sparse_step_matches_dense(port_out):
    np.testing.assert_allclose(port_out["W_sparse"], port_out["W_sparse_dense"], atol=ATOL)
    assert np.abs(port_out["W_sparse"]).max() > 0


def test_mesh_push_sum_and_scorer_semantics(ref_out, port_out):
    for key in ("ps_full", "ps2_full"):
        np.testing.assert_allclose(port_out[key], np.broadcast_to(
            port_out[key].mean(axis=0), port_out[key].shape), atol=1e-6)
    np.testing.assert_allclose(port_out["ps_raw"].sum(axis=0), ref_out["ps_raw"].sum(axis=0),
                               atol=ATOL)
    for name in ("sc_multi", "sc_binary"):
        np.testing.assert_array_equal(port_out[name + "_labels"], ref_out[name + "_labels"])
    assert bool(port_out["sc_all_ranks_equal"])
    assert int(port_out["staged"]) == 0  # CPU tensors go to gloo as they are


def _one_rank_group(tmp_path):
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rdv'}", rank=0,
                            world_size=1)
    return dist


def test_mesh_world_size_must_match_axis_sizes(tmp_path):
    from repro_torch.core.mesh import Mesh
    dist = _one_rank_group(tmp_path)
    try:
        with pytest.raises(ValueError):
            Mesh({"nodes": 4})
        with pytest.raises(ValueError):
            Mesh({"pod": 2, "data": 1})
        mesh = Mesh({"pod": 1, "data": 1})
        assert (mesh.rank, mesh.axis_index("data"), mesh.backend) == (0, 0, "gloo")
        x = torch.arange(4.0)
        assert torch.equal(mesh.ppermute(x, "data", 1), x)
        assert torch.equal(mesh.all_reduce_sum(x), x)
    finally:
        dist.destroy_process_group()


def test_mesh_needs_a_process_group():
    import torch.distributed as dist
    from repro_torch.core.mesh import Mesh
    if dist.is_initialized():
        pytest.skip("a process group is live in this process")
    with pytest.raises(RuntimeError):
        Mesh({"nodes": 1})


@pytest.mark.parametrize("n_nodes,rounds,step,payload", [
    (4, 1, 0, None), (8, 2, 3, None), (8, 3, 1, "bfloat16"), (4, 2, 5, "bfloat16"),
    (1, 1, 0, None)])
def test_gossip_mix_stacked_matches_reference(n_nodes, rounds, step, payload):
    rng = np.random.default_rng(n_nodes + rounds)
    params = {"w": rng.normal(size=(n_nodes, 6)).astype(np.float32),
              "b": rng.normal(size=(n_nodes, 2, 3)).astype(np.float32)}
    ref = R_cons.gossip_mix_stacked({k: jnp.asarray(v) for k, v in params.items()},
                                    jnp.int32(step), n_nodes=n_nodes, rounds=rounds,
                                    payload_dtype=None if payload is None else jnp.bfloat16)
    port = T_cons.gossip_mix_stacked({k: torch.from_numpy(v) for k, v in params.items()}, step,
                                     n_nodes=n_nodes, rounds=rounds,
                                     payload_dtype=None if payload is None else torch.bfloat16)
    for k in params:
        np.testing.assert_allclose(port[k].numpy(), np.asarray(ref[k]), atol=ATOL)


def test_gossip_mix_stacked_rejects_non_power_of_two():
    with pytest.raises(ValueError):
        T_cons.gossip_mix_stacked(torch.zeros(6, 2), 0, n_nodes=6)


@pytest.mark.parametrize("cfg,ok", [(dict(), True), (dict(kind="gossip"), True),
                                    (dict(kind="ring"), False), (dict(gossip_rounds=0), False),
                                    (dict(mix_every=0), False)])
def test_consensus_config_validate(cfg, ok):
    for mod in (R_cons, T_cons):
        c = mod.ConsensusConfig(**cfg)
        if ok:
            assert c.validate() == c
        else:
            with pytest.raises(ValueError):
                c.validate()


@pytest.mark.parametrize("n", [1, 7, 1943, 2**31 - 1])
def test_host_randint_equals_tensor_randint(n):
    """The mesh step draws its few ids in Python ints on the host; they are
    the tensor path's (and so the reference's) bit for bit."""
    from repro_torch.core import counter_rng as crng
    key = crng.fold_in(crng.fold_in(crng.prng_key(0), 11), 2)
    host = [crng.randint(key, i, n) for i in range(9)]
    assert host == crng.randint(key, torch.arange(9), n).tolist()
