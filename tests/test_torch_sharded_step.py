"""The port's train step on DTensor state, on 4 gloo ranks as a
(data 2, model 2) mesh, against the reference's single-device jitted step:
two SGD steps of reduced llama3-8b, qwen2-moe-a2.7b, recurrentgemma-9b and
rwkv6-3b with the parameters placed by ``launch.shardings.param_specs`` in
zero1 and in fsdp (moments fsdp, as the dry-run places them), gossip with
``data`` as the replica axis (G = 2: each rank steps its replica on the
``model`` sub-mesh and mixes with its partner point to point), and prefill
logits, and decode steps of llama3-8b (full attention) and
recurrentgemma-9b (its sliding-window ring) from a cache sharded on its
sequence. Fixed step counts (no stop rule). One subprocess spawns the 4 ranks
once for every case; the reference runs here on the same initial states and
batches."""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as ref_config  # noqa: E402
from repro.launch import steps as ref_steps  # noqa: E402
from repro.models.transformer import Model as RefModel  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import (model_params_to_reference, train_state_to_reference,  # noqa: E402
                                 train_state_to_torch)
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.input_specs import make_host_batch  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402

from test_torch_train import as_reference  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
ATOL = 1e-5
TIMEOUT_S = 300
STEPS, BATCH, SEQ, D_MODEL = 2, 8, 16, 64
ARCHS = {"llama3-8b": 2, "qwen2-moe-a2.7b": 2, "recurrentgemma-9b": 3, "rwkv6-3b": 2}
CASES = ([(arch, mode) for arch in ARCHS for mode in ("zero1", "fsdp")]
         + [("llama3-8b", "gossip"), ("rwkv6-3b", "gossip")])
# decode from a sharded cache: llama3-8b's full attention (an absolute slot a
# token) and recurrentgemma-9b's cycle, whose SWA ring (window 4) wraps twice
DECODE_CASES = [("llama3-8b", 2, 0), ("recurrentgemma-9b", 3, 4)]
DECODE_BATCH, DECODE_LEN = 4, 12

RANK_SCRIPT = r"""
import dataclasses
import sys
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.configs import get_config
from repro_torch.configs.shapes import SHAPES
from repro_torch.launch import shardings as shard, steps
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.transformer import Model
from repro_torch.sharding.api import AxisRules, PartitionSpec as P, activate


def rules(mesh, gossip):
    return AxisRules(mesh, {"batch": None if gossip else "data", "seq": None, "embed": None,
                            "vocab": "model", "mlp": "model", "expert": None,
                            "capacity": None, "heads_dec": None, "cache_seq": "model"})


def full(x):
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def decode(mesh, cfg, c):
    # token-by-token decode through the serve step with the weights and the
    # caches as DTensors (the cache sharded on `model` along its sequence by
    # cache_spec_tree): every step's logits, whole
    model = Model(cfg, device="cpu")
    params = c["params"]
    dparams = shard.distribute(mesh, params, shard.param_specs(mesh, params, mode="zero1"))
    tokens = c["tokens"]
    caches = model.init_cache(tokens.shape[0], tokens.shape[1], torch.float32)
    dcaches = shard.distribute(mesh, caches, shard.cache_spec_tree(mesh, caches))
    serve = steps.make_serve_step(model)
    logits = []
    with activate(rules(mesh, False)), steps.swapped_params(model, dparams):
        for t in range(tokens.shape[1]):
            tok = shard.distribute(mesh, tokens[:, t:t + 1], P("data", None))
            out, dcaches = serve(tok, dcaches, t)
            logits.append(full(out))
    return {"logits": torch.cat(logits, dim=1),
            "cache_sharded": [any(type(p).__name__ == "Shard" for p in v.placements)
                              for c_ in dcaches for v in c_]}


def rank(r, world, rdv, work):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=rdv, rank=r, world_size=world)
    try:
        mesh = make_host_mesh(2, 2, device_type="cpu")
        cases = torch.load(f"{work}/cases.pt", weights_only=False)
        out = {}
        for name, c in cases.items():
            cfg = get_config(c["arch"]).reduced(n_layers=c["layers"], d_model=c["d_model"])
            if "decode" in c:
                out[name] = decode(mesh, dataclasses.replace(cfg, window=c["decode"]["window"]),
                                   c["decode"])
                continue
            model = Model(cfg, device="cpu")
            gossip = c["mode"] == "gossip"
            tcfg = steps.TrainerConfig(**c["trainer"])
            params = c["state"]["params"]
            mode = "zero1" if gossip else c["mode"]
            pspecs = shard.param_specs(mesh, params, gossip=gossip, replica_axis="data", mode=mode)
            mspecs = shard.param_specs(mesh, params, gossip=gossip, replica_axis="data", mode="fsdp")
            sspecs = steps.train_state_specs(pspecs, tcfg, moment_specs=mspecs)
            bspecs = shard.batch_specs(mesh, cfg, SHAPES["train_4k"], gossip_stacked=gossip,
                                       replica_axis="data")
            with activate(rules(mesh, gossip)):
                state = shard.distribute(mesh, c["state"], sspecs)
                step = steps.make_train_step(model, tcfg)
                losses = []
                for b in c["batches"]:
                    state, m = step(state, shard.distribute(mesh, b, bspecs))
                    losses.append(float(full(m["loss"])))
                got = {"params": {k: full(v) for k, v in state["params"].items()},
                       "losses": losses}
                if "prefill" in c:
                    dparams = shard.distribute(mesh, c["prefill"]["params"],
                                               shard.param_specs(mesh, c["prefill"]["params"], mode=mode))
                    pb = c["prefill"]["batch"]
                    with steps.swapped_params(model, dparams):
                        logits = steps.make_prefill_step(model)(
                            shard.distribute(mesh, pb, shard.batch_specs(mesh, cfg, SHAPES["train_4k"])))
                    got["logits"] = full(logits)
            out[name] = got
        if r == 0:
            torch.save(out, f"{work}/out.pt")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    work = sys.argv[1]
    mp.start_processes(rank, args=(4, f"file://{work}/rdv", work), nprocs=4, start_method="spawn")
"""


def _trainer(mode):
    kw = dict(optimizer="sgd", lr=3e-2, warmup_steps=1, total_steps=10)
    if mode == "gossip":
        kw.update(consensus="gossip", n_replicas=2, replica_axis="data")
    return kw


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case's initial state, batches and reference result, and the
    port's results from one 4-rank run."""
    work = tmp_path_factory.mktemp("sharded")
    cases, want, jitted = {}, {}, {}
    for arch, mode in CASES:
        layers = ARCHS[arch]
        pcfg = get_config(arch).reduced(n_layers=layers, d_model=D_MODEL)
        rcfg = ref_config(arch).reduced(n_layers=layers, d_model=D_MODEL)
        tkw = _trainer(mode)
        pt = steps.TrainerConfig(**{k: v for k, v in tkw.items() if k != "replica_axis"},
                                 replica_axis="data")
        rt = ref_steps.TrainerConfig(**tkw)
        model = Model(pcfg, device="cpu")
        pstate = steps.make_train_state(model, pt, torch.Generator().manual_seed(0))
        G = 2 if mode == "gossip" else 0
        batches = [make_host_batch(pcfg, BATCH, SEQ, seed=200 + s, n_replicas=G, device="cpu")
                   for s in range(STEPS)]
        state = as_reference(train_state_to_reference(pcfg, pt, pstate))
        if (arch, mode == "gossip") not in jitted:  # zero1 and fsdp share the reference's step
            jitted[arch, mode == "gossip"] = jax.jit(ref_steps.make_train_step(RefModel(rcfg), rt))
        rstep = jitted[arch, mode == "gossip"]
        losses = []
        for b in batches:
            state, m = rstep(state, {k: jnp.asarray(v.numpy()) for k, v in b.items()})
            losses.append(float(m["loss"]))
        name = f"{arch}-{mode}"
        cases[name] = {"arch": arch, "layers": layers, "d_model": D_MODEL, "mode": mode,
                       "trainer": dict(tkw, replica_axis="data"), "state": pstate,
                       "batches": batches}
        want[name] = {"params": train_state_to_torch(pcfg, pt, jax.tree.map(np.asarray, state),
                                                     device="cpu")["params"],
                      "losses": losses}
        if arch == "llama3-8b" and mode == "zero1":
            pb = make_host_batch(pcfg, BATCH, SEQ, seed=300, device="cpu")
            rparams = model_params_to_reference(pcfg, pstate["params"])
            logits, _ = RefModel(rcfg).forward(jax.tree.map(jnp.asarray, rparams),
                                               {k: jnp.asarray(v.numpy()) for k, v in pb.items()})
            cases[name]["prefill"] = {"params": pstate["params"], "batch": pb}
            want[name]["logits"] = np.asarray(logits)
    for arch, layers, window in DECODE_CASES:
        pcfg = get_config(arch).reduced(n_layers=layers, d_model=D_MODEL)
        pcfg = dataclasses.replace(pcfg, window=window)
        rcfg = dataclasses.replace(ref_config(arch).reduced(n_layers=layers, d_model=D_MODEL),
                                   window=window)
        params = Model(pcfg, device="cpu").init(torch.Generator().manual_seed(7)).state_dict()
        params = {k: v.detach() for k, v in params.items()}
        toks = torch.from_numpy(np.random.default_rng(8).integers(
            0, pcfg.vocab_size, (DECODE_BATCH, DECODE_LEN)))
        ref = RefModel(rcfg)
        rparams = jax.tree.map(jnp.asarray, model_params_to_reference(pcfg, params))
        rstep, rcache, logits = jax.jit(ref.decode_step), ref.init_cache(
            DECODE_BATCH, DECODE_LEN, jnp.float32), []
        for t in range(DECODE_LEN):
            out, rcache = rstep(rparams, jnp.asarray(toks[:, t:t + 1].numpy()), rcache,
                                jnp.int32(t))
            logits.append(np.asarray(out))
        name = f"{arch}-decode"
        cases[name] = {"arch": arch, "layers": layers, "d_model": D_MODEL,
                       "decode": {"params": params, "tokens": toks, "window": window}}
        want[name] = {"logits": np.concatenate(logits, axis=1)}
    torch.save(cases, work / "cases.pt")
    script = work / "ranks.py"
    script.write_text(RANK_SCRIPT)
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    p = subprocess.run([sys.executable, str(script), str(work)], capture_output=True, text=True,
                       timeout=TIMEOUT_S, env=env, cwd=REPO)
    assert p.returncode == 0, p.stdout[-3000:] + p.stderr[-5000:]
    return want, torch.load(work / "out.pt", weights_only=False)


@pytest.mark.parametrize("arch,mode", CASES)
def test_sharded_steps_match_reference(runs, arch, mode):
    want, got = (r[f"{arch}-{mode}"] for r in runs)
    for ref_loss, port_loss in zip(want["losses"], got["losses"], strict=True):
        assert abs(ref_loss - port_loss) <= ATOL * max(1.0, abs(ref_loss))
    assert set(got["params"]) == set(want["params"])
    for k, w in want["params"].items():
        np.testing.assert_allclose(got["params"][k].numpy(), w.numpy(), rtol=0, atol=ATOL,
                                   err_msg=k)


@pytest.mark.parametrize("arch", [a for a, _, _ in DECODE_CASES])
def test_sharded_decode_matches_reference(runs, arch):
    """Every step of a decode through a cache sharded by ``cache_spec_tree``
    (the masked write of ``models/attention.py``, every shard writing its
    own slots) against the reference's decode on one device."""
    want, got = (r[f"{arch}-decode"] for r in runs)
    assert any(got["cache_sharded"])
    np.testing.assert_allclose(got["logits"].numpy(), want["logits"], rtol=0, atol=ATOL)


def test_sharded_prefill_logits_match_reference(runs):
    want, got = (r["llama3-8b-zero1"] for r in runs)
    np.testing.assert_allclose(got["logits"].numpy(), want["logits"], rtol=0, atol=ATOL)
