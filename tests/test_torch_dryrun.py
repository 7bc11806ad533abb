"""The port's dry-run (``repro_torch.launch.dryrun``) against the
reference's: parameter, active-parameter and model-FLOP counts of every
architecture, the argument bytes the reference's specs imply, skip
messages, ``seq_shard`` (the arg bytes and model FLOPs kept) and
``swa_variant`` (long_500k's skips as the reference's variant has them), the
collective conventions of ``tests/test_hlo_parse.py`` with
the reference's parser as the oracle, every layer counted (the 4-layer
minus 2-layer identity that makes the reference's ``analysis.py``
unnecessary here), the multi-pod gossip's point-to-point permutes, and the
CLI. Full width; the traced runs at 2-4 layers and short sequences."""
import dataclasses
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

jax.devices()  # the backend is up before the reference's dry-run module sets its flag
_flags = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as ref_dryrun  # noqa: E402
if _flags is None:  # the reference's module sets 512 host devices for its own process
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _flags

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs.shapes import SHAPES as REF_SHAPES, skip_reason as ref_skip  # noqa: E402
from repro.launch import input_specs as ref_ispecs  # noqa: E402
from repro.launch import shardings as ref_shard  # noqa: E402
from repro.launch import steps as ref_steps  # noqa: E402
from repro.launch.hlo_parse import (_COLL_RE, _GROUPS_RE, _shape_bytes,  # noqa: E402
                                    parse_collectives)
from repro.models.transformer import Model as RefModel  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.configs.shapes import SHAPES, InputShape  # noqa: E402
from repro_torch.configs.shapes import skip_reason as dryrun_skip  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.hlo_parse import CollectiveRecorder  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
SHORT = InputShape("train_4k", 256, 256, "train")  # the batch of train_4k, a short sequence


class FakeMesh:
    def __init__(self, sizes: dict):
        self.axis_names = tuple(sizes)
        self.devices = np.empty(tuple(sizes.values()), dtype=object)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_counts_match_reference(arch):
    ref_params = jax.eval_shape(RefModel(ref_get_config(arch), dtype=jnp.bfloat16,
                                         param_dtype=jnp.bfloat16).init, jax.random.PRNGKey(0))
    model = Model(get_config(arch), device="meta", dtype=torch.bfloat16,
                  param_dtype=torch.bfloat16)
    params = dict(model.state_dict())
    n, n_active = dryrun.count_params(params), dryrun.count_active_params(model.cfg, params)
    assert n == ref_dryrun.count_params(ref_params)
    assert n_active == ref_dryrun.count_active_params(ref_get_config(arch), ref_params)
    for name in ("train_4k", "decode_32k"):
        assert dryrun.model_flops(model.cfg, SHAPES[name], n_active, n) == ref_dryrun.model_flops(
            ref_get_config(arch), REF_SHAPES[name], n_active, n)


def _local_bytes(mesh, tree, specs) -> int:
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    total = 0
    for leaf, spec in zip(jax.tree.leaves(tree), jax.tree.leaves(
            specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))):
        shape = list(leaf.shape)
        for i, entry in enumerate(tuple(spec)):
            for a in ((entry,) if isinstance(entry, str) else (entry or ())):
                shape[i] //= sizes[a]
        total += math.prod(shape) * leaf.dtype.itemsize
    return total


def _reference_arg_bytes() -> int:
    """The local bytes of llama3-8b's train state (2 layers, zero1 weights,
    fsdp moments) and batch (train_4k at ``SHORT``'s length) on a 16 x 16
    mesh, by the reference's specs."""
    mesh = FakeMesh({"data": 16, "model": 16})
    cfg = dataclasses.replace(ref_get_config("llama3-8b"), n_layers=2)
    tcfg = ref_steps.TrainerConfig(replica_axis="data")
    model = RefModel(cfg, dtype=jnp.bfloat16, param_dtype=jnp.bfloat16)
    state = jax.eval_shape(lambda k: ref_steps.make_train_state(model, tcfg, k),
                           jax.random.PRNGKey(0))
    pspecs = ref_shard.param_specs(mesh, state["params"], mode="zero1")
    mspecs = ref_shard.param_specs(mesh, state["params"], mode="fsdp")
    sspecs = ref_steps.train_state_specs(pspecs, tcfg, moment_specs=mspecs)
    shape = dataclasses.replace(REF_SHAPES["train_4k"], seq_len=SHORT.seq_len)
    batch = ref_ispecs.train_batch_shapes(cfg, shape)
    return (_local_bytes(mesh, state, sspecs)
            + _local_bytes(mesh, batch, ref_shard.batch_specs(mesh, cfg, shape)))


def test_arg_bytes_are_the_local_shards_the_reference_specs_imply():
    want = _reference_arg_bytes()
    res = dryrun.run_one("llama3-8b", "train_4k", n_layers=2, shape=SHORT, verbose=False)
    assert res.status == "ok", res.reason
    assert res.arg_bytes == want
    assert res.per_device_bytes > res.arg_bytes and res.hlo_flops > 0 and res.bottleneck


def test_seq_shard_keeps_the_reference_arg_bytes_and_model_flops():
    """``seq_shard=True`` sets the ``seq`` rule to ``model`` (the reference's
    ``--seq-shard``): the state and batch stay the local shards the
    reference's specs imply (no spec reads the ``seq`` rule), the model's
    FLOPs are unchanged, and the residual stream between blocks is split
    16 ways, so under remat (which keeps only the blocks' inputs) the
    device holds less."""
    kw = dict(n_layers=2, shape=SHORT, remat=True, verbose=False)
    base = dryrun.run_one("llama3-8b", "train_4k", **kw)
    res = dryrun.run_one("llama3-8b", "train_4k", seq_shard=True, **kw)
    assert base.status == res.status == "ok", (base.reason, res.reason)
    assert res.arg_bytes == base.arg_bytes == _reference_arg_bytes()
    assert res.model_flops_global == base.model_flops_global
    assert res.per_device_bytes < base.per_device_bytes


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_swa_variant_turns_long_500k_skips_where_the_reference_does(arch, monkeypatch):
    """``swa_variant=True`` on long_500k: a dense arch runs as ``<arch>+swa``
    with every block sliding-window at 4,096; the result is ``ok`` exactly
    where the reference's ``skip_reason`` of the same variant says it runs,
    and otherwise skipped with its message."""
    rcfg = ref_get_config(arch)
    dense = not rcfg.subquadratic() and not rcfg.is_encoder
    if dense:  # the reference's variant (src/repro/launch/dryrun.py, run_one)
        rcfg = dataclasses.replace(rcfg, name=f"{rcfg.name}+swa",
                                   block_pattern=tuple("swa" for _ in rcfg.block_pattern),
                                   window=4096)
    want = ref_skip(rcfg, REF_SHAPES["long_500k"])
    seen = []
    monkeypatch.setattr(dryrun, "skip_reason",
                        lambda cfg, shape: seen.append(cfg) or dryrun_skip(cfg, shape))
    res = dryrun.run_one(arch, "long_500k", swa_variant=True, n_layers=1, verbose=False)
    (cfg,) = seen
    assert res.arch == (f"{arch}+swa" if dense else arch)
    assert (cfg.name, cfg.block_pattern, cfg.window) == (rcfg.name, rcfg.block_pattern,
                                                         rcfg.window)
    if want is None:
        assert res.status == "ok", res.reason
        assert res.per_device_bytes > 0
    else:
        assert (res.status, res.reason) == ("skipped", want)


def test_every_layer_is_counted():
    """FLOPs(4 layers) − FLOPs(2) = 2 · (FLOPs(3) − FLOPs(2)): the Python
    layer loop is seen whole (XLA counts a scanned body once, hence the
    reference's analysis.py)."""
    shape = InputShape("train_4k", 128, 32, "train")
    f = {n: dryrun.run_one("llama3-8b", "train_4k", n_layers=n, shape=shape, verbose=False)
         for n in (2, 3, 4)}
    assert all(r.status == "ok" for r in f.values()), {n: r.reason for n, r in f.items()}
    flops = {n: r.hlo_flops for n, r in f.items()}
    assert flops[3] > flops[2]
    assert flops[4] - flops[2] == 2 * (flops[3] - flops[2])
    moved = {n: r.hlo_bytes for n, r in f.items()}
    assert moved[4] - moved[2] == 2 * (moved[3] - moved[2])


@pytest.mark.parametrize("arch,shape,consensus", [("llama3-8b", "long_500k", "allreduce"),
                                                  ("hubert-xlarge", "decode_32k", "allreduce"),
                                                  ("llama3-8b", "decode_32k", "gossip")])
def test_skip_messages_match_reference(arch, shape, consensus):
    res = dryrun.run_one(arch, shape, consensus=consensus, verbose=False)
    assert res.status == "skipped"
    want = ref_skip(ref_get_config(arch), REF_SHAPES[shape]) or (
        "gossip consensus applies to training only")
    assert res.reason == want


def test_multi_pod_gossip_permutes_on_the_pod_axis():
    res = dryrun.run_one("rwkv6-3b", "train_4k", multi_pod=True, consensus="gossip",
                         n_layers=1, shape=InputShape("train_4k", 128, 64, "train"),
                         verbose=False)
    assert res.status == "ok", res.reason
    assert res.mesh.startswith("2x16x16")
    assert res.collectives["count_by_op"].get("collective-permute", 0) >= 1


HLO_CASES = [
    "  %all-reduce = f32[128]{0} all-reduce(%x), replica_groups=[32,16]<=[512]",
    ("  %all-gather = bf16[64,32]{1,0} all-gather(%x), "
     "replica_groups={{0,1,2,3},{4,5,6,7}}, dimensions={0}"),
    "  %collective-permute = f32[16,16]{1,0} collective-permute(%x), channel_id=7",
    ("  %reduce-scatter = f32[8]{0} reduce-scatter(%x), "
     "replica_groups=[2,8]<=[16], dimensions={0}"),
    "\n".join(["  %dot = f32[128,128]{1,0} dot(%a, %b)", "  %add = f32[4]{0} add(%x, %y)",
               "ENTRY %main { ... }"]),
    "\n".join(["  %all-gather.1 = f32[4]{0} all-gather(%x), replica_groups={{0,1}}",
               "  %all-gather.2 = f32[4]{0} all-gather(%y), replica_groups={{0,1}}"]),
]


@pytest.mark.parametrize("text", HLO_CASES)
def test_ring_conventions_match_the_reference_parser(text):
    rec = CollectiveRecorder()
    for line in text.splitlines():
        m = _COLL_RE.search(line)
        if not m:
            continue
        g, gm = 1, _GROUPS_RE.search(line)
        if gm:
            g = (gm.group("explicit").count(",") + 1 if gm.group("explicit") is not None
                 else int(gm.group("gsz")))
        rec.record(m.group("op"), _shape_bytes(m.group("dtype"), m.group("dims")), g)
    assert rec.summary() == parse_collectives(text)


def test_cli_single_pod():
    p = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "rwkv6-3b",
                        "--shape", "long_500k"], capture_output=True, text=True, timeout=300,
                       env={**os.environ, "PYTHONPATH": str(REPO / "src")}, cwd=REPO)
    assert p.returncode == 0, p.stdout[-2000:] + p.stderr[-2000:]
    assert "1 ok, 0 skipped, 0 failed" in p.stdout
    assert "H100" in p.stdout
