"""The port's partition specs (``repro_torch.launch.shardings`` and
``launch.steps.train_state_specs``) against the reference's
(``repro.launch.shardings``) on the same duck meshes: the reference's own
``test_shardings`` cases, then every parameter leaf of every architecture on
the 16 x 16 and 2 x 16 x 16 meshes in fsdp, zero1 and gossip, the batch and
the decode caches. Specs are metadata: nothing is placed; the port's
parameter shapes come from a model on the ``meta`` device."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCH_IDS as REF_ARCH_IDS  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs.shapes import SHAPES as REF_SHAPES  # noqa: E402
from repro.launch import shardings as ref_shard  # noqa: E402
from repro.launch import steps as ref_steps  # noqa: E402
from repro.models.transformer import Model as RefModel  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.configs.shapes import SHAPES  # noqa: E402
from repro_torch.launch import shardings as shard  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models.config import compile_stages  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402
from repro_torch.sharding.api import PartitionSpec as P  # noqa: E402


class FakeMesh:
    """The reference test's duck mesh: ``axis_names`` and ``devices.shape``."""

    def __init__(self, sizes: dict):
        self.axis_names = tuple(sizes)
        self.devices = np.empty(tuple(sizes.values()), dtype=object)


MESH = FakeMesh({"data": 16, "model": 16})
MESHES = {"16x16": MESH, "2x16x16": FakeMesh({"pod": 2, "data": 16, "model": 16})}


def _norm(spec) -> tuple:
    """A spec as a plain tuple of entries (the reference's or the port's)."""
    return tuple(tuple(e) if isinstance(e, (list, tuple)) else e for e in spec)


@functools.lru_cache(maxsize=None)
def _port_shapes(arch: str) -> dict:
    model = Model(get_config(arch), device="meta", dtype=torch.bfloat16,
                  param_dtype=torch.bfloat16)
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}


@functools.lru_cache(maxsize=None)
def _ref_shapes(arch: str):
    m = RefModel(ref_get_config(arch), dtype=jnp.bfloat16, param_dtype=jnp.bfloat16)
    return jax.eval_shape(m.init, jax.random.PRNGKey(0))


def _ref_by_port_name(cfg, ref_specs, gossip: bool) -> dict:
    """The reference's specs keyed by the port's parameter names, the
    stages' layer-repeat axis dropped (after the replica axis, if any)."""
    out = {}
    for key in ("embed", "final_norm", "head"):
        if key in ref_specs:
            for leaf, spec in ref_specs[key].items():
                out[f"{key}.{leaf}"] = _norm(spec)
    layer = 0
    for (kinds, repeats), stage in zip(compile_stages(cfg.n_layers, cfg.block_pattern),
                                       ref_specs["stages"]):
        flat = jax.tree_util.tree_flatten_with_path(
            stage, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
        for r in range(repeats):
            for j in range(len(kinds)):
                for path, spec in flat:
                    keys = [str(p.key) for p in path]
                    if keys[0] != f"blk{j}":
                        continue
                    spec = _norm(spec)
                    spec = spec[:1] + spec[2:] if gossip else spec[1:]
                    out[f"blocks.{layer + r * len(kinds) + j}." + ".".join(keys[1:])] = spec
        layer += repeats * len(kinds)
    return out


def test_arch_lists_match():
    assert tuple(ARCH_IDS) == tuple(REF_ARCH_IDS)


# ------------------------------------------------- the reference's own cases

def test_divisibility_fallback():
    # Hkv=8 cannot shard on a 16-way axis; D=4096 can
    assert shard._spec(MESH, (4096, 8, 128), "data", "model", None) == P("data", None, None)
    assert shard._spec(MESH, (4096, 32, 128), "data", "model", None) == P("data", "model", None)


def test_axis_used_once():
    assert shard._spec(MESH, (4096, 4096), ("model", "data"), "model") == P(("model", "data"), None)


def _specs_for(arch, **kw):
    return shard.param_specs(MESH, {k: torch.empty(s, device="meta")
                                    for k, s in _port_shapes(arch).items()}, **kw)


def test_dense_param_rules():
    specs = _specs_for("llama3-8b")
    assert specs["blocks.0.attn.wq"] == P("data", "model", None)
    assert specs["blocks.0.ch.wi.w"] == P("data", "model")
    assert specs["blocks.0.ch.wo.w"] == P("model", "data")
    assert specs["embed.table"] == P("model", "data")


def test_moe_param_rules():
    specs = _specs_for("qwen2-moe-a2.7b")
    assert specs["blocks.0.ch.wi"] == P(None, "data", "model")     # (E,D,F)
    assert specs["blocks.0.ch.shared.wi.w"] == P("data", "model")


def test_zero1_strips_data():
    specs = _specs_for("llama3-8b", mode="zero1")
    assert specs["blocks.0.ch.wi.w"] == P(None, "model")
    assert specs["embed.table"] == P("model", None)


def test_gossip_adds_replica_axis_and_strips_it_from_core():
    stacked = {k: torch.empty((16,) + s, device="meta") for k, s in _port_shapes("llama3-8b").items()}
    specs = shard.param_specs(MESH, stacked, gossip=True, replica_axis="data")
    assert specs["blocks.0.ch.wi.w"][0] == "data"
    assert "data" not in [a for e in specs["blocks.0.ch.wi.w"][1:] if e
                          for a in ((e,) if isinstance(e, str) else e)]
    assert specs["embed.table"][0] == "data"


def test_cache_spec_tree():
    model = Model(get_config("llama3-8b"), device="meta", dtype=torch.bfloat16,
                  param_dtype=torch.bfloat16)
    specs = shard.cache_spec_tree(MESH, model.init_cache(128, 32768, torch.bfloat16))
    assert specs[0].k == P("data", "model", None, None)  # (B,S,Hkv,Dh)


# ------------------------------------------------- every leaf, every arch

@pytest.mark.parametrize("mode", ["fsdp", "zero1", "gossip"])
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_reference_on_every_leaf(arch, mesh_name, mode):
    mesh = MESHES[mesh_name]
    gossip = mode == "gossip"
    rax = "pod" if "pod" in mesh.axis_names else "data"
    g = mesh.devices.shape[mesh.axis_names.index(rax)]
    kw = dict(gossip=True, replica_axis=rax) if gossip else dict(mode=mode)
    ref_shapes = _ref_shapes(arch)
    if gossip:
        ref_shapes = jax.tree.map(lambda s: jax.ShapeDtypeStruct((g,) + s.shape, s.dtype),
                                  ref_shapes)
    want = _ref_by_port_name(get_config(arch), ref_shard.param_specs(mesh, ref_shapes, **kw),
                             gossip)
    lead = (g,) if gossip else ()
    got = shard.param_specs(mesh, {k: torch.empty(lead + s, device="meta")
                                   for k, s in _port_shapes(arch).items()}, **kw)
    assert set(got) == set(want)
    bad = {k: (_norm(got[k]), want[k]) for k in got if _norm(got[k]) != want[k]}
    assert not bad, sorted(bad.items())[:5]


@pytest.mark.parametrize("gossip", [False, True])
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ["llama3-8b", "llava-next-mistral-7b", "hubert-xlarge"])
def test_batch_specs_match_reference(arch, mesh_name, gossip):
    mesh = MESHES[mesh_name]
    rax = "pod" if "pod" in mesh.axis_names else "data"
    want = ref_shard.batch_specs(mesh, ref_get_config(arch), REF_SHAPES["train_4k"],
                                 gossip_stacked=gossip, replica_axis=rax)
    got = shard.batch_specs(mesh, get_config(arch), SHAPES["train_4k"], gossip_stacked=gossip,
                            replica_axis=rax)
    assert {k: _norm(v) for k, v in got.items()} == {k: _norm(v) for k, v in want.items()}


@pytest.mark.parametrize("arch,batch", [("llama3-8b", 128), ("recurrentgemma-9b", 128),
                                        ("rwkv6-3b", 1), ("mixtral-8x22b", 128)])
def test_cache_specs_match_reference(arch, batch):
    """Each layer's cache spec is the reference's for its stage, repeat axis dropped."""
    cfg = get_config(arch)
    ref_model = RefModel(ref_get_config(arch), dtype=jnp.bfloat16, param_dtype=jnp.bfloat16)
    ref_caches = jax.eval_shape(lambda: ref_model.init_cache(batch, 32768, jnp.bfloat16))
    ref_specs = ref_shard.cache_spec_tree(MESH, ref_caches)
    model = Model(cfg, device="meta", dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    got = shard.cache_spec_tree(MESH, model.init_cache(batch, 32768, torch.bfloat16))
    layer = 0
    for (kinds, repeats), stage in zip(compile_stages(cfg.n_layers, cfg.block_pattern), ref_specs):
        for r in range(repeats):
            for j in range(len(kinds)):
                want = stage[f"blk{j}"]
                assert type(got[layer]).__name__ == type(want).__name__
                for g_spec, w_spec in zip(got[layer], want):
                    assert _norm(g_spec) == _norm(w_spec)[1:], (layer, g_spec, w_spec)
                layer += 1
    assert layer == len(got)


@pytest.mark.parametrize("optimizer", ["adamw", "sgd"])
@pytest.mark.parametrize("consensus", ["allreduce", "gossip"])
def test_train_state_specs_match_reference(optimizer, consensus):
    shapes = {k: torch.empty(s, device="meta") for k, s in _port_shapes("llama3-8b").items()}
    pspecs = shard.param_specs(MESH, shapes, mode="zero1")
    mspecs = shard.param_specs(MESH, shapes, mode="fsdp")
    tcfg = steps.TrainerConfig(optimizer=optimizer, consensus=consensus)
    got = steps.train_state_specs(pspecs, tcfg, moment_specs=mspecs)
    ref = ref_steps.train_state_specs({"w": jax.sharding.PartitionSpec("data")},
                                      ref_steps.TrainerConfig(optimizer=optimizer,
                                                              consensus=consensus))
    assert got["params"] is pspecs and _norm(got["step"]) == _norm(ref["step"])
    if optimizer == "adamw":
        assert got["opt"].mu is mspecs and got["opt"].nu is mspecs
        assert _norm(got["opt"].step) == _norm(ref["opt"].step)
    else:
        assert got["opt"][0].momentum is mspecs
        assert _norm(got["opt"][1].step) == _norm(ref["opt"][1].step)
