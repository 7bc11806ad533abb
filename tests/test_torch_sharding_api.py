"""The port's logical-axis rules (``repro_torch.sharding.api``) against the
reference's (``repro.sharding.api``), ``constrain`` on DTensors of a fake
256-rank world (``launch.mesh.fake_world``), and the fake world's cleanup."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import torch.distributed as dist  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro.sharding import api as ref_api  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.sharding import api  # noqa: E402

RULES = {"batch": ("pod", "data"), "seq": None, "embed": None, "vocab": "model",
         "mlp": "model", "heads_dec": None, "cache_seq": "model", "both": ("model", "data")}


class FakeMesh:
    def __init__(self, sizes: dict):
        self.axis_names = tuple(sizes)
        self.devices = np.empty(tuple(sizes.values()), dtype=object)


def _norm(spec) -> tuple:
    return tuple(tuple(e) if isinstance(e, (list, tuple)) else e for e in spec)


@pytest.mark.parametrize("axes", [("batch", "seq", "embed"), ("batch", "seq", "vocab"),
                                  ("vocab", "mlp"), ("both", "batch", "mlp"),
                                  (None, "heads_dec", "cache_seq"), ("unknown", "batch")])
def test_axis_rules_spec_matches_reference(axes):
    mesh = FakeMesh({"pod": 2, "data": 16, "model": 16})
    want = ref_api.AxisRules(mesh, RULES).spec(axes)
    got = api.AxisRules(mesh, RULES).spec(axes)
    assert _norm(got) == _norm(want)
    assert api.logical_to_spec(api.AxisRules(mesh, RULES), axes) == got
    assert api.param_spec(api.AxisRules(mesh, RULES), "x", (3, 4)) == api.PartitionSpec(None, None)


def test_activate_nests_and_restores():
    mesh = FakeMesh({"data": 2, "model": 2})
    outer, inner = api.AxisRules(mesh, RULES), api.AxisRules(mesh, {})
    assert api.current_rules() is None
    with api.activate(outer):
        with api.activate(inner):
            assert api.current_rules() is inner
        assert api.current_rules() is outer
    assert api.current_rules() is None


def test_constrain_is_the_identity_without_rules_and_on_plain_tensors():
    x = torch.arange(12.0).reshape(3, 4)
    assert api.constrain(x, ("batch", "embed")) is x
    with api.activate(api.AxisRules(FakeMesh({"data": 2, "model": 2}), RULES)):
        assert api.constrain(x, ("batch", "embed")) is x


def _dtensor(mesh, shape, placements):
    from torch.distributed.tensor import DTensor
    from repro_torch.launch.shardings import _local_shape

    local = torch.empty(_local_shape(shape, mesh, placements))
    return DTensor.from_local(local, mesh, placements, run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta").stride())


def test_constrain_places_dtensors_and_drops_what_does_not_divide():
    from torch.distributed.tensor import Replicate, Shard

    with M.fake_world(256):
        mesh = M.make_production_mesh(device_type="cpu")
        rules = api.AxisRules(mesh, {"batch": "data", "vocab": "model", "embed": None})
        with FakeTensorMode(allow_non_fake_inputs=True), api.activate(rules):
            rep = (Replicate(), Replicate())
            x = api.constrain(_dtensor(mesh, (32, 8, 64), rep), ("batch", None, "embed"))
            assert tuple(x.placements) == (Shard(0), Replicate())
            assert tuple(x.to_local().shape) == (2, 8, 64)
            one = api.constrain(_dtensor(mesh, (1, 8, 64), rep), ("batch", None, "embed"))
            assert tuple(one.placements) == rep  # batch 1 never shards
            logits = api.constrain(_dtensor(mesh, (32, 8, 160), rep), ("batch", None, "vocab"))
            assert tuple(logits.placements) == (Shard(0), Shard(2))
            # fewer axes than dims: aligned to the trailing dims, as the reference's vmap rule
            y = api.constrain(_dtensor(mesh, (4, 32, 160), rep), ("batch", "vocab"))
            assert tuple(y.placements) == (Shard(1), Shard(2))
            assert api.placements(mesh, api.PartitionSpec(("model", "data"), None)) == (
                Shard(0), Shard(0))
    assert not dist.is_initialized()


def test_fake_world_leaves_no_group_behind_even_when_its_body_raises():
    with pytest.raises(ValueError, match="boom"):
        with M.fake_world(512):
            assert dist.get_world_size() == 512
            mesh = M.make_production_mesh(multi_pod=True, device_type="cpu")
            assert M.axis_sizes(mesh) == {"pod": 2, "data": 16, "model": 16}
            raise ValueError("boom")
    assert not dist.is_initialized()
    with M.fake_world(4):  # a later group in the same process starts clean
        with pytest.raises(ValueError, match="needs 256 ranks"):
            M.make_production_mesh(device_type="cpu")
        with pytest.raises(ValueError, match="only 4 ranks"):
            M.make_host_mesh(4, 2, device_type="cpu")
        assert M.axis_sizes(M.make_host_mesh(2, 2, device_type="cpu")) == {"data": 2, "model": 2}
        assert M.axis_sizes(M.make_host_mesh(1, 2, device_type="cpu")) == {"data": 1, "model": 2}
    assert not dist.is_initialized()


def test_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="fake_world"):
        M.make_host_mesh(1, 1, device_type="cpu")
