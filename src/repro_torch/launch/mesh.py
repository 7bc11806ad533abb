"""Production meshes as ``DeviceMesh``es, the port of ``repro.launch.mesh``.

Single pod: 256 ranks as (data=16, model=16). Multi-pod: 2 pods = 512 ranks
as (pod=2, data=16, model=16), the `pod` axis the gossip axis of the
hierarchical-consensus deployment. Each rank of the initialised
``torch.distributed`` world is one position (one card in a deployment).

:func:`fake_world` initialises the ``fake`` backend
(``torch.testing._internal.distributed.fake_pg``) as rank 0 of a world of n
ranks in this one process, so the production meshes can be built, and a
step traced on them under ``FakeTensorMode``, with no card and no peers:
the dry-run's setting. Its collectives move nothing.
"""
from __future__ import annotations

import contextlib
import math

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.sharding.api import mesh_axis_sizes

__all__ = ["make_production_mesh", "make_host_mesh", "axis_sizes", "fake_world"]


def _world() -> int:
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs an initialised torch.distributed process group "
                           "(fake_world(n) for a dry run)")
    return dist.get_world_size()


def make_production_mesh(multi_pod: bool = False, device_type: str = "cuda") -> DeviceMesh:
    """(data 16, model 16), or (pod 2, data 16, model 16) with ``multi_pod``;
    raises unless the world has exactly that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    world = _world()
    if world != math.prod(shape):
        raise ValueError(f"the production mesh {shape} needs {math.prod(shape)} ranks; "
                         f"the world has {world}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(data: int = 1, model: int = 1, device_type: str = "cuda") -> DeviceMesh:
    """A (data, model) mesh over the first data·model ranks of the world
    (tests, one card); raises when the world is too small."""
    world = _world()
    if data * model > world:
        raise ValueError(f"requested {data}x{model} mesh but only {world} ranks")
    if data * model == world:
        return init_device_mesh(device_type, (data, model), mesh_dim_names=("data", "model"))
    ranks = list(range(data * model))
    return DeviceMesh(device_type, [ranks[i * model:(i + 1) * model] for i in range(data)],
                      mesh_dim_names=("data", "model"))


def axis_sizes(mesh) -> dict[str, int]:
    return mesh_axis_sizes(mesh)


@contextlib.contextmanager
def fake_world(n: int):
    """This process as rank 0 of an n-rank world on the ``fake`` backend;
    the group is destroyed on exit, also when the body raises, so later
    gloo or NCCL groups in the same process start clean."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised in this process")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()
