"""A named mesh of processes over ``torch.distributed``: the port's
counterpart of ``shard_map``'s ``axis_index`` and ``ppermute``.

The reference runs its mesh paths (``push_sum_round``, the GADGET mesh step,
consensus mixing and the mesh scorer) inside ``shard_map`` over a device
mesh. Here each mesh position is one process of an initialised process
group, and :class:`Mesh` gives it the few collectives those paths use:

* its coordinate on each named axis (:meth:`Mesh.axis_index`); the rank is
  the linear index, row-major over ``axis_sizes`` in dict order, which is
  the reference's linearisation, so ``FaultPlan.dead_nodes`` names the same
  nodes;
* :meth:`Mesh.ppermute`: send to coordinate ``(c + hop) % n`` of an axis and
  receive from ``(c − hop) % n``, one ``batch_isend_irecv`` pair on the
  world group (no sub-groups);
* :meth:`Mesh.all_reduce_sum` over the world group, or over the slice of
  the calling rank along a set of axes (``pmean``'s ``axis_name`` tuple):
  one process group per slice, built by :meth:`Mesh.slice_group` the first
  time those axes are reduced over. Gloo has no ``ReduceOp.AVG``, so a mean
  is a sum divided by the size;
* :meth:`Mesh.all_gather` on the world group.

A :class:`Mesh` may carry a ``recorder`` (``launch.hlo_parse.CollectiveRecorder``
or anything with its ``record(op, out_bytes, group_size)``), which
:meth:`Mesh.ppermute` tells of every share it sends, under XLA's name
``collective-permute``: the dry-run counts the gossip's bytes so.

Every result comes back on the input's device. NCCL moves device tensors
as they are. Gloo's point-to-point and collectives take CPU tensors only,
so a CUDA tensor is copied to a host buffer before it is sent and back to
its device after it is received; the copies are counted in
:meth:`Mesh.stats` (``host_staged_bytes``), never silent.
"""
from __future__ import annotations

import itertools
import math
import time

import torch
import torch.distributed as dist

__all__ = ["Mesh"]


class Mesh:
    """The calling process's place in a mesh of ``axis_sizes`` (an ordered
    dict of axis name → size) over the world process group. Raises
    ``ValueError`` unless the world size is the product of the axis sizes."""

    def __init__(self, axis_sizes: dict[str, int]):
        if not dist.is_initialized():
            raise RuntimeError("Mesh needs an initialised torch.distributed process group")
        self.axis_sizes = {str(a): int(n) for a, n in axis_sizes.items()}
        if any(n < 1 for n in self.axis_sizes.values()):
            raise ValueError(f"axis sizes must be >= 1, got {self.axis_sizes}")
        self.world = dist.get_world_size()
        total = math.prod(self.axis_sizes.values())
        if total != self.world:
            raise ValueError(f"axis sizes {self.axis_sizes} make {total} positions but the "
                             f"process group has {self.world} ranks")
        self.rank = dist.get_rank()
        self.backend = str(dist.get_backend())
        self.strides: dict[str, int] = {}
        acc = 1
        for ax in reversed(list(self.axis_sizes)):  # row-major over dict order
            self.strides[ax] = acc
            acc *= self.axis_sizes[ax]
        self.coords = {ax: (self.rank // self.strides[ax]) % n
                       for ax, n in self.axis_sizes.items()}
        self.recorder = None
        self._groups: dict[tuple[str, ...], object] = {}
        self.reset_stats()

    # ------------------------------------------------------------ coordinates

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate on ``axis``."""
        return self.coords[axis]

    def partner(self, axis: str, hop: int) -> int:
        """Linear index of the rank ``hop`` steps ahead on ``axis`` (the
        receiver of this rank's share in :meth:`ppermute`)."""
        n, c = self.axis_sizes[axis], self.coords[axis]
        return self.rank + (((c + hop) % n) - c) * self.strides[axis]

    def _members(self, origin: int, names: tuple[str, ...]) -> list[int]:
        """The ranks at ``origin`` plus every coordinate on ``names``, sorted."""
        return sorted(origin + sum(i * self.strides[a] for a, i in zip(names, idx))
                      for idx in itertools.product(*(range(self.axis_sizes[a]) for a in names)))

    def slice_ranks(self, axes) -> tuple[tuple[str, ...], list[int]]:
        """``axes`` in the mesh's order, and the linear indices of the ranks
        that share this rank's coordinates on every other axis (the slice a
        reduction over ``axes`` spans), in increasing order."""
        unknown = set(axes) - set(self.axis_sizes)
        if unknown:
            raise ValueError(f"axes {sorted(unknown)} are not in the mesh {self.axis_sizes}")
        names = tuple(a for a in self.axis_sizes if a in set(axes))
        origin = self.rank - sum(self.coords[a] * self.strides[a] for a in names)
        return names, self._members(origin, names)

    def slice_group(self, axes):
        """The process group of this rank's slice along ``axes``: None (the
        world group) when the slice is the whole mesh. The first call for a
        set of axes builds one group per slice with ``dist.new_group``, in
        the same order on every rank (every rank takes part in every
        group's creation, its own or not), so every rank must make that
        first call, as every rank makes the collective it serves."""
        names, mine = self.slice_ranks(axes)
        if len(mine) == self.world:
            return None
        if names not in self._groups:
            others = [a for a in self.axis_sizes if a not in names]
            for coords in itertools.product(*(range(self.axis_sizes[a]) for a in others)):
                ranks = self._members(sum(c * self.strides[a] for a, c in zip(others, coords)),
                                      names)
                group = dist.new_group(ranks)
                if ranks == mine:
                    self._groups[names] = group
        return self._groups[names]

    # ------------------------------------------------------------ wire copies

    def _staged(self, x: torch.Tensor) -> bool:
        return self.backend == "gloo" and x.device.type != "cpu"

    def _to_wire(self, x: torch.Tensor) -> torch.Tensor:
        if self._staged(x):
            self._stats["host_staged_bytes"] += x.numel() * x.element_size()
            return x.detach().to("cpu")
        return x.contiguous()

    def _from_wire(self, x: torch.Tensor, device: torch.device) -> torch.Tensor:
        if x.device != device:
            self._stats["host_staged_bytes"] += x.numel() * x.element_size()
            return x.to(device)
        return x

    # ------------------------------------------------------------ collectives

    def ppermute(self, x: torch.Tensor, axis: str, hop: int) -> torch.Tensor:
        """Send ``x`` to the rank at coordinate ``(c + hop) % n`` of ``axis``
        and return what the rank at ``(c − hop) % n`` sent; every rank must call it with the same ``axis`` and ``hop``."""
        t0 = time.perf_counter()
        n, c = self.axis_sizes[axis], self.coords[axis]
        dst = self.partner(axis, hop)
        src = self.rank + (((c - hop) % n) - c) * self.strides[axis]
        send = self._to_wire(x.contiguous())
        if self.recorder is not None:
            self.recorder.record("collective-permute", x.numel() * x.element_size(), n)
        if dst == self.rank:  # hop ≡ 0 (mod n): the share stays home
            recv = send.clone()
        else:
            recv = torch.empty_like(send)
            ops = [dist.P2POp(dist.isend, send, dst), dist.P2POp(dist.irecv, recv, src)]
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        out = self._from_wire(recv, x.device)
        self._count(t0)
        return out

    def all_reduce_sum(self, x: torch.Tensor, axes=None) -> torch.Tensor:
        """The elementwise sum of ``x`` over every rank, or with ``axes``
        over this rank's slice along those axes (see :meth:`slice_group`)."""
        group = None if axes is None else self.slice_group(axes)
        t0 = time.perf_counter()
        buf = self._to_wire(x.clone() if not self._staged(x) else x)
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
        out = self._from_wire(buf, x.device)
        self._count(t0)
        return out

    def all_gather(self, x: torch.Tensor) -> list[torch.Tensor]:
        """Every rank's ``x``, in rank order (all of one shape)."""
        t0 = time.perf_counter()
        buf = self._to_wire(x)
        parts = [torch.empty_like(buf) for _ in range(self.world)]
        dist.all_gather(parts, buf)
        out = [self._from_wire(p, x.device) for p in parts]
        self._count(t0)
        return out

    # ------------------------------------------------------------ accounting

    def _count(self, t0: float) -> None:
        self._stats["exchanges"] += 1
        self._stats["exchange_s"] += time.perf_counter() - t0

    def stats(self) -> dict:
        """``exchanges`` (collective calls), ``host_staged_bytes`` (bytes
        copied between the device and host buffers for gloo, both ways) and
        ``exchange_s`` (host seconds inside the collectives)."""
        return dict(self._stats, backend=self.backend, world=self.world)

    def reset_stats(self) -> None:
        self._stats = {"exchanges": 0, "host_staged_bytes": 0, "exchange_s": 0.0}
