"""Consensus strategies: the paper's gossip protocol as an alternative to
all-reduce data parallelism for any model. Port of ``repro.core.consensus``
onto :class:`~repro_torch.core.mesh.Mesh` (one replica a process).

* ``allreduce``: gradients are averaged over the replica axes every step (a
  SUM over the axes' slice divided by its size: gloo has no ``ReduceOp.AVG``).
* ``gossip``: each replica applies its own update, then the *parameters*
  are mixed with R Push-Sum rounds over the time-varying one-peer
  exponential graph (one exchange a round). R = log2(n) gives exact
  averaging; fewer rounds the paper's partial consensus.

:func:`gossip_mix_stacked` is the single-process view: every leaf carries a
leading replica axis and a round is ``s·x + (1 − s)·roll(x, hop)``.
:func:`gossip_mix_axis` is the same schedule and arithmetic with the
replicas spread over one axis of a mesh, each rank holding its replica's
share of every leaf: a round is one ``ppermute`` a leaf along that axis.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Sequence

import torch

from repro_torch.core.mesh import Mesh
from repro_torch.core.push_sum import (PushSumState, exponential_schedule, push_sum_round,
                                       tree_leaves, tree_map)

__all__ = ["ConsensusConfig", "allreduce_grads", "gossip_mix", "gossip_mix_stacked",
           "gossip_mix_axis", "mix_params"]


class ConsensusConfig(NamedTuple):
    kind: str = "allreduce"       # "allreduce" | "gossip" | "none"
    gossip_rounds: int = 2        # R — Push-Sum rounds per optimizer step
    self_share: float = 0.5
    mix_every: int = 1            # gossip only every k-th step (local SGD flavour)

    def validate(self) -> "ConsensusConfig":
        if self.kind not in ("allreduce", "gossip", "none"):
            raise ValueError(f"unknown consensus kind {self.kind!r}")
        if self.gossip_rounds < 1 or self.mix_every < 1:
            raise ValueError("gossip_rounds and mix_every must be >= 1")
        return self


def allreduce_grads(grads: Any, axis_names: Sequence[str], *, mesh) -> Any:
    """``pmean`` over ``axis_names``: the mean of every leaf over the ranks
    of ``mesh`` that differ from this one only on those axes (a SUM divided
    by their count). Over every axis it is the whole-mesh mean; on a
    (data, model) mesh ``("data",)`` is the data-parallel gradient mean."""
    names, ranks = mesh.slice_ranks(axis_names)
    return tree_map(lambda g: mesh.all_reduce_sum(g, axes=names) / len(ranks), grads)


def gossip_mix(params: Any, step: int, *, axis_sizes: dict[str, int], rounds: int,
               self_share: float = 0.5, mesh=None) -> Any:
    """R Push-Sum rounds on the parameter tree over the mesh, returning this
    rank's estimate. The hop schedule is rotated by ``step`` so consecutive
    steps continue the exponential sequence."""
    sched = exponential_schedule(axis_sizes)
    if not sched:
        return params
    mesh = Mesh(axis_sizes) if mesh is None else mesh
    L = len(sched)
    leaves = tree_leaves(params)
    state = PushSumState(values=params, weight=torch.ones(
        (), dtype=torch.float32, device=leaves[0].device))
    base = (int(step) * rounds) % L
    for k in range(rounds):
        state = push_sum_round(state, sched[(base + k) % L], self_share=self_share, mesh=mesh)
    return state.estimate()


def gossip_mix_stacked(params: Any, step: int, *, n_nodes: int, rounds: int = 1,
                       self_share: float = 0.5, payload_dtype: torch.dtype | None = None) -> Any:
    """Gossip over a leading replica axis of size ``n_nodes`` in one process:
    a round is ``x ← s·x + (1 − s)·roll(x, hop, 0)`` with hops 1, 2, …, n/2
    rotated by ``step``. The schedule is doubly stochastic, so the Push-Sum
    weight stays 1 and is not tracked. ``payload_dtype`` (e.g.
    ``torch.bfloat16``) quantises only the sent share; the kept share stays
    full precision."""
    if n_nodes == 1:
        return params
    hops = _hops(n_nodes)

    def mixer(hop):
        def mix(x):
            sent = x.to(payload_dtype) if payload_dtype is not None else x
            return _mix(x, torch.roll(sent, hop, dims=0), self_share)
        return mix

    L = len(hops)
    base = (int(step) * rounds) % L
    for k in range(rounds):
        params = tree_map(mixer(hops[(base + k) % L]), params)
    return params


def _hops(n_nodes: int) -> list[int]:
    if n_nodes & (n_nodes - 1):
        raise ValueError("n_nodes must be a power of two")
    return [1 << k for k in range((n_nodes - 1).bit_length())]


def _mix(x: torch.Tensor, recv: torch.Tensor, self_share: float) -> torch.Tensor:
    return (self_share * x.to(torch.float32)
            + (1.0 - self_share) * recv.to(torch.float32)).to(x.dtype)


def gossip_mix_axis(params: Any, step: int, *, mesh: Mesh, axis: str, rounds: int = 1,
                    self_share: float = 0.5, payload_dtype: torch.dtype | None = None) -> Any:
    """:func:`gossip_mix_stacked` with the replicas on ``axis`` of ``mesh``:
    ``params`` is this rank's share of its replica's leaves, and a round at
    hop h receives the share of the replica h places back on the axis
    (``Mesh.ppermute``), so rank c mixes as ``roll(x, h)[c]`` does."""
    n_nodes = mesh.axis_sizes[axis]
    if n_nodes == 1:
        return params
    hops = _hops(n_nodes)
    base = (int(step) * rounds) % len(hops)
    for k in range(rounds):
        hop = hops[(base + k) % len(hops)]

        def mix(x, hop=hop):
            sent = x.to(payload_dtype) if payload_dtype is not None else x
            return _mix(x, mesh.ppermute(sent, axis, hop), self_share)

        params = tree_map(mix, params)
    return params


def mix_params(cfg: ConsensusConfig, params: Any, step: int, *,
               axis_sizes: dict[str, int], mesh=None) -> Any:
    """Post-update parameter mixing by the configured strategy (gossip only
    every ``mix_every``-th step)."""
    if cfg.kind != "gossip" or int(step) % cfg.mix_every != 0:
        return params
    return gossip_mix(params, step, axis_sizes=axis_sizes, rounds=cfg.gossip_rounds,
                      self_share=cfg.self_share, mesh=mesh)
