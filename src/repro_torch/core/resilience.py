"""Fault-tolerant Push-Sum on the host: the paper's §5 resilience to node
failures. Port of ``repro.core.resilience``.

:class:`FaultySim` gossips a node-stacked values tree in matrix form under a
:class:`~repro_torch.core.faults.FaultPlan`: ``matrix(t)`` is the clean
round-t topology matrix (the random protocol drawn from numpy's
``default_rng((seed, t))``, as the reference draws it) pushed through
:func:`~repro_torch.core.faults.apply_faults` under the round's failure
mask. The mask is the port's keyed one
(:func:`~repro_torch.core.faults.keyed_fail_masks` at iteration t, round 0)
unless ``fails`` supplies another, so the simulator and the training loop
share one fault model. Link mode conserves mass; message mode leaks it while
every ratio stays consistent; dead nodes freeze with their mass on the
diagonal. The weight and the rounds live on the values' device, as in
:class:`~repro_torch.core.push_sum.PushSumSim`; ``matrix(t)`` stays numpy.
"""
from __future__ import annotations

from typing import Callable, Literal

import numpy as np
import torch

from repro_torch.core import faults as flt
from repro_torch.core import topology as topo
from repro_torch.core.push_sum import PushSumState, tree_leaves, tree_map

__all__ = ["FaultySim"]


class FaultySim:
    """Matrix-form Push-Sum with per-round random link failures and dead
    nodes. ``fails`` (optional): t → (n, n) bool failure mask of round t."""

    def __init__(self, n_nodes: int, topology: str = "random", seed: int = 0,
                 drop_prob: float = 0.0,
                 drop: Literal["message", "link"] = "link",
                 dead_nodes: tuple[int, ...] = (),
                 fails: Callable[[int], np.ndarray] | None = None):
        self.n = int(n_nodes)
        self.topology = topology
        self.seed = int(seed)
        self.plan = flt.validate_plan(
            flt.FaultPlan(drop_prob=drop_prob, drop=drop,
                          dead_nodes=tuple(dead_nodes), seed=seed), self.n)
        self._fails = fails

    @property
    def drop_prob(self) -> float:
        return self.plan.drop_prob

    @property
    def drop(self) -> str:
        return self.plan.drop

    @property
    def dead(self) -> set[int]:
        return set(self.plan.dead_nodes)

    def fail_mask(self, t: int) -> torch.Tensor:
        """(n, n) bool failure mask of round t."""
        if self._fails is not None:
            return torch.as_tensor(np.asarray(self._fails(t)), dtype=torch.bool)
        return flt.keyed_fail_masks(self.plan, t, 1, 1, self.n)[0, 0]

    def matrix(self, t: int) -> np.ndarray:
        """The faulty round-t mixing matrix, float32."""
        rng = np.random.default_rng((self.seed, t))
        B = topo.build_matrix(self.topology, self.n, t=t,
                              rng=rng if self.topology == "random" else None)
        B = torch.from_numpy(np.asarray(B, np.float32))
        return flt.apply_faults(B, self.fail_mask(t), self.plan).numpy()

    def init(self, values) -> PushSumState:
        """Unit Push-Sum weights on the device of the first leaf."""
        device = tree_leaves(values)[0].device
        return PushSumState(values=values, weight=torch.ones(
            (self.n,), dtype=torch.float32, device=device))

    def round(self, state: PushSumState, t: int) -> PushSumState:
        """One round on the weight's device, where the values live."""
        B = torch.from_numpy(self.matrix(t)).to(state.weight.device)

        def mix(v):
            flat = v.reshape(self.n, -1).to(torch.float32)
            return (B.T @ flat).reshape(v.shape).to(v.dtype)

        return PushSumState(values=tree_map(mix, state.values), weight=B.T @ state.weight)

    def run(self, values, n_rounds: int) -> PushSumState:
        st = self.init(values)
        for t in range(n_rounds):
            st = self.round(st, t)
        return st
