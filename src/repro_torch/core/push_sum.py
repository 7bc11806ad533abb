"""Push-Sum / Push-Vector (Kempe, Dobra & Gehrke 2003). Port of
``repro.core.push_sum``; two execution paths, same semantics:

* **Simulator path** (:class:`PushSumSim`, :func:`mix_rounds`,
  :func:`collapse_rounds`): all n nodes live in one tensor with a leading
  node axis, and one gossip round is the linear map x' = Bᵀx applied to
  the (n, ...) values and the (n,) mass weights; R rounds fold into one
  matrix P = B_Rᵀ ⋯ B_1ᵀ. Plain matrix products, outside any kernel in the
  reference too.
* **Mesh path** (:func:`push_sum_round`, :func:`push_sum_mesh`): each node
  is one process of a :class:`~repro_torch.core.mesh.Mesh`, and a round is
  one :meth:`~repro_torch.core.mesh.Mesh.ppermute` with a one-peer
  exponential hop; multi-axis meshes gossip on one axis a round following
  :func:`exponential_schedule`. Mass weights are scalars there.

Total mass is conserved on both paths: Σ_i v_{t,i} = Σ_i v_{0,i} and
Σ_i w_{t,i} = n, and v/w at every node converges to the network average.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.core import topology as topo
from repro_torch.core.mesh import Mesh

__all__ = ["PushSumState", "PushSumSim", "GossipRound", "tree_map", "tree_leaves",
           "exponential_schedule", "mix_rounds", "collapse_rounds", "mix_collapsed",
           "push_sum_round", "push_sum_mesh"]


def tree_map(fn, tree: Any) -> Any:
    """``fn`` over every tensor leaf of nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree: Any) -> list:
    """The tensor leaves of nested dicts, lists and tuples, in order."""
    out: list = []
    tree_map(out.append, tree)
    return out


class PushSumState(NamedTuple):
    """Push-Sum mass: a values tree and its mass weight. Simulator path:
    every leaf carries a leading node axis of size n and ``weight`` is (n,).
    Mesh path: the leaves are the node's own values and ``weight`` a
    0-dimensional tensor."""

    values: Any
    weight: torch.Tensor

    def estimate(self) -> Any:
        """Each node's current average estimate v / w."""
        w = self.weight

        def div(v):
            return v / w.reshape(w.shape + (1,) * (v.ndim - w.ndim)).to(v.dtype)

        return tree_map(div, self.values)


# ---------------------------------------------------------------------------
# Simulator path (matrix form, any topology)
# ---------------------------------------------------------------------------


class PushSumSim:
    """Matrix-form Push-Sum over n simulated nodes. B[i, j] is the share of
    node i's mass pushed to node j, so one round applies x' = Bᵀx (mass
    conserving even when B is only row-stochastic, as the paper's random
    one-neighbour protocol is). ``matrix(t)`` is built on the host, the
    random protocol from ``np.random.default_rng((seed, t))`` as the
    reference builds it; the rounds run on the values' device."""

    def __init__(self, n_nodes: int, topology: str = "exponential", seed: int = 0):
        if topology not in topo.TOPOLOGIES:
            raise ValueError(f"unknown topology {topology!r}")
        self.n = int(n_nodes)
        self.topology = topology
        self.seed = int(seed)

    def matrix(self, t: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, t)) if self.topology == "random" else None
        return topo.build_matrix(self.topology, self.n, t=t, rng=rng)

    def init(self, values: Any) -> PushSumState:
        leaves = tree_leaves(values)
        if not leaves or any(leaf.shape[0] != self.n for leaf in leaves):
            raise ValueError(f"every leaf needs leading node axis of size {self.n}")
        return PushSumState(values=values, weight=torch.ones(
            (self.n,), dtype=torch.float32, device=leaves[0].device))

    def round(self, state: PushSumState, t: int) -> PushSumState:
        B = torch.as_tensor(self.matrix(t), dtype=torch.float32, device=state.weight.device)

        def mix(v):
            out = B.T @ v.reshape(self.n, -1).to(torch.float32)
            return out.reshape(v.shape).to(v.dtype)

        return PushSumState(tree_map(mix, state.values), B.T @ state.weight)

    def run(self, values: Any, n_rounds: int, t0: int = 0) -> PushSumState:
        state = self.init(values)
        for t in range(t0, t0 + n_rounds):
            state = self.round(state, t)
        return state

    def rounds_for_error(self, gamma: float) -> int:
        """O(τ_mix · log(1/γ)) rounds, from the spectral bound."""
        tau = topo.mixing_time_bound(self.matrix(0))
        if not np.isfinite(tau):
            raise ValueError("disconnected topology: infinite mixing time")
        return max(1, int(np.ceil(tau * np.log(1.0 / gamma))))


def mix_rounds(values: torch.Tensor, weight: torch.Tensor,
               B_rounds: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Apply R rounds x' = Bᵀx in order to (n, ...) values and (n,) weights.
    ``B_rounds``: (R, n, n)."""
    v, w = values, weight
    for B in B_rounds:
        v, w = B.T @ v, B.T @ w
    return v, w


def collapse_rounds(B_rounds: torch.Tensor) -> torch.Tensor:
    """Fold (..., R, n, n) round stacks into P = B_Rᵀ ⋯ B_1ᵀ, shape (..., n, n):
    ``mix_rounds(v, w, Bs) == (P @ v, P @ w)``. Leading axes are a batch
    (for example a chunk of iterations)."""
    n = B_rounds.shape[-1]
    P = torch.eye(n, dtype=B_rounds.dtype, device=B_rounds.device).expand(
        B_rounds.shape[:-3] + (n, n))
    for r in range(B_rounds.shape[-3]):
        P = B_rounds[..., r, :, :].transpose(-1, -2) @ P
    return P


def mix_collapsed(values: torch.Tensor, weight: torch.Tensor,
                  P: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Apply a collapsed round product: (P @ values, P @ weight)."""
    return P @ values, P @ weight


# ---------------------------------------------------------------------------
# Mesh path (one process a node, one-peer exponential graph per axis)
# ---------------------------------------------------------------------------


class GossipRound(NamedTuple):
    axis: str  # mesh axis the exchange runs on
    hop: int   # ring distance 2^k on that axis


def exponential_schedule(axis_sizes: dict[str, int]) -> list[GossipRound]:
    """Torus factorisation of the one-peer exponential exchange: hops 1, 2,
    …, n_i/2 on each axis in turn, Σ_i log2(n_i) rounds, after which (with
    self_share 0.5) every node holds the exact global average. Axes of size
    1 add nothing; any other size must be a power of two."""
    rounds: list[GossipRound] = []
    for axis, n in axis_sizes.items():
        if n == 1:
            continue
        if n & (n - 1):
            raise ValueError(f"axis {axis!r} size {n} must be a power of two for the "
                             "exponential schedule")
        hop = 1
        while hop < n:
            rounds.append(GossipRound(axis=axis, hop=hop))
            hop *= 2
    return rounds


def _ring_perm(n: int, hop: int) -> list[tuple[int, int]]:
    """(source, destination) coordinate pairs of a ``hop`` exchange on a ring of n."""
    return [(i, (i + hop) % n) for i in range(n)]


def _shift_all(mesh, rnd: GossipRound, leaves: list[torch.Tensor]) -> list[torch.Tensor]:
    """One :meth:`Mesh.ppermute` of every float32 tensor in ``leaves``,
    packed into one buffer: one exchange a round."""
    flat = torch.cat([leaf.reshape(-1) for leaf in leaves])
    got = mesh.ppermute(flat, rnd.axis, rnd.hop)
    out, at = [], 0
    for leaf in leaves:
        out.append(got[at:at + leaf.numel()].view(leaf.shape))
        at += leaf.numel()
    return out


def push_sum_round(state: PushSumState, rnd: GossipRound, *, mesh, self_share: float = 0.5,
                   fault: tuple | None = None) -> PushSumState:
    """One Push-Sum round on the mesh: keep ``self_share`` of the local mass
    and send the rest ``rnd.hop`` steps along ``rnd.axis`` (one exchange for
    the values and the weight together). Every rank of the mesh must call it.

    ``fault``: a ``(fail_send, dead, drop)`` triple of this rank's Python
    bools and the plan's drop mode. A failed send zeroes the outgoing share
    (the exchange still runs, so the collective stays uniform); ``"link"``
    keeps the undelivered share at home (mass conserved), ``"message"``
    loses it; ``dead`` freezes the rank's values and weight. ``mesh``: the
    :class:`~repro_torch.core.mesh.Mesh` the round runs on."""
    if mesh.axis_sizes[rnd.axis] == 1:
        return state
    send = 1.0 - self_share
    leaves = tree_leaves(state.values)
    if fault is None:
        keep, send_gate, dead = self_share, send, False
    else:
        fail_send, dead, drop = fault
        fail_send = bool(fail_send) or bool(dead)  # dead nodes never deliver
        send_gate = 0.0 if fail_send else send
        # "link": the sender keeps the share it could not deliver; "message":
        # the share is lost in flight (value and weight mass vanish together)
        keep = self_share + (send if fail_send and drop == "link" else 0.0)
    v32 = [leaf.to(torch.float32) for leaf in leaves]
    w = state.weight.to(torch.float32).reshape(1)
    recv = _shift_all(mesh, rnd, [v * send_gate for v in v32] + [w * send_gate])
    if dead:
        return state
    mixed = iter([(v * keep + r) for v, r in zip(v32, recv[:-1])])
    values = tree_map(lambda leaf: next(mixed).to(leaf.dtype), state.values)
    weight = (w * keep + recv[-1]).reshape(state.weight.shape)
    return PushSumState(values, weight)


def push_sum_mesh(values: Any, *, axis_sizes: dict[str, int], n_rounds: int | None = None,
                  t0: int = 0, self_share: float = 0.5, normalize: bool = True,
                  mesh=None) -> Any:
    """Push-Sum rounds on the mesh; returns this rank's estimate (the raw
    values when ``normalize`` is False). ``n_rounds=None`` runs one full
    exponential schedule (exact averaging); the schedule is rotated by
    ``t0`` so successive steps continue the hop sequence. ``mesh``: a
    :class:`~repro_torch.core.mesh.Mesh`, by default one over
    ``axis_sizes`` on the world group."""
    sched = exponential_schedule(axis_sizes)
    if not sched:
        return values
    mesh = Mesh(axis_sizes) if mesh is None else mesh
    total = len(sched) if n_rounds is None else int(n_rounds)
    leaves = tree_leaves(values)
    state = PushSumState(values=values, weight=torch.ones(
        (), dtype=torch.float32, device=leaves[0].device if leaves else None))
    for k in range(total):
        state = push_sum_round(state, sched[(t0 + k) % len(sched)], self_share=self_share,
                               mesh=mesh)
    return state.estimate() if normalize else state.values
