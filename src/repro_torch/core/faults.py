"""Fault injection for gossip training: the paper's §5 resilience to node
failures. Port of ``repro.core.faults``.

A :class:`FaultPlan` describes one fault regime:

* ``drop_prob``: per-round, per-directed-link failure probability on every
  off-diagonal share of the mixing matrix;
* ``drop``: ``"link"`` (the sender detects the failure and keeps the share
  on its own diagonal, so every row still sums to 1 and Push-Sum mass is
  conserved) or ``"message"`` (the share vanishes in flight; value and
  weight mass vanish together, so every surviving ratio stays a convex
  combination);
* ``dead_nodes``: crashed nodes; a dead row collapses to e_d and every link
  into a dead node fails;
* ``seed``: the failure stream's seed.

The failure masks are injected randomness, as minibatch ids and mixing
matrices are: :func:`apply_faults` takes an (…, m, m) bool mask beside the
clean matrix. The port's own masks come from :func:`keyed_fail_masks`:
the reference's masks, ``jax.random.bernoulli`` under the key of (t, r),
drawn bit for bit by ``core.counter_rng``, so a run split into other
chunks, or resumed, draws the same failures, on either device.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import counter_rng as crng

__all__ = ["FaultPlan", "DROP_MODES", "validate_plan", "dead_mask", "apply_faults",
           "faulty_rounds", "keyed_fail_masks", "fault_stream_key", "round_fail_key",
           "count_drops", "count_drops_node"]

DROP_MODES = ("link", "message")
# the reference's salt of the failure stream (repro.core.faults._FAULT_SALT)
_FAULT_SALT = 0x0FA17


class FaultPlan(NamedTuple):
    """One fault regime for gossip training; normalise with
    :func:`validate_plan` before use."""

    drop_prob: float = 0.0       # per-round per-link failure probability
    drop: str = "link"           # "link" (sender keeps) | "message" (lost)
    dead_nodes: tuple[int, ...] = ()  # permanently crashed node ids
    seed: int = 0                # the failure stream's seed


def validate_plan(plan: FaultPlan, m: int) -> FaultPlan:
    """Check a plan against an m-node network and return it normalised
    (sorted unique dead tuple, plain Python scalars)."""
    if plan.drop not in DROP_MODES:
        raise ValueError(f"unknown drop mode {plan.drop!r}; expected one of {DROP_MODES}")
    p = float(plan.drop_prob)
    if not (0.0 <= p < 1.0):
        raise ValueError(f"drop_prob must lie in [0, 1), got {p}")
    dead = tuple(sorted({int(d) for d in plan.dead_nodes}))
    if dead and (dead[0] < 0 or dead[-1] >= m):
        raise ValueError(f"dead_nodes must lie in [0, {m}), got {dead}")
    if len(dead) >= m:
        raise ValueError(f"all {m} nodes dead — nothing left to train")
    return FaultPlan(drop_prob=p, drop=str(plan.drop), dead_nodes=dead, seed=int(plan.seed))


def dead_mask(plan: FaultPlan, m: int, device: torch.device | str | None = None) -> torch.Tensor:
    """(m,) bool, True on crashed nodes (built by fills on the device: no
    copy from the host)."""
    mask = torch.zeros((m,), dtype=torch.bool, device=device)
    for node in plan.dead_nodes:
        mask[node] = True
    return mask


def _fail_with_dead(fail: torch.Tensor, dead: torch.Tensor) -> torch.Tensor:
    """Failures plus every link into a dead node, never a diagonal share."""
    m = dead.shape[0]
    eye = torch.eye(m, dtype=torch.bool, device=fail.device)
    return (fail | dead[None, :]) & ~eye


def apply_faults(B: torch.Tensor, fail: torch.Tensor, plan: FaultPlan, *,
                 dead: torch.Tensor | None = None) -> torch.Tensor:
    """Faulty mixing matrices: dead rows collapse to e_d, then every
    off-diagonal share where ``fail`` is True fails, as does every share into
    a dead node. ``"link"`` returns lost shares to the sender's diagonal
    (rows still sum to 1); ``"message"`` drops them. Diagonal shares never
    fail. ``B`` (…, m, m) float, ``fail`` (…, m, m) bool; ``dead`` the plan's
    :func:`dead_mask` on B's device when the caller holds it."""
    m = B.shape[-1]
    B = B.to(torch.float32)
    dead = dead_mask(plan, m, B.device) if dead is None else dead
    eye = torch.eye(m, dtype=torch.float32, device=B.device)
    B = torch.where(dead[:, None], eye, B)  # dead sender: mass frozen on its diagonal
    fail = _fail_with_dead(fail, dead)
    lost = torch.where(fail, B, 0.0)
    B = torch.where(fail, 0.0, B)
    if plan.drop == "link":
        B = B + eye * lost.sum(dim=-1, keepdim=True)
    return B


def faulty_rounds(Bs: torch.Tensor, fails: torch.Tensor, plan: FaultPlan, *,
                  dead: torch.Tensor | None = None) -> torch.Tensor:
    """A clean (…, R, m, m) round stack under its (…, R, m, m) failure masks;
    the result feeds ``mix_rounds`` or ``collapse_rounds``."""
    return apply_faults(Bs, fails, plan, dead=dead)


def keyed_fail_masks(plan: FaultPlan, t0: int, n: int, R: int, m: int,
                     device: torch.device | str | None = None) -> torch.Tensor:
    """The failure masks of iterations t0 … t0+n−1, (n, R, m, m) bool: the
    reference's ``jax.random.bernoulli(round_fail_key(plan, t, r), p, (m, m))``
    bit for bit, its key ``fold_in(fold_in(fold_in(PRNGKey(seed), salt), t), r)``."""
    stream = crng.fold_in(crng.prng_key(plan.seed), _FAULT_SALT)
    t = torch.arange(n, dtype=torch.int64, device=device) + t0
    key = crng.fold_in(stream, t[:, None, None])
    key = crng.fold_in(key, torch.arange(R, dtype=torch.int64, device=device)[None, :, None])
    cells = torch.arange(m * m, dtype=torch.int64, device=device)[None, None, :]
    return crng.bernoulli(key, cells, plan.drop_prob).view(n, R, m, m)


def fault_stream_key(plan: FaultPlan) -> tuple:
    """Base key of the plan's failure stream, ``fold_in(PRNGKey(seed), salt)``."""
    return crng.fold_in(crng.prng_key(plan.seed), _FAULT_SALT)


def round_fail_key(plan: FaultPlan, t, r) -> tuple:
    """Key of the failure draw at (iteration t, gossip round r): the
    reference's ``round_fail_key``, from which the simulator's masks and the
    mesh step's per-node fail bits all derive. Python ints give a pair of
    ints (no device work); int64 tensors broadcast."""
    return crng.fold_in(crng.fold_in(fault_stream_key(plan), t), r)


def _real_drops(Bs: torch.Tensor, fails: torch.Tensor, plan: FaultPlan,
                dead: torch.Tensor | None) -> torch.Tensor:
    """Failures that destroy a real share: live-sender rows whose clean
    share is nonzero."""
    dead = dead_mask(plan, Bs.shape[-1], Bs.device) if dead is None else dead
    return _fail_with_dead(fails, dead) & ~dead[:, None] & (Bs != 0)


def count_drops(Bs: torch.Tensor, fails: torch.Tensor, plan: FaultPlan, *,
                dead: torch.Tensor | None = None) -> torch.Tensor:
    """Messages lost to faults in each iteration: the failures on the *clean*
    (…, R, m, m) stack that destroy a real share (live sender, nonzero clean
    share), summed over rounds and links; int64 of shape (…)."""
    return _real_drops(Bs, fails, plan, dead).sum(dim=(-3, -2, -1))


def count_drops_node(Bs: torch.Tensor, fails: torch.Tensor, plan: FaultPlan, *,
                     dead: torch.Tensor | None = None) -> torch.Tensor:
    """Per-sender twin of :func:`count_drops`: (…, m) int64 of the messages
    each node failed to deliver; sums exactly to :func:`count_drops`."""
    return _real_drops(Bs, fails, plan, dead).sum(dim=(-3, -1))
