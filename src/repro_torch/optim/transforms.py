"""Gradient transformations (optax-style), the reference's
``repro.optim.transforms`` on trees of tensors.

Every transform is an ``(init, update)`` pair over trees (nested dicts,
lists and tuples of tensors); ``chain`` composes them; ``apply_updates``
applies the final update to the parameters. Nothing is updated in place:
each update returns new tensors, as the reference's pure functions do, and
the arithmetic is the reference's, operation for operation (``torch.optim``'s
AdamW places ε and the decay elsewhere). The step counters are int32
tensors; a leading replica axis on every leaf and counter (gossip training)
broadcasts through every transform, a counter of shape (G,) scaling the
leaves' leading axis.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.optim.schedules import constant

Pytree = Any
Schedule = Callable[[torch.Tensor], torch.Tensor]

__all__ = [
    "GradientTransformation",
    "chain",
    "scale",
    "scale_by_schedule",
    "clip_by_global_norm",
    "sgd",
    "adamw",
    "apply_updates",
    "global_norm",
    "tree_map",
    "tree_leaves",
    "AdamState",
    "MomentumState",
    "ScheduleState",
]


def tree_map(fn, tree: Pytree, *rest: Pytree) -> Pytree:
    """``fn`` over the tensor leaves of ``tree`` and the matching leaves of
    ``rest`` (same structure): nested dicts, lists, tuples and NamedTuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree: Pytree) -> list:
    """The tensor leaves of ``tree``, dict values by sorted key (the
    reference's ``jax.tree.leaves`` order)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def _lead(s: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A scalar or a per-replica (G,) tensor, shaped to scale ``x``'s leading axis."""
    return s.reshape(s.shape + (1,) * (x.dim() - s.dim()))


class GradientTransformation(NamedTuple):
    init: Callable[[Pytree], Pytree]
    update: Callable[[Pytree, Pytree, Pytree], tuple[Pytree, Pytree]]
    # update(grads, state, params) -> (updates, new_state)


def chain(*transforms: GradientTransformation) -> GradientTransformation:
    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(grads, state, params):
        new_state = []
        for t, s in zip(transforms, state):
            grads, s = t.update(grads, s, params)
            new_state.append(s)
        return grads, tuple(new_state)

    return GradientTransformation(init, update)


def global_norm(tree: Pytree, lead: int = 0) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32; with ``lead`` = 1
    one norm for each index of the leaves' leading (replica) axis, shape (G,)."""
    sums = [_sum_from(torch.square(leaf.float()), lead) for leaf in tree_leaves(tree)]
    return torch.sqrt(sum(sums[1:], sums[0]))


def _sum_from(x: torch.Tensor, lead: int) -> torch.Tensor:
    """The sum over every dim of ``x`` from ``lead`` on (no reshape, which a
    DTensor sharded on an inner dim cannot take)."""
    dims = tuple(range(lead, x.ndim))
    return torch.sum(x, dim=dims) if dims else x


def clip_by_global_norm(max_norm: float, lead: int = 0) -> GradientTransformation:
    """Scale the gradients by ``min(1, max_norm / norm)``; ``lead`` = 1 clips
    each replica of a leading axis by its own norm (the reference's vmap)."""
    def init(params):
        return ()

    def update(grads, state, params):
        norm = global_norm(grads, lead)
        scale_ = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
        return tree_map(lambda g: (g.float() * _lead(scale_, g)).to(g.dtype), grads), state

    return GradientTransformation(init, update)


def scale(factor: float) -> GradientTransformation:
    def init(params):
        return ()

    def update(grads, state, params):
        return tree_map(lambda g: g * factor, grads), state

    return GradientTransformation(init, update)


class ScheduleState(NamedTuple):
    step: torch.Tensor


def _zero_step(params: Pytree) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=tree_leaves(params)[0].device)


def scale_by_schedule(schedule: Schedule) -> GradientTransformation:
    def init(params):
        return ScheduleState(step=_zero_step(params))

    def update(grads, state, params):
        lr = schedule(state.step)
        out = tree_map(lambda g: g * _lead(lr, g).to(g.dtype), grads)
        return out, ScheduleState(step=state.step + 1)

    return GradientTransformation(init, update)


class MomentumState(NamedTuple):
    momentum: Pytree


def _as_schedule(learning_rate: float | Schedule) -> Schedule:
    return learning_rate if callable(learning_rate) else constant(learning_rate)


def sgd(learning_rate: float | Schedule, momentum: float = 0.0,
        nesterov: bool = False) -> GradientTransformation:
    lr_sched = _as_schedule(learning_rate)

    def init(params):
        mom = tree_map(torch.zeros_like, params) if momentum else ()
        return (MomentumState(mom), ScheduleState(_zero_step(params)))

    def update(grads, state, params):
        mstate, sstate = state
        if momentum:
            new_m = tree_map(lambda m, g: momentum * m + g, mstate.momentum, grads)
            eff = (tree_map(lambda m, g: momentum * m + g, new_m, grads)
                   if nesterov else new_m)
            mstate = MomentumState(new_m)
        else:
            eff = grads
        lr = lr_sched(sstate.step)
        updates = tree_map(lambda g: (-_lead(lr, g) * g.float()).to(g.dtype), eff)
        return updates, (mstate, ScheduleState(sstate.step + 1))

    return GradientTransformation(init, update)


class AdamState(NamedTuple):
    step: torch.Tensor
    mu: Pytree
    nu: Pytree


def adamw(
    learning_rate: float | Schedule,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
) -> GradientTransformation:
    """AdamW with float32 moments whatever the parameters' type."""
    lr_sched = _as_schedule(learning_rate)

    def init(params):
        f32 = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
        return AdamState(step=_zero_step(params), mu=tree_map(f32, params),
                         nu=tree_map(f32, params))

    def update(grads, state, params):
        step = state.step + 1
        g32 = tree_map(lambda g: g.float(), grads)
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state.mu, g32)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * g * g, state.nu, g32)
        bc1 = 1 - b1 ** step.float()
        bc2 = 1 - b2 ** step.float()
        lr = lr_sched(state.step)

        def upd(m, v, p):
            u = (m / _lead(bc1, m)) / (torch.sqrt(v / _lead(bc2, v)) + eps)
            if weight_decay:
                u = u + weight_decay * p.float()
            return (-_lead(lr, u) * u).to(p.dtype)

        updates = tree_map(upd, mu, nu, params)
        return updates, AdamState(step=step, mu=mu, nu=nu)

    return GradientTransformation(init, update)


def apply_updates(params: Pytree, updates: Pytree) -> Pytree:
    return tree_map(lambda p, u: (p.float() + u.float()).to(p.dtype), params, updates)
