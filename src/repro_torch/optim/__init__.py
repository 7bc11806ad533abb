"""Optimizer substrate of the port: the reference's ``repro.optim``, on
trees (nested dicts, lists and tuples) of tensors, with no ``torch.optim``.

A ``GradientTransformation`` is an ``(init, update)`` pair as in the
reference; ``chain`` composes them and ``apply_updates`` applies the final
update. State is a plain tree of tensors, so it checkpoints and gossips like
the parameters.
"""
from repro_torch.optim.transforms import (  # noqa: F401
    AdamState,
    GradientTransformation,
    MomentumState,
    ScheduleState,
    adamw,
    apply_updates,
    chain,
    clip_by_global_norm,
    global_norm,
    scale,
    scale_by_schedule,
    sgd,
    tree_leaves,
    tree_map,
)
from repro_torch.optim.schedules import constant, cosine_warmup, pegasos_schedule  # noqa: F401
