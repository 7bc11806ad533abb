"""Logical-axis sharding on ``DeviceMesh`` and DTensor, the port of
``repro.sharding.api``: model code names axes ("batch", "embed", ...);
launch code binds them to mesh axes and activates the binding around a step.

``constrain(x, axes)`` is the identity outside an active binding and on a
plain tensor, so the same model code runs on one device (tests, the card)
and on a mesh of DTensors unchanged. On a DTensor it redistributes ``x`` to
the spec the rules give, after the reference's rank alignment and
divisibility drop (a mesh axis whose size does not divide the dim is
dropped: batch 1 never shards).

A spec here is the port's own :class:`PartitionSpec` (a tuple: one entry a
tensor dim, each ``None``, a mesh axis name or a tuple of names), and
:func:`placements` maps it onto DTensor's one placement a mesh dim. An
entry naming two mesh axes, such as ``("model", "data")``, gives the
reference's local shapes; the order of the elements within that dim follows
DTensor's mesh-dim order (``data`` before ``model`` on the production
meshes), not the entry's.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Callable, Sequence

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

__all__ = ["PartitionSpec", "AxisRules", "activate", "constrain", "relayout", "logical_to_spec",
           "param_spec", "current_rules", "placements", "rows_local", "split_ready", "grad_like",
           "shard_range", "vocab_rows", "gathered",
           "mesh_axis_sizes"]

_state = threading.local()


class PartitionSpec(tuple):
    """One entry a tensor dim: ``None``, a mesh axis name, or a tuple of names."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


def mesh_axis_sizes(mesh) -> dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` or of a mesh with the
    reference's interface (``axis_names``, ``devices.shape``)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def _names(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


class AxisRules:
    """logical axis name -> mesh axis (or tuple of mesh axes, or None)."""

    def __init__(self, mesh, rules: dict[str, Any]):
        self.mesh = mesh
        self.rules = dict(rules)

    def spec(self, logical_axes: Sequence[str | None]) -> PartitionSpec:
        entries = []
        used: set[str] = set()
        for ax in logical_axes:
            m = self.rules.get(ax) if ax is not None else None
            # a mesh axis may appear at most once in a spec
            ms = tuple(a for a in _names(m) if a not in used)
            used.update(ms)
            entries.append(ms if len(ms) > 1 else (ms[0] if ms else None))
        return PartitionSpec(*entries)


def current_rules() -> AxisRules | None:
    return getattr(_state, "rules", None)


@contextlib.contextmanager
def activate(rules: AxisRules):
    prev = getattr(_state, "rules", None)
    _state.rules = rules
    try:
        yield
    finally:
        _state.rules = prev


def placements(mesh, spec: Sequence) -> tuple:
    """DTensor placements on ``mesh`` for ``spec``: ``Shard(i)`` on each mesh
    dim of more than one rank that entry i names, ``Replicate()`` on the
    others. Mesh axes the
    spec names that ``mesh`` lacks are ignored (a sub-mesh's caller handles
    them, as the reference's ``spmd_axis_name`` does)."""
    out = []
    for i, name in enumerate(mesh.mesh_dim_names):
        dims = [d for d, entry in enumerate(spec) if name in _names(entry)]
        # a mesh dim of one rank holds the whole dim either way; Replicate
        # keeps DTensor from picking shardings of it that later reshapes refuse
        out.append(Shard(dims[0]) if dims and mesh.size(i) > 1 else Replicate())
    return tuple(out)


def _fitted_spec(rules: AxisRules, shape: tuple, logical_axes: Sequence[str | None],
                 sizes: dict[str, int]) -> PartitionSpec:
    """The rules' spec for ``logical_axes`` aligned to ``shape``'s rank, each
    entry cut to the mesh axes (of ``sizes``) that divide its dim in turn."""
    axes = list(logical_axes)
    if len(axes) > len(shape):
        axes = axes[len(axes) - len(shape):]
    elif len(axes) < len(shape):
        axes = [None] * (len(shape) - len(axes)) + axes
    entries = []
    for dim, entry in zip(shape, rules.spec(axes)):
        prod, kept = 1, []
        for a in _names(entry):
            if a in sizes and dim % (prod * sizes[a]) == 0:
                kept.append(a)
                prod *= sizes[a]
        entries.append(tuple(kept) if len(kept) > 1 else (kept[0] if kept else None))
    return PartitionSpec(*entries)


def _is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


def constrain(x: torch.Tensor, logical_axes: Sequence[str | None]) -> torch.Tensor:
    """``x`` redistributed to the active rules' spec on its own mesh, and
    its gradient too (as the transpose of the reference's
    ``with_sharding_constraint`` is one); the identity outside ``activate``
    and on a plain tensor."""
    r = current_rules()
    if r is None or not _is_dtensor(x):
        return x
    mesh = x.device_mesh
    spec = _fitted_spec(r, tuple(x.shape), logical_axes, mesh_axis_sizes(mesh))
    want = placements(mesh, spec)
    if tuple(x.placements) != want:
        x = x.redistribute(mesh, want)
    return grad_like(x)


def relayout(x: torch.Tensor, logical_axes: Sequence[str | None]) -> torch.Tensor:
    """``x`` redistributed to the active rules' spec, its gradient left to
    DTensor's own backward: the reverse move into ``x``'s layout, partial
    sums reduced there. Sequence parallelism's pair: a gather of the
    sequence before a tensor-parallel product (its backward a
    reduce-scatter), and the scatter of the product's partial sums back
    onto the sequence (its backward the gather). The identity outside
    ``activate`` and on a plain tensor."""
    r = current_rules()
    if r is None or not _is_dtensor(x):
        return x
    mesh = x.device_mesh
    want = placements(mesh, _fitted_spec(r, tuple(x.shape), logical_axes,
                                         mesh_axis_sizes(mesh)))
    return x if tuple(x.placements) == want else x.redistribute(mesh, want)


def rows_local(fn: Callable, row_args: Sequence, whole_args: Sequence = (), *,
               n_out: int = 1) -> Any:
    """``fn(*row_args, *whole_args)`` for work that is independent per
    leading (batch) row, such as MoE routing, dispatch and combine, which
    DTensor has no sharding rules for. On plain tensors a call. On DTensors
    each rank runs ``fn`` on its own rows (``local_map``): ``row_args`` and
    every output sharded on the batch's mesh axes of the active rules (when
    they divide the rows), ``whole_args`` replicated. Nothing is gathered but
    the replicated arguments. ``n_out``: the number of tensors ``fn``
    returns (a tuple when above 1)."""
    args = (*row_args, *whole_args)
    dt = next((a for a in args if _is_dtensor(a)), None)
    if dt is None:
        return fn(*args)

    mesh = dt.device_mesh
    rules = current_rules() or AxisRules(mesh, {})
    sizes = mesh_axis_sizes(mesh)
    n_rows = row_args[0].shape[0]
    row = placements(mesh, _fitted_spec(rules, (n_rows,), ("batch",), sizes))
    whole = tuple(Replicate() for _ in mesh.mesh_dim_names)
    # a replicated argument's gradient sums every rank's rows
    whole_grad = tuple(Partial() if isinstance(p, Shard) else Replicate() for p in row)
    in_pl = [row] * len(row_args) + [whole] * len(whole_args)
    in_grad = [row] * len(row_args) + [whole_grad] * len(whole_args)
    return local_map(fn, out_placements=(row,) * n_out, in_placements=in_pl,
                     in_grad_placements=in_grad, redistribute_inputs=True, device_mesh=mesh)(*args)


def shard_range(mesh, pl: Sequence, dim: int, size: int) -> tuple[int, int]:
    """(start, length) of this rank's shard of ``dim`` (of ``size``):
    DTensor's chunks of ceil(size / n), the last ones short or empty, mesh
    dim by mesh dim."""
    coord, start = mesh.get_coordinate(), 0
    for i, p in enumerate(pl):
        if isinstance(p, Shard) and p.dim == dim:
            chunk = -(-size // mesh.size(i))
            start += coord[i] * chunk
            size = max(0, min(chunk, size - coord[i] * chunk))
    return start, size


def vocab_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` (rows of a (V, D) table) for a DTensor table sharded
    on its vocab dim: each rank looks up the ids that fall in its rows (zero
    elsewhere) and the vocab mesh dims sum them (a ``Partial`` result), the
    table's other dims gathered; the ids keep their own sharding. On plain
    tensors ``F.embedding``."""
    import torch.nn.functional as F

    if not _is_dtensor(table):
        return F.embedding(ids, table)

    mesh = table.device_mesh
    vocab = [isinstance(p, Shard) and p.dim == 0 for p in table.placements]
    ids_pl = tuple(ids.placements) if _is_dtensor(ids) else (Replicate(),) * len(vocab)
    ids_in = tuple(Replicate() if v else p for v, p in zip(vocab, ids_pl))
    table_in = tuple(Shard(0) if v else Replicate() for v in vocab)
    out = tuple(Partial() if v else p for v, p in zip(vocab, ids_in))
    table_grad = tuple(Shard(0) if v else (Partial() if isinstance(p, Shard) else Replicate())
                       for v, p in zip(vocab, ids_in))
    offset, _ = shard_range(mesh, table_in, 0, table.shape[0])

    def local(t, x):
        idx = x.long() - offset
        inside = (idx >= 0) & (idx < t.shape[0])
        got = F.embedding(idx.clamp(0, t.shape[0] - 1), t)
        return got * inside[..., None].to(got.dtype)

    return local_map(local, out_placements=(out,), in_placements=(table_in, ids_in),
                     in_grad_placements=(table_grad, ids_in), redistribute_inputs=True,
                     device_mesh=mesh)(table, ids)


def gathered(w: torch.Tensor, keep: Sequence[int]) -> torch.Tensor:
    """A DTensor weight gathered on every dim but ``keep`` (FSDP's gather
    before use: the heads stay sharded, the contraction dim does not), so
    DTensor does not move its head dim onto a mesh axis the heads cannot
    fill; plain tensors as they are."""
    if not _is_dtensor(w):
        return w

    keep = {d % w.ndim for d in keep}
    pl = tuple(Replicate() if isinstance(p, Shard) and p.dim not in keep else p
               for p in w.placements)
    return w if pl == tuple(w.placements) else w.redistribute(w.device_mesh, pl)


def split_ready(x: torch.Tensor, dim: int, parts: int) -> torch.Tensor:
    """``x`` ready to have ``dim`` split into (parts, size / parts): a
    DTensor whose mesh dims sharding ``dim`` do not divide ``parts`` (40
    RWKV heads on a 16-wide axis) is gathered on ``dim`` first, which the
    dry-run's collectives show; anything else as it is."""
    if not _is_dtensor(x):
        return x

    dim %= x.ndim
    mesh, pl = x.device_mesh, tuple(x.placements)
    n = 1
    for i, p in enumerate(pl):
        if isinstance(p, Shard) and p.dim == dim:
            n *= mesh.size(i)
    if parts % n == 0:
        return x
    return x.redistribute(mesh, tuple(Replicate() if isinstance(p, Shard) and p.dim == dim
                                      else p for p in pl))


class _GradLike(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.mesh, ctx.placements = x.device_mesh, tuple(x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != ctx.placements:
            g = g.redistribute(ctx.mesh, ctx.placements)
        return g


def grad_like(x: torch.Tensor) -> torch.Tensor:
    """``x``, whose gradient is redistributed to ``x``'s own placements in
    the backward pass (DTensor otherwise lets a broadcast gradient pick its
    own layout, and the ops after it gather to meet it); plain tensors as
    they are."""
    return _GradLike.apply(x) if _is_dtensor(x) else x


def logical_to_spec(rules: AxisRules, logical_axes: Sequence[str | None]) -> PartitionSpec:
    return rules.spec(logical_axes)


def param_spec(rules: AxisRules, path: str, shape: tuple[int, ...]) -> PartitionSpec:
    """Fallback param spec derivation — launch.shardings assigns real specs;
    this exists for ad-hoc tools."""
    return PartitionSpec(*([None] * len(shape)))
