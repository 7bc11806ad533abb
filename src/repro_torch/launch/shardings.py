"""Parameter, batch and cache partition specs, the port of
``repro.launch.shardings``, and the DTensors they describe.

Divisibility-aware: every preferred mesh-axis placement is checked against
the actual dim size and falls back to replication when it does not divide,
so one rule table serves every architecture on any mesh.

Default layout (single pod): tensor parallel over `model`, FSDP over `data`
(ZeRO-3 style: 405B parameters and AdamW moments shard over all 256 ranks).
The gossip-consensus variant stacks a leading replica axis on every leaf,
sharded over the gossip axis (`pod` on the multi-pod mesh); see
``launch/steps.py``.

The port's parameters are a flat ``{name: tensor}`` (``state_dict`` keys);
a name's dots read as the reference's key-path slashes, so the reference's
rule table applies as it is. The port's blocks are a flat list with no
layer-repeat axis, so the reference's leading ``None`` for ``stages`` is not
there. :func:`distribute` builds the DTensors a spec tree describes.
"""
from __future__ import annotations

import re
from typing import Any

import torch

from repro_torch.configs.shapes import InputShape
from repro_torch.models.attention import KVCache
from repro_torch.models.config import ModelConfig
from repro_torch.models.rglru import RGLRUState
from repro_torch.models.rwkv6 import RWKV6State
from repro_torch.sharding.api import PartitionSpec as P
from repro_torch.sharding.api import mesh_axis_sizes, placements, shard_range

Pytree = Any

__all__ = ["param_specs", "batch_specs", "cache_spec_tree", "named", "ShardingPlan",
           "distribute", "local_bytes"]


def _fits(dim: int, mesh, axes) -> bool:
    if axes is None:
        return True
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    sizes = mesh_axis_sizes(mesh)
    prod = 1
    for a in axes:
        prod *= sizes[a]
    return dim % prod == 0


def _spec(mesh, shape: tuple[int, ...], *wants) -> P:
    """wants[i] = preferred mesh axis (or tuple) for dim i; falls back to the
    largest prefix of the axis tuple that divides, then to None."""
    entries = []
    used: set[str] = set()
    for dim, want in zip(shape, wants):
        placed = None
        if want is not None:
            cands = (want,) if isinstance(want, str) else tuple(want)
            # try longest prefix first: ("model","data") -> both, then model only
            for k in range(len(cands), 0, -1):
                pre = tuple(a for a in cands[:k] if a not in used)
                if pre and _fits(dim, mesh, pre):
                    placed = pre if len(pre) > 1 else pre[0]
                    used.update(pre)
                    break
        entries.append(placed)
    return P(*entries)


# ----------------------------------------------------------------- params

_PARAM_RULES: list[tuple[str, tuple]] = [
    # (path regex, wants per dim) — first match wins
    (r"embed/table$",        ("model", "data")),       # (V, D) vocab-parallel + fsdp
    (r"attn/wq$",            ("data", "model", None)),  # (D, H, Dh)
    (r"attn/w[kv]$",         (("model", "data"), None, None)),  # (D, Hkv, Dh) row-parallel
    (r"attn/wo$",            ("model", None, "data")),  # (H, Dh, D)
    (r"ch/router$",          ("data", None)),           # (D, E)
    (r"shared/w[ig]/w$",     ("data", "model")),        # moe shared-expert mlp (D, F)
    (r"shared/wo/w$",        ("model", "data")),
    (r"ch/w[ig]$",           (None, "data", "model")),  # moe (E, D, F) TP-in-expert
    (r"ch/wo$",              (None, "model", "data")),  # moe (E, F, D)
    (r"ch/w[ig]/w$",         ("data", "model")),        # dense mlp (D, F)
    (r"ch/wo/w$",            ("model", "data")),        # dense mlp (F, D)
    (r"rglru/w_(gate_in|rnn_in)$", ("data", "model")),  # (D, Drnn)
    (r"rglru/w_[ax]$",       (None, "model")),          # (Drnn, Drnn)
    (r"rglru/conv_w$",       (None, "model")),
    (r"rglru/(lambda|b_[ax])$", ("model",)),
    (r"rglru/w_out$",        ("model", "data")),
    (r"rwkv/w_[rkvg]$",      ("data", "model")),        # (D, D)
    (r"rwkv/w_o$",           ("model", "data")),
    (r"rwkv/cm_w[ir]$",      ("data", "model")),
    (r"rwkv/cm_wo$",         ("model", "data")),
    (r"rwkv/decay_lora_a$",  ("data", None)),
    (r"rwkv/decay_lora_b$",  (None, "model")),
    (r"rwkv/bonus_u$",       (None, None)),
    (r"head/w$",             ("data", "model")),        # (D, V)
]


def _path_str(name: str) -> str:
    """A flat parameter name as the reference's key path."""
    return name.replace(".", "/")


def _strip_axis(wants: tuple, axis: str) -> tuple:
    out = []
    for w in wants:
        if w is None:
            out.append(None)
            continue
        ws = tuple(a for a in ((w,) if isinstance(w, str) else w) if a != axis)
        out.append(ws[0] if len(ws) == 1 else (ws or None))
    return tuple(out)


def param_specs(mesh, params: dict, *, gossip: bool = False, replica_axis: str = "pod",
                mode: str = "fsdp") -> dict[str, P]:
    """``{name: PartitionSpec}`` for a flat parameter dict (tensors or
    anything with ``.shape``).

    ``gossip=True`` expects one more leading axis on *every* leaf, the
    divergent-replica axis, sharded on ``replica_axis``.

    ``mode``: "fsdp" shards weight dims over `data` too (ZeRO-3, required for
    100B+ models); "zero1" keeps weights TP-only (replicated over `data`),
    and the optimizer moments take the fsdp specs instead
    (``steps.train_state_specs``).
    """
    names = set(mesh_axis_sizes(mesh))

    def leaf_spec(name: str, shape: tuple) -> P:
        ps = _path_str(name)
        lead = [replica_axis if replica_axis in names else None] if gossip else []
        core_shape = shape[len(lead):]
        for rx, wants in _PARAM_RULES:
            if re.search(rx, ps):
                if gossip:  # the replica axis is taken by the leading dim
                    wants = _strip_axis(wants, replica_axis)
                if mode == "zero1":
                    wants = _strip_axis(wants, "data")
                core = _spec(mesh, core_shape, *wants)
                break
        else:
            core = P(*([None] * len(core_shape)))
        return P(*lead, *core)

    return {name: leaf_spec(name, tuple(t.shape)) for name, t in params.items()}


# ------------------------------------------------------------ batch/cache

def batch_specs(mesh, cfg: ModelConfig, shape: InputShape, *,
                gossip_stacked: bool = False, replica_axis: str = "pod") -> dict[str, P]:
    """Specs for the input batch dict (``input_specs``' layouts)."""
    names = tuple(mesh_axis_sizes(mesh))
    batch_axes = tuple(a for a in ("pod", "data") if a in names)
    if gossip_stacked:
        batch_axes = tuple(a for a in batch_axes if a != replica_axis)
    bspec = batch_axes if len(batch_axes) > 1 else (batch_axes[0] if batch_axes else None)

    def vec(*extra):
        lead = (replica_axis,) if gossip_stacked and replica_axis in names else ()
        return P(*lead, bspec, *extra)

    out = {"tokens": vec(None), "targets": vec(None)}
    if cfg.embed_kind == "patches":
        out["patch_embeds"] = vec(None, None)
    if cfg.embed_kind == "frames":
        out = {"frames": vec(None, None), "targets": vec(None), "mask": vec(None)}
    return out


def cache_spec_tree(mesh, caches: list) -> list:
    """Specs for the port's per-layer decode caches (``Model.init_cache``).

    Attention KV (B, S_cache, Hkv, Dh): batch on `data` when divisible,
    cache sequence on `model` (flash-decode-style partial-softmax sharding;
    Hkv is too small to cover the axis). RWKV state S (B, H, n, n) takes the
    same rule; its H simply fails divisibility and replicates (state is KBs).
    Recurrent channel dims go on `model` when divisible: the RG-LRU carry
    (B, D) and conv tail (B, W-1, D), RWKV's shifted tokens (B, D). These
    are the reference's rules on its (R, ...) caches, the repeat axis
    dropped.
    """
    def spec(x, *wants):
        return _spec(mesh, tuple(x.shape), *wants)

    out = []
    for c in caches:
        if isinstance(c, KVCache):
            out.append(KVCache(*(spec(t, "data", "model", None, None) for t in c)))
        elif isinstance(c, RGLRUState):
            out.append(RGLRUState(h=spec(c.h, "data", "model"),
                                  conv=spec(c.conv, "data", None, "model")))
        elif isinstance(c, RWKV6State):
            out.append(RWKV6State(S=spec(c.S, "data", "model", None, None),
                                  x_prev_tm=spec(c.x_prev_tm, "data", "model"),
                                  x_prev_cm=spec(c.x_prev_cm, "data", "model")))
        else:
            raise TypeError(f"unknown cache entry {type(c).__name__}")
    return out


def _map(fn, tree: Pytree, specs: Pytree) -> Pytree:
    """``fn(leaf, spec)`` over the tensor leaves of ``tree`` and the matching
    PartitionSpecs of ``specs`` (same structure: dicts, NamedTuples, lists,
    tuples)."""
    if isinstance(specs, P):
        return fn(tree, specs)
    if isinstance(tree, dict):
        return {k: _map(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, v, s) for v, s in zip(tree, specs)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, s) for v, s in zip(tree, specs))
    raise TypeError(f"no spec for a leaf of type {type(tree).__name__}")


def named(mesh, spec_tree: Pytree) -> Pytree:
    """The DTensor placements on ``mesh`` of every spec of ``spec_tree``."""
    def walk(s):
        if isinstance(s, P):
            return placements(mesh, s)
        if isinstance(s, dict):
            return {k: walk(v) for k, v in s.items()}
        if isinstance(s, tuple) and hasattr(s, "_fields"):
            return type(s)(*(walk(v) for v in s))
        return type(s)(walk(v) for v in s)
    return walk(spec_tree)


def _is_fake(t: torch.Tensor) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(t, FakeTensor) or t.device.type == "meta"


def _local_shape(shape: tuple, mesh, pl: tuple) -> tuple:
    """This rank's shard shape under placements ``pl``."""
    return tuple(shard_range(mesh, pl, d, n)[1] for d, n in enumerate(shape))


def distribute(mesh, tree: Pytree, specs: Pytree) -> Pytree:
    """DTensors on ``mesh`` of every tensor leaf of ``tree`` with the
    placements of its spec: ``distribute_tensor`` of a real tensor (every
    rank holds the same whole tensor), and for a fake or meta tensor a new
    local shard of the shard's shape and the tensor's dtype and device,
    wrapped by ``DTensor.from_local`` with the global shape and strides (a
    fake tensor cannot be scattered)."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    def one(t: torch.Tensor, spec: P):
        pl = placements(mesh, spec)
        if not _is_fake(t):
            return distribute_tensor(t, mesh, pl)
        local = t.new_empty(_local_shape(tuple(t.shape), mesh, pl))
        return DTensor.from_local(local, mesh, pl, run_check=False, shape=t.shape,
                                  stride=t.stride())

    return _map(one, tree, specs)


def local_bytes(tree: Pytree) -> int:
    """Bytes of this rank's shards of the tensor leaves of ``tree`` (whole
    tensors for plain ones)."""
    from torch.distributed.tensor import DTensor

    if isinstance(tree, dict):
        return sum(local_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(local_bytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        t = tree.to_local() if isinstance(tree, DTensor) else tree
        return t.numel() * t.element_size()
    return 0


class ShardingPlan:
    """Bundle of spec trees for one (arch, shape, mesh, consensus) combo."""

    def __init__(self, mesh, params: Pytree, batch: Pytree, opt: Pytree | None = None,
                 cache: Pytree | None = None):
        self.mesh = mesh
        self.params = params
        self.batch = batch
        self.opt = opt
        self.cache = cache
