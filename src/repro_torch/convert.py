"""Carry weights from the JAX package across into the port.

The inputs are anything ``numpy.asarray`` accepts (a JAX array converts
without this module importing JAX); the outputs are contiguous tensors on
the chosen device: float32 for the SVM weights, the source's type (float32,
bfloat16, integers) for model parameters and caches.

A transformer's params in the reference are a pytree whose ``stages`` hold
each block's arrays stacked over the stage's repeats; the port's ``Model``
holds one module per layer. ``model_params_to_torch`` unstacks them in the
reference's scan order, layer ``offset(stage) + r·len(kinds) + j`` for
repeat ``r`` of block ``j``, into the port's ``state_dict`` keys (the
reference's key path, dotted, under ``blocks.<layer>``), MoE channel
mixes, the VLM's embedding and the audio model's head (no embedding)
included; ``model_caches_to_torch`` does the same for decode caches.

A train state (``launch.steps``) converts both ways:
``train_state_to_torch`` carries the reference's (its params, the
optimizer's ``AdamState`` or ``MomentumState`` + ``ScheduleState`` and the
step; in gossip mode every leaf with its leading replica axis) across, and
``train_state_to_reference`` gives the port's state back in the
reference's layout as numpy arrays (stages stacked over repeats), which the
port's checkpoints store, so a train state written by either package
restores in the other.
"""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.models.attention import KVCache
from repro_torch.models.config import ModelConfig, compile_stages
from repro_torch.models.rglru import RGLRUState
from repro_torch.models.rwkv6 import RWKV6State
from repro_torch.models.transformer import Model
from repro_torch.optim import AdamState, MomentumState, ScheduleState

__all__ = ["result_to_torch", "weights_to_torch", "load_params", "model_params_to_torch",
           "model_to_torch", "model_caches_to_torch", "model_params_to_reference",
           "train_state_to_torch", "train_state_to_reference"]

_RESULT_FIELDS = ("W", "w_consensus", "W_avg")


def _tensor(a, device: torch.device) -> torch.Tensor:
    # a fresh contiguous copy: JAX hands out read-only buffers
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C")).to(device)


def weights_to_torch(w, device: torch.device | str | None = None) -> torch.Tensor:
    """A (d,) binary weight vector or (C, d) class-weight plane, as the
    float32 tensor ``ops.dense_predict`` takes."""
    if np.ndim(w) not in (1, 2):
        raise ValueError(f"weights must be (d,) or (C, d), got shape {np.shape(w)}")
    return _tensor(w, resolve_device(device))


def result_to_torch(result, device: torch.device | str | None = None) -> dict:
    """The weights of a ``GadgetResult``-like value (a mapping or an object
    with ``W``, ``w_consensus`` and ``W_avg``) as ``{name: tensor}``; a
    field that is None stays None, and one the value lacks (a
    ``MulticlassResult`` has no ``W_avg``) is None."""
    dev = resolve_device(device)
    out = {}
    for name in _RESULT_FIELDS:
        v = (result.get(name) if isinstance(result, Mapping)
             else getattr(result, name, None))
        out[name] = None if v is None else _tensor(v, dev)
    return out


def _array_tensor(a, device: torch.device) -> torch.Tensor:
    """A contiguous copy of ``a`` in its own type (bfloat16 kept as bfloat16)."""
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":  # numpy has no bfloat16 of its own
        return torch.from_numpy(arr.astype(np.float32)).to(device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(arr, order="C")).to(device)


def _flatten(tree, prefix: str = "") -> dict:
    """Leaves of nested mappings, keyed by their dotted key paths."""
    if isinstance(tree, Mapping):
        out = {}
        for key, sub in tree.items():
            out.update(_flatten(sub, f"{prefix}{key}."))
        return out
    return {prefix[:-1]: tree}


def load_params(module: torch.nn.Module, params) -> torch.nn.Module:
    """Load a reference param dict of one layer (nested mappings of arrays)
    into ``module``, whose parameters carry the same names; every key must
    match. Returns ``module``."""
    dev = next(module.parameters()).device
    state = {k: _array_tensor(v, dev) for k, v in _flatten(params).items()}
    module.load_state_dict(state, strict=True)
    return module


def _unstack(cfg: ModelConfig, stages: list) -> list:
    """Per-layer subtrees of per-stage trees stacked over repeats, in the
    reference's scan order: stage by stage, repeat by repeat, block by block."""
    layers = []
    for (kinds, repeats), stage in zip(compile_stages(cfg.n_layers, cfg.block_pattern), stages,
                                       strict=True):
        for r in range(repeats):
            for j in range(len(kinds)):
                layers.append((kinds[j], stage[f"blk{j}"], r))
    return layers


def _slice(tree, r: int, axis: int = 0):
    if isinstance(tree, Mapping):
        return {k: _slice(v, r, axis) for k, v in tree.items()}
    if hasattr(tree, "_fields"):  # a cache NamedTuple
        return type(tree)(*(_slice(v, r, axis) for v in tree))
    return np.take(np.asarray(tree), r, axis=axis)


def model_params_to_torch(cfg: ModelConfig, params: Mapping,
                          device: torch.device | str | None = None, *,
                          replicas: bool = False) -> dict:
    """The port's ``Model`` ``state_dict`` for the reference's params of ``cfg``
    (``embed`` and ``head`` where the config has them, ``final_norm`` and
    ``stages``). ``replicas``: every leaf carries a leading replica axis
    (gossip training), kept in front of each tensor."""
    dev = resolve_device(device)
    top = {k: v for k, v in params.items() if k != "stages"}
    state = {k: _array_tensor(v, dev) for k, v in _flatten(top).items()}
    for layer, (_, blk, r) in enumerate(_unstack(cfg, params["stages"])):
        for k, v in _flatten(_slice(blk, r, axis=int(replicas))).items():
            state[f"blocks.{layer}.{k}"] = _array_tensor(v, dev)
    return state


def _nest(flat: Mapping) -> dict:
    """Nested dicts of dotted keys (the inverse of ``_flatten``)."""
    out: dict = {}
    for key, v in flat.items():
        node = out
        *path, leaf = key.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = v
    return out


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().copy()


def model_params_to_reference(cfg: ModelConfig, state: Mapping, *,
                              replicas: bool = False) -> dict:
    """The reference's params of ``cfg`` (numpy leaves, stages stacked over
    repeats) for the port's ``state_dict`` ``state``; ``replicas`` as in
    :func:`model_params_to_torch` (the repeat axis then comes second)."""
    top = _nest({k: _numpy(v) for k, v in state.items() if not k.startswith("blocks.")})
    layers = _nest({k[len("blocks."):]: v for k, v in state.items() if k.startswith("blocks.")})
    stages, offset = [], 0
    for kinds, repeats in compile_stages(cfg.n_layers, cfg.block_pattern):
        stage = {}
        for j in range(len(kinds)):
            rows = [_flatten(layers[str(offset + r * len(kinds) + j)]) for r in range(repeats)]
            stage[f"blk{j}"] = _nest({k: np.stack([_numpy(row[k]) for row in rows],
                                                  axis=int(replicas)) for k in rows[0]})
        stages.append(stage)
        offset += repeats * len(kinds)
    return {**top, "stages": stages}


def _opt_map(tcfg, opt, params_fn, step_fn):
    """An optimizer state of ``tcfg.optimizer`` with ``params_fn`` over its
    param-shaped trees and ``step_fn`` over its counters."""
    if tcfg.optimizer == "adamw":
        return AdamState(step=step_fn(opt[0]), mu=params_fn(opt[1]), nu=params_fn(opt[2]))
    (mom,), (step,) = opt
    return (MomentumState(params_fn(mom)), ScheduleState(step_fn(step)))


def train_state_to_torch(cfg: ModelConfig, tcfg, state: Mapping,
                         device: torch.device | str | None = None) -> dict:
    """The port's train state (``launch.steps.make_train_state``'s layout) for
    the reference's of ``cfg`` under the ``TrainerConfig`` ``tcfg``: params
    and optimizer moments as ``state_dict``s, counters as int32 tensors."""
    dev = resolve_device(device)
    replicas = tcfg.consensus == "gossip"

    def params(tree):
        return model_params_to_torch(cfg, tree, dev, replicas=replicas)

    def step(v):
        return torch.from_numpy(np.array(v, dtype=np.int32)).to(dev)

    return {"params": params(state["params"]), "opt": _opt_map(tcfg, state["opt"], params, step),
            "step": step(state["step"])}


def train_state_to_reference(cfg: ModelConfig, tcfg, state: Mapping) -> dict:
    """The reference's train state (numpy leaves, its NamedTuples' names and
    fields) for the port's, as its checkpoints store it."""
    replicas = tcfg.consensus == "gossip"

    def params(tree):
        return model_params_to_reference(cfg, tree, replicas=replicas)

    return {"params": params(state["params"]), "opt": _opt_map(tcfg, state["opt"], params, _numpy),
            "step": _numpy(state["step"])}


def model_to_torch(cfg: ModelConfig, params: Mapping, device: torch.device | str | None = None,
                   **model_kwargs):
    """A port ``Model`` of ``cfg`` holding the reference's ``params``."""
    model = Model(cfg, device=device, **model_kwargs)
    model.load_state_dict(model_params_to_torch(cfg, params, model.device), strict=True)
    return model


def model_caches_to_torch(cfg: ModelConfig, caches: list,
                          device: torch.device | str | None = None) -> list:
    """The port's per-layer decode caches for the reference's per-stage
    ones: ``KVCache``, ``RGLRUState`` and ``RWKV6State`` by their fields."""
    dev = resolve_device(device)
    kinds = {t._fields: t for t in (KVCache, RGLRUState, RWKV6State)}
    out = []
    for _, blk, r in _unstack(cfg, caches):
        c = _slice(blk, r)
        out.append(kinds[type(c)._fields](*(_array_tensor(v, dev) for v in c)))
    return out
