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
reference's key path, dotted, under ``blocks.<layer>``);
``model_caches_to_torch`` does the same for decode caches.
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

__all__ = ["result_to_torch", "weights_to_torch", "load_params", "model_params_to_torch",
           "model_to_torch", "model_caches_to_torch"]

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


def _slice(tree, r: int):
    if isinstance(tree, Mapping):
        return {k: _slice(v, r) for k, v in tree.items()}
    if hasattr(tree, "_fields"):  # a cache NamedTuple
        return type(tree)(*(_slice(v, r) for v in tree))
    return np.asarray(tree)[r]


def model_params_to_torch(cfg: ModelConfig, params: Mapping,
                          device: torch.device | str | None = None) -> dict:
    """The port's ``Model`` ``state_dict`` for the reference's params of ``cfg``
    (``embed``, ``final_norm``, optionally ``head``, and ``stages``)."""
    dev = resolve_device(device)
    top = {k: v for k, v in params.items() if k != "stages"}
    state = {k: _array_tensor(v, dev) for k, v in _flatten(top).items()}
    for layer, (_, blk, r) in enumerate(_unstack(cfg, params["stages"])):
        for k, v in _flatten(_slice(blk, r)).items():
            state[f"blocks.{layer}.{k}"] = _array_tensor(v, dev)
    return state


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
