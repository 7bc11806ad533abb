"""Concrete host batches for every model input layout, the port of
``repro.launch.input_specs.make_host_batch``.

Layouts:
  tokens:  {tokens (B,S) int32, targets (B,S) int32}
  patches: {patch_embeds (B,P,D), tokens (B,S-P) int32, targets (B,S-P)}
  frames:  {frames (B,S,D), targets (B,S) int32, mask (B,S) bool}

Gossip-mode training batches gain a leading replica axis: (G, B/G, ...).

The draws are the reference's ``jax.random`` Threefry streams
(``core.counter_rng``): the key ``PRNGKey(seed)`` split in three, the
tokens by ``randint``, the mask by ``bernoulli`` (both bit for bit) and the
embeddings by ``normal``, whose uniform bits are the reference's and whose
inverse error function is ``torch.erfinv`` (the reference's is XLA's
polynomial; the two differ in the last bits).

The abstract inputs (``train_batch_shapes``, ``decode_input_shapes``) are
tensors that hold no data: ``meta`` tensors, or fake ones when built under
``FakeTensorMode`` on the device named (the dry-run's fake CUDA tensors).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs.shapes import InputShape
from repro_torch.core import counter_rng as rng
from repro_torch.models.config import ModelConfig

__all__ = ["make_host_batch", "normal", "train_batch_shapes", "decode_input_shapes"]


def train_batch_shapes(cfg: ModelConfig, shape: InputShape, *, n_replicas: int = 0,
                       act_dtype: torch.dtype = torch.bfloat16,
                       device: torch.device | str = "meta") -> dict[str, torch.Tensor]:
    """Empty tensors of the train / prefill batch of ``shape`` in ``cfg``'s
    layout (the reference's ``ShapeDtypeStruct``s), with a leading replica
    axis (G, B/G, ...) when ``n_replicas``."""
    B, S = shape.global_batch, shape.seq_len
    lead = (n_replicas, B // n_replicas) if n_replicas else (B,)

    def empty(*dims, dtype=torch.int32):
        return torch.empty(lead + dims, dtype=dtype, device=device)

    if cfg.embed_kind == "tokens":
        return {"tokens": empty(S), "targets": empty(S)}
    if cfg.embed_kind == "patches":
        P_ = min(cfg.n_prefix_embeds, S // 2)
        return {"patch_embeds": empty(P_, cfg.d_model, dtype=act_dtype),
                "tokens": empty(S - P_), "targets": empty(S - P_)}
    if cfg.embed_kind == "frames":
        return {"frames": empty(S, cfg.d_model, dtype=act_dtype), "targets": empty(S),
                "mask": empty(S, dtype=torch.bool)}
    raise ValueError(cfg.embed_kind)


def decode_input_shapes(model, shape: InputShape, *, cache_dtype: torch.dtype = torch.bfloat16):
    """(tokens (B, 1), caches, pos) for a serve step against a
    ``shape.seq_len``-deep cache: tensors on the model's device (empty ones
    under ``FakeTensorMode`` or on ``meta``) and ``pos`` the last slot (the
    whole cache live), an int as ``decode_step`` takes it."""
    B, S = shape.global_batch, shape.seq_len
    tokens = torch.empty((B, 1), dtype=torch.int32, device=model.device)
    return tokens, model.init_cache(B, S, cache_dtype), S - 1

# the uniform's open lower end: the float32 after -1 towards 0
_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))


def _index(shape: tuple, device: torch.device) -> torch.Tensor:
    return torch.arange(math.prod(shape), dtype=torch.int64, device=device).reshape(shape)


def normal(key, shape: tuple, device: torch.device) -> torch.Tensor:
    """``jax.random.normal(key, shape)`` (float32): a uniform on (-1, 1) from
    the top 23 bits, then sqrt(2)·erfinv."""
    bits = rng.random_bits(key, _index(shape, device))
    one = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    u = torch.clamp(one * 2.0 + _LO, min=_LO)
    return float(np.float32(math.sqrt(2))) * torch.erfinv(u)


def make_host_batch(cfg: ModelConfig, batch: int, seq: int, *, seed: int = 0,
                    n_replicas: int = 0, dtype: torch.dtype = torch.float32,
                    device: torch.device | str | None = None) -> dict:
    """A small concrete batch of ``cfg``'s layout, drawn from the key
    ``PRNGKey(seed)`` as the reference draws it from ``key``, on ``device``
    (CUDA unless the caller names another)."""
    dev = resolve_device(device)
    lead = (n_replicas, batch // n_replicas) if n_replicas else (batch,)
    key = rng.prng_key(seed)
    k1, k2, k3 = (rng.fold_in(key, i) for i in range(3))  # jax.random.split(key, 3)

    def toks(k, *dims):
        shape = lead + dims
        return rng.randint(k, _index(shape, dev), cfg.vocab_size).to(torch.int32)

    if cfg.embed_kind == "tokens":
        t = toks(k1, seq + 1)
        return {"tokens": t[..., :-1], "targets": t[..., 1:]}
    if cfg.embed_kind == "patches":
        P_ = min(cfg.n_prefix_embeds, seq // 2)
        t = toks(k1, seq - P_ + 1)
        return {
            "patch_embeds": (0.02 * normal(k2, lead + (P_, cfg.d_model), dev)).to(dtype),
            "tokens": t[..., :-1],
            "targets": t[..., 1:],
        }
    if cfg.embed_kind == "frames":
        shape = lead + (seq,)
        return {
            "frames": (0.02 * normal(k2, lead + (seq, cfg.d_model), dev)).to(dtype),
            "targets": toks(k1, seq),
            "mask": rng.bernoulli(k3, _index(shape, dev), 0.5),
        }
    raise ValueError(cfg.embed_kind)
