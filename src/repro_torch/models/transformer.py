"""Model assembly: the decoder of the token-embedded families (dense GQA,
RG-LRU hybrid, RWKV-6 SSM) as one ``nn.Module``.

The reference scans stages of parameters stacked over repeats (see
``config.compile_stages``); here the blocks are a flat ``nn.ModuleList`` in
layer order, layer ``offset(stage) + r·len(kinds) + j`` for repeat ``r`` and
block ``j`` of a stage, and the forward is a Python loop over them.
Parameters live in the modules, so the entry points take no params:
  * ``forward(batch)`` / ``loss(batch)``   — prefill / training objective
  * ``decode_step(tokens, caches, pos)``   — one-token serve step

Caches are a flat list too, one entry per layer. Not ported yet (they raise
``NotImplementedError``): MoE channel mixing, the ``patches`` (VLM) and
``frames`` (audio) embeddings, and training (ROADMAP Queue A item 2).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch._device import resolve_device
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import rglru as G
from repro_torch.models import rwkv6 as W
from repro_torch.models.config import ModelConfig, compile_stages

__all__ = ["Model", "Block", "layer_kinds"]

_ATTN_KINDS = ("attn", "swa", "local_attn")


def layer_kinds(cfg: ModelConfig) -> list[str]:
    """The block kind of every layer, in the reference's scan order."""
    return [kind for kinds, repeats in compile_stages(cfg.n_layers, cfg.block_pattern)
            for _ in range(repeats) for kind in kinds]


def _unsupported(cfg: ModelConfig) -> str | None:
    if cfg.moe is not None:
        return "MoE channel mixing (models/moe.py)"
    if cfg.embed_kind == "patches":
        return "the 'patches' (VLM) embedding"
    if cfg.embed_kind == "frames":
        return "the 'frames' (audio) embedding"
    return None


class Block(nn.Module):
    """One layer: ``norm1``, the temporal mix (``attn``, ``rglru`` or
    ``rwkv``), ``norm2`` and, except for rwkv6, the MLP ``ch``."""

    def __init__(self, kind: str, cfg: ModelConfig, *, device=None, dtype=torch.float32):
        super().__init__()
        self.kind = kind
        self.norm1 = L.Norm(cfg.d_model, device=device, dtype=dtype)
        if kind in _ATTN_KINDS:
            self.attn = A.Attention(cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                                    device=device, dtype=dtype)
        elif kind == "rglru":
            self.rglru = G.RGLRU(cfg.d_model, device=device, dtype=dtype)
        elif kind == "rwkv6":
            self.rwkv = W.RWKV6(cfg.d_model, cfg.d_ff, cfg.rwkv_head_dim, device=device,
                                dtype=dtype)
        else:
            raise ValueError(kind)
        self.norm2 = L.Norm(cfg.d_model, device=device, dtype=dtype)
        if kind != "rwkv6":  # rwkv brings its own channel mix
            self.ch = L.MLP(cfg.d_model, cfg.d_ff, cfg.mlp, device=device, dtype=dtype)

    def reset(self, gen: torch.Generator | None) -> None:
        for name in ("attn", "rglru", "rwkv", "ch"):
            sub = getattr(self, name, None)
            if sub is not None:
                sub.reset(gen)


class Model(nn.Module):
    """The decoder of ``cfg`` on ``device`` (CUDA unless the caller names
    another; ``resolve_device`` raises without a card). ``dtype`` is the
    activation type, ``param_dtype`` the weights'. The weights are
    allocated, not drawn: call ``init(gen)``, or load a ``state_dict``
    (``repro_torch.convert.model_params_to_torch`` carries the reference's)."""

    def __init__(self, cfg: ModelConfig, *, device: torch.device | str | None = None,
                 dtype: torch.dtype = torch.float32, param_dtype: torch.dtype = torch.float32):
        super().__init__()
        missing = _unsupported(cfg)
        if missing is not None:
            raise NotImplementedError(
                f"{cfg.name}: {missing} is not ported yet (ROADMAP Queue A item 2)")
        self.cfg = cfg
        self.dtype = dtype
        dev = resolve_device(device)
        self.embed = L.Embedding(cfg.vocab_size, cfg.d_model, device=dev, dtype=param_dtype)
        self.final_norm = L.Norm(cfg.d_model, device=dev, dtype=param_dtype)
        if not cfg.tie_embeddings:
            self.head = L.Dense(cfg.d_model, cfg.vocab_size, device=dev, dtype=param_dtype)
        self.blocks = nn.ModuleList(Block(kind, cfg, device=dev, dtype=param_dtype)
                                    for kind in layer_kinds(cfg))

    @property
    def device(self) -> torch.device:
        return self.embed.table.device

    # ------------------------------------------------------------------ init
    def init(self, gen: torch.Generator | None) -> "Model":
        """Draw every weight from ``gen`` (on the model's device) with the
        reference's distributions and scales; returns the model."""
        self.embed.reset(gen)
        if hasattr(self, "head"):
            self.head.reset(gen)
        for blk in self.blocks:
            blk.reset(gen)
        return self

    # ----------------------------------------------------------- norms/mixes
    def _norm(self, p: L.Norm, x: torch.Tensor) -> torch.Tensor:
        return L.rms_norm(p, x) if self.cfg.norm == "rmsnorm" else L.layer_norm(p, x)

    def _block_train(self, blk: Block, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        cfg, kind = self.cfg, blk.kind
        if kind in _ATTN_KINDS:
            window = cfg.window if kind in ("swa", "local_attn") else 0
            x = x + A.attention_train(blk.attn, self._norm(blk.norm1, x), positions,
                                      window=window, causal=not cfg.is_encoder,
                                      rope_theta=cfg.rope_theta)
            x = x + blk.ch(self._norm(blk.norm2, x))
        elif kind == "rglru":
            x = x + G.rglru_train(blk.rglru, self._norm(blk.norm1, x))
            x = x + blk.ch(self._norm(blk.norm2, x))
        else:  # rwkv6
            x = x + W.time_mix_train(blk.rwkv, self._norm(blk.norm1, x), cfg.rwkv_head_dim)
            x = x + W.channel_mix_train(blk.rwkv, self._norm(blk.norm2, x))
        return x

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        x = self._norm(self.final_norm, x)
        if hasattr(self, "head"):
            return L.dense(self.head, x.float())
        return L.unembed(self.embed, x)

    # -------------------------------------------------------------- forward
    def forward(self, batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
        """Full-sequence forward of ``batch["tokens"]`` (B, S) -> (logits
        (B, S, V) float32, aux_loss), the aux loss 0 without MoE."""
        tokens = batch["tokens"]
        x = L.embed(self.embed, tokens).to(self.dtype)
        positions = torch.arange(x.shape[1], device=x.device).expand(x.shape[:2])
        for blk in self.blocks:
            x = self._block_train(blk, x, positions)
        return self._logits(x), torch.zeros((), dtype=torch.float32, device=x.device)

    # ----------------------------------------------------------------- loss
    def loss(self, batch: dict) -> tuple[torch.Tensor, dict]:
        """Scalar objective and metrics of ``{tokens (B,S), targets (B,S)}``:
        the mean cross entropy of the targets plus the aux loss."""
        logits, aux = self.forward(batch)
        targets = batch["targets"]
        lse = torch.logsumexp(logits, dim=-1)
        tgt = torch.gather(logits, -1, targets[..., None].long())[..., 0]
        ce = torch.mean(lse - tgt)
        return ce + aux, {"ce": ce, "aux": aux}

    # ---------------------------------------------------------------- cache
    def init_cache(self, batch: int, seq_len: int, cache_dtype: torch.dtype = torch.bfloat16) -> list:
        """Per-layer decode state. seq_len = context capacity."""
        cfg = self.cfg
        if not cfg.supports_decode():
            raise ValueError(f"{cfg.name} is encoder-only: no decode path")
        caches = []
        for blk in self.blocks:
            if blk.kind in _ATTN_KINDS:
                window = cfg.window if blk.kind in ("swa", "local_attn") else 0
                caches.append(A.init_kv_cache(batch, seq_len, cfg.n_kv_heads, cfg.head_dim,
                                              window, cache_dtype, device=self.device))
            elif blk.kind == "rglru":
                caches.append(G.init_rglru_state(batch, cfg.d_model, self.dtype, device=self.device))
            else:
                caches.append(W.init_rwkv6_state(batch, cfg.d_model, cfg.rwkv_head_dim,
                                                 self.dtype, device=self.device))
        return caches

    def _block_decode(self, blk: Block, x: torch.Tensor, cache, pos: int):
        cfg, kind = self.cfg, blk.kind
        if kind in _ATTN_KINDS:
            window = cfg.window if kind in ("swa", "local_attn") else 0
            h, cache = A.attention_decode(blk.attn, self._norm(blk.norm1, x), cache, pos,
                                          window=window, rope_theta=cfg.rope_theta)
            x = x + h
            x = x + blk.ch(self._norm(blk.norm2, x))
        elif kind == "rglru":
            h, cache = G.rglru_decode(blk.rglru, self._norm(blk.norm1, x), cache)
            x = x + h
            x = x + blk.ch(self._norm(blk.norm2, x))
        else:  # rwkv6
            tm, cache = W.time_mix_decode(blk.rwkv, self._norm(blk.norm1, x), cache,
                                          cfg.rwkv_head_dim)
            x = x + tm
            cm, cache = W.channel_mix_decode(blk.rwkv, self._norm(blk.norm2, x), cache)
            x = x + cm
        return x, cache

    def decode_step(self, tokens: torch.Tensor, caches: list, pos: int):
        """One-token serve step. tokens: (B, 1), ``pos`` an int -> (logits
        (B, 1, V), new caches). KV caches are updated in place."""
        x = L.embed(self.embed, tokens).to(self.dtype)
        new_caches = []
        for blk, cache in zip(self.blocks, caches):
            x, cache = self._block_decode(blk, x, cache, pos)
            new_caches.append(cache)
        return self._logits(x), new_caches
