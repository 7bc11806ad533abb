"""Model assembly: the decoder or encoder of every assigned family (dense
GQA, MoE, RG-LRU hybrid, RWKV-6 SSM, VLM backbone, audio encoder) as one
``nn.Module``.

The reference scans stages of parameters stacked over repeats (see
``config.compile_stages``); here the blocks are a flat ``nn.ModuleList`` in
layer order, layer ``offset(stage) + r·len(kinds) + j`` for repeat ``r`` and
block ``j`` of a stage, and the forward is a Python loop over them.
Parameters live in the modules, so the entry points take no params:
  * ``forward(batch)`` / ``loss(batch)``   — prefill / training objective
  * ``decode_step(tokens, caches, pos)``   — one-token serve step

Caches are a flat list too, one entry per layer. The three input layouts
are the reference's: ``tokens``; ``patches`` (VLM: precomputed patch
embeddings before the embedded text, the loss on the text positions only);
``frames`` (audio: precomputed frame embeddings, no embedding table, the
cross entropy masked). ``remat`` checkpoints each block
(``torch.utils.checkpoint``): "full" recomputes the whole block in the
backward pass, "dots" keeps the matrix products' outputs and recomputes the
rest. Recomputation repeats the same arithmetic, so remat on equals remat
off bit for bit.

On a mesh the parameters and inputs are DTensors; ``constrain`` pins the
residual stream, the embedded inputs and the logits to the active logical
rules at the reference's sites (the identity on plain tensors), and the
cross entropy of vocab-sharded logits is taken shard-locally
(:func:`_nll`).
"""
from __future__ import annotations

import contextlib
import functools

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map
from torch.utils import checkpoint as ckpt

from repro_torch._device import resolve_device
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import rglru as G
from repro_torch.models import rwkv6 as W
from repro_torch.models.config import ModelConfig, compile_stages
from repro_torch.sharding.api import (activate, constrain, current_rules, grad_like, relayout,
                                      shard_range)

__all__ = ["Model", "Block", "layer_kinds"]

_ATTN_KINDS = ("attn", "swa", "local_attn")
# the residual stream's logical axes, pinned after each mix (the reference
# pins it at block ends; between the two mixes too here, so that a
# row-parallel product's partial sums are reduced before the norm)
_STREAM = ("batch", "seq", "embed")
_GATHERED = ("batch", None, "embed")  # the stream with its sequence whole


def layer_kinds(cfg: ModelConfig) -> list[str]:
    """The block kind of every layer, in the reference's scan order."""
    return [kind for kinds, repeats in compile_stages(cfg.n_layers, cfg.block_pattern)
            for _ in range(repeats) for kind in kinds]


# the matrix products whose outputs remat_policy="dots" keeps
_DOT_OPS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                      torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default})


def _dots_policy(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOT_OPS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


_REMAT_CONTEXT = {"full": ckpt.noop_context_fn,
                  "dots": functools.partial(ckpt.create_selective_checkpoint_contexts,
                                            _dots_policy)}


def _remat_context(policy: str, rules):
    """``_REMAT_CONTEXT[policy]`` with the forward's logical rules active in
    the recomputation too: on CUDA the backward (and so the recomputation)
    runs on autograd's own thread, where the thread-local rules are unset."""
    @contextlib.contextmanager
    def recompute_with_rules(recompute):
        with contextlib.ExitStack() as stack:
            if rules is not None:
                stack.enter_context(activate(rules))
            stack.enter_context(recompute)
            yield

    def context_fn():
        forward, recompute = _REMAT_CONTEXT[policy]()
        return forward, recompute_with_rules(recompute)
    return context_fn


def _nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """lse(logits) − logit[target], (B, S). On vocab-sharded DTensor logits
    the log-sum-exp comes from a max and a sum over the shards and the
    target's logit from the shard that holds it (:func:`_target_logit`):
    the collectives carry (B, S) values, and the (B, S, V) logits are never
    gathered."""
    if not isinstance(logits, DTensor):
        lse = torch.logsumexp(logits, dim=-1)
        return lse - torch.gather(logits, -1, targets[..., None].long())[..., 0]
    # each (B, S) partial pinned to the batch layout: DTensor would otherwise
    # reduce-scatter it onto the batch over `model` too, and gather the
    # vocab-sharded gradient to meet that layout in the backward pass
    rows = ("batch", "seq")
    m = constrain(torch.amax(logits, dim=-1, keepdim=True).detach(), rows + (None,))
    total = constrain(torch.sum(torch.exp(logits - m), dim=-1), rows)
    tgt = constrain(_target_logit(logits, targets), rows)
    return grad_like(torch.log(total) + m[..., 0] - tgt)


def _target_logit(logits, targets: torch.Tensor) -> torch.Tensor:
    """logit[target] of DTensor logits (B, S, V): each rank gathers the
    targets that fall in its vocab shard (zero elsewhere) and the vocab
    mesh dims sum them (a ``Partial`` output of ``local_map``)."""
    mesh, pl, last = logits.device_mesh, tuple(logits.placements), logits.ndim - 1
    vocab = [isinstance(p, Shard) and p.dim == last for p in pl]
    offset, _ = shard_range(mesh, pl, last, logits.shape[-1])

    def local(lg, tg):
        idx = tg.long() - offset
        inside = (idx >= 0) & (idx < lg.shape[-1])
        got = torch.gather(lg, -1, idx.clamp(0, lg.shape[-1] - 1)[..., None])[..., 0]
        return torch.where(inside, got, torch.zeros_like(got))

    rows = tuple(Replicate() if v else p for v, p in zip(vocab, pl))
    out = tuple(Partial() if v else p for v, p in zip(vocab, pl))
    return local_map(local, out_placements=(out,), in_placements=(pl, rows),
                     in_grad_placements=(pl, rows), redistribute_inputs=True,
                     device_mesh=mesh)(logits, targets)


def _seq_sharded() -> bool:
    """Whether the active rules shard the sequence."""
    r = current_rules()
    return r is not None and r.spec(("seq",))[0] is not None


class Block(nn.Module):
    """One layer: ``norm1``, the temporal mix (``attn``, ``rglru`` or
    ``rwkv``), ``norm2`` and, except for rwkv6, the channel mix ``ch``: an
    MLP, or a ``MoE`` when the config has one."""

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
        if kind == "rwkv6":  # rwkv brings its own channel mix
            return
        if cfg.moe is not None:
            self.ch = M.MoE(cfg.d_model, cfg.moe, cfg.mlp, device=device, dtype=dtype)
        else:
            self.ch = L.MLP(cfg.d_model, cfg.d_ff, cfg.mlp, device=device, dtype=dtype)

    def reset(self, gen: torch.Generator | None) -> None:
        for name in ("attn", "rglru", "rwkv", "ch"):
            sub = getattr(self, name, None)
            if sub is not None:
                sub.reset(gen)


class Model(nn.Module):
    """The model of ``cfg`` on ``device`` (CUDA unless the caller names
    another; ``resolve_device`` raises without a card). ``dtype`` is the
    activation type, ``param_dtype`` the weights'. The weights are
    allocated, not drawn: call ``init(gen)``, or load a ``state_dict``
    (``repro_torch.convert.model_params_to_torch`` carries the reference's).
    As in the reference, the token embedding is present for ``tokens`` and
    the VLM, and the head unless the embedding is tied (always for
    ``frames``)."""

    def __init__(self, cfg: ModelConfig, *, device: torch.device | str | None = None,
                 dtype: torch.dtype = torch.float32, param_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        dev = resolve_device(device)
        if cfg.embed_kind == "tokens" or cfg.family == "vlm":
            self.embed = L.Embedding(cfg.vocab_size, cfg.d_model, device=dev, dtype=param_dtype)
        self.final_norm = L.Norm(cfg.d_model, device=dev, dtype=param_dtype)
        if not cfg.tie_embeddings or cfg.embed_kind == "frames":
            self.head = L.Dense(cfg.d_model, cfg.vocab_size, device=dev, dtype=param_dtype)
        self.blocks = nn.ModuleList(Block(kind, cfg, device=dev, dtype=param_dtype)
                                    for kind in layer_kinds(cfg))

    @property
    def device(self) -> torch.device:
        return self.final_norm.scale.device

    # ------------------------------------------------------------------ init
    def init(self, gen: torch.Generator | None) -> "Model":
        """Draw every weight from ``gen`` (on the model's device) with the
        reference's distributions and scales; returns the model."""
        if hasattr(self, "embed"):
            self.embed.reset(gen)
        if hasattr(self, "head"):
            self.head.reset(gen)
        for blk in self.blocks:
            blk.reset(gen)
        return self

    # ----------------------------------------------------------- norms/mixes
    def _norm(self, p: L.Norm, x: torch.Tensor) -> torch.Tensor:
        return L.rms_norm(p, x) if self.cfg.norm == "rmsnorm" else L.layer_norm(p, x)

    def _channel(self, ch: nn.Module, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """The channel mix and its aux loss (0 without MoE)."""
        if self.cfg.moe is not None:
            y, aux = M.moe_apply(ch, x, self.cfg.moe, self.cfg.mlp)
            return y, aux.load_balance_loss + aux.router_z_loss
        return ch(x), torch.zeros((), dtype=torch.float32, device=x.device)

    def _mixer_in(self, p: L.Norm, x: torch.Tensor) -> torch.Tensor:
        """The normed stream a mixer (or the head) reads, with the sequence
        gathered where the rules shard it (see :meth:`_mixer_out`)."""
        x = self._norm(p, x)
        return relayout(x, _GATHERED) if _seq_sharded() else x

    def _mixer_out(self, y: torch.Tensor) -> torch.Tensor:
        """A mixer's output as the residual stream holds it. Where the rules
        shard the sequence (the dry-run's ``--seq-shard``: Megatron-style
        sequence parallelism) the mixers read whole rows, gathered by
        :meth:`_mixer_in`, and their partial sums are scattered back onto
        the sequence here; the backward runs the same moves reversed."""
        return relayout(y, _STREAM) if _seq_sharded() else y

    def _block_train(self, blk: Block, x: torch.Tensor,
                     positions: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        cfg, kind = self.cfg, blk.kind
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if kind in _ATTN_KINDS:
            window = cfg.window if kind in ("swa", "local_attn") else 0
            x = constrain(x + self._mixer_out(A.attention_train(
                blk.attn, self._mixer_in(blk.norm1, x), positions, window=window,
                causal=not cfg.is_encoder, rope_theta=cfg.rope_theta)), _STREAM)
            ch, aux = self._channel(blk.ch, self._mixer_in(blk.norm2, x))
            x = x + self._mixer_out(ch)
        elif kind == "rglru":
            x = constrain(x + self._mixer_out(G.rglru_train(
                blk.rglru, self._mixer_in(blk.norm1, x))), _STREAM)
            ch, aux = self._channel(blk.ch, self._mixer_in(blk.norm2, x))
            x = x + self._mixer_out(ch)
        else:  # rwkv6
            x = constrain(x + self._mixer_out(W.time_mix_train(
                blk.rwkv, self._mixer_in(blk.norm1, x), cfg.rwkv_head_dim)), _STREAM)
            x = x + self._mixer_out(W.channel_mix_train(blk.rwkv, self._mixer_in(blk.norm2, x)))
        return constrain(x, _STREAM), aux

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        x = self._mixer_in(self.final_norm, x)
        if hasattr(self, "head"):
            return L.dense(self.head, x.float())
        return L.unembed(self.embed, x)

    # -------------------------------------------------------------- forward
    def _embed_inputs(self, batch: dict) -> torch.Tensor:
        kind = self.cfg.embed_kind
        if kind == "tokens":
            x = L.embed(self.embed, batch["tokens"]).to(self.dtype)
        elif kind == "patches":
            tok = constrain(L.embed(self.embed, batch["tokens"]).to(self.dtype), _STREAM)
            x = torch.cat([batch["patch_embeds"].to(self.dtype), tok], dim=1)
        elif kind == "frames":
            x = batch["frames"].to(self.dtype)
        else:
            raise ValueError(kind)
        return constrain(x, _STREAM)

    def forward(self, batch: dict, *, remat: bool = False,
                remat_policy: str = "full") -> tuple[torch.Tensor, torch.Tensor]:
        """Full-sequence forward -> (logits (B, S, V) float32, aux_loss), the
        aux loss the sum of the MoE blocks' (0 without MoE). ``batch`` holds
        the layout's inputs (see ``loss``); ``remat`` checkpoints each block
        with ``remat_policy`` ("full" or "dots")."""
        x = self._embed_inputs(batch)
        positions = torch.arange(x.shape[1], device=x.device).expand(x.shape[:2])
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        context_fn = _remat_context(remat_policy, current_rules())
        for blk in self.blocks:
            if remat:
                x, aux = ckpt.checkpoint(self._block_train, blk, x, positions,
                                         use_reentrant=False, context_fn=context_fn)
            else:
                x, aux = self._block_train(blk, x, positions)
            aux_total = aux_total + aux
        # under sequence parallelism the head reads whole rows (_mixer_in) and
        # its logits stay on the vocab: the reference's ("batch", "seq",
        # "vocab") would give `model` to the sequence, and eagerly that moves
        # the (B, S, V) logits all to all
        logits_axes = ("batch", None, "vocab") if _seq_sharded() else ("batch", "seq", "vocab")
        return constrain(self._logits(x), logits_axes), aux_total

    # ----------------------------------------------------------------- loss
    def loss(self, batch: dict, *, remat: bool = False,
             remat_policy: str = "full") -> tuple[torch.Tensor, dict]:
        """Scalar objective and metrics ``{"ce", "aux"}``: the cross entropy
        of the targets plus the aux loss. Batch layouts:
        tokens:  {tokens (B,S), targets (B,S)}
        patches: {patch_embeds (B,P,D), tokens (B,St), targets (B,St)}
        frames:  {frames (B,S,D), targets (B,S), mask (B,S) bool}
        """
        logits, aux = self.forward(batch, remat=remat, remat_policy=remat_policy)
        targets = batch["targets"]
        if self.cfg.embed_kind == "patches":
            logits = logits[:, -targets.shape[1]:]  # loss on text positions only
        nll = _nll(logits, targets)
        if self.cfg.embed_kind == "frames":
            mask = batch["mask"].float()
            ce = torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
        else:
            ce = torch.mean(nll)
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
            x = x + self._channel(blk.ch, self._norm(blk.norm2, x))[0]
        elif kind == "rglru":
            h, cache = G.rglru_decode(blk.rglru, self._norm(blk.norm1, x), cache)
            x = x + h
            x = x + self._channel(blk.ch, self._norm(blk.norm2, x))[0]
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
        x = constrain(L.embed(self.embed, tokens).to(self.dtype), _STREAM)
        new_caches = []
        for blk, cache in zip(self.blocks, caches):
            x, cache = self._block_decode(blk, x, cache, pos)
            new_caches.append(cache)
        return self._logits(x), new_caches
