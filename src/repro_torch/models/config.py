"""ModelConfig — one dataclass describing every assigned architecture family.

``block_pattern`` is the repeating cycle of temporal-mixing block kinds
(e.g. ("rglru", "rglru", "local_attn") for RecurrentGemma). n_layers need not
divide the cycle: the tail takes the pattern prefix. ``compile_stages`` turns
(n_layers, pattern) into scan stages: [(group_kinds, repeats)] with parameters
stacked over repeats, so HLO size is O(pattern) not O(depth).
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Sequence

__all__ = ["MoEConfig", "ModelConfig", "compile_stages"]


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int                 # per-expert FFN hidden dim
    d_shared: int = 0             # shared-expert FFN hidden dim (0 = none)
    capacity_factor: float = 1.25
    router_z_coef: float = 1e-3   # router z-loss (beyond-paper stability)
    aux_coef: float = 1e-2        # load-balance auxiliary loss


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    d_ff: int
    vocab_size: int
    n_heads: int = 0              # 0 for attention-free (rwkv)
    n_kv_heads: int = 0
    head_dim: int = 128
    block_pattern: tuple[str, ...] = ("attn",)   # attn | swa | local_attn | rglru | rwkv6
    mlp: str = "gated_silu"       # gated_silu | squared_relu | gelu
    norm: str = "rmsnorm"         # rmsnorm | layernorm
    window: int = 0               # sliding/local attention window (0 = full)
    rope_theta: float = 10000.0
    moe: MoEConfig | None = None
    is_encoder: bool = False      # bidirectional, no decode path (hubert)
    embed_kind: str = "tokens"    # tokens | patches (vlm) | frames (audio)
    n_prefix_embeds: int = 0      # vlm: image patch tokens preceding text
    rwkv_head_dim: int = 64
    tie_embeddings: bool = True
    citation: str = ""

    # --- derived ---
    @property
    def attn_layers(self) -> int:
        stages = compile_stages(self.n_layers, self.block_pattern)
        return sum(r * sum(1 for k in kinds if "attn" in k or k == "swa")
                   for kinds, r in stages)

    @property
    def rwkv_heads(self) -> int:
        return self.d_model // self.rwkv_head_dim

    def supports_decode(self) -> bool:
        return not self.is_encoder

    def subquadratic(self) -> bool:
        """True when no block attends over unbounded context (window or recurrent)."""
        return all(k in ("rglru", "rwkv6", "swa", "local_attn") for k in self.block_pattern)

    def reduced(self, n_layers: int = 2, d_model: int = 256, seed_ff_ratio: float | None = None) -> "ModelConfig":
        """CI-scale variant of the same family: <=2 layers, d_model<=512,
        <=4 experts — structure preserved (pattern, mlp kind, GQA ratio)."""
        d_model = min(d_model, 512)
        ratio = (self.d_ff / self.d_model) if seed_ff_ratio is None else seed_ff_ratio
        n_heads = max(1, min(self.n_heads, 4)) if self.n_heads else 0
        kv_ratio = max(1, self.n_heads // max(1, self.n_kv_heads)) if self.n_heads else 1
        n_kv = max(1, n_heads // kv_ratio) if n_heads else 0
        head_dim = d_model // n_heads if n_heads else 64
        moe = None
        if self.moe is not None:
            moe = replace(
                self.moe,
                n_experts=min(4, self.moe.n_experts),
                top_k=min(2, self.moe.top_k),
                d_expert=max(32, int(d_model * self.moe.d_expert / self.d_model)),
                d_shared=(max(32, int(d_model * self.moe.d_shared / self.d_model))
                          if self.moe.d_shared else 0),
            )
        n_layers = min(n_layers, self.n_layers)
        # keep at least one full pattern cycle when it fits
        if len(self.block_pattern) > n_layers:
            n_layers = len(self.block_pattern)
        return replace(
            self,
            name=f"{self.name}-reduced",
            n_layers=n_layers,
            d_model=d_model,
            d_ff=max(64, int(d_model * ratio)),
            vocab_size=min(self.vocab_size, 512),
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=head_dim,
            window=min(self.window, 64) if self.window else 0,
            moe=moe,
            n_prefix_embeds=min(self.n_prefix_embeds, 16),
            rwkv_head_dim=min(self.rwkv_head_dim, max(16, d_model // 4)),
        )

    def validate(self) -> "ModelConfig":
        if self.n_heads:
            if self.n_heads % max(1, self.n_kv_heads):
                raise ValueError(f"{self.name}: n_heads {self.n_heads} must divide by kv {self.n_kv_heads}")
        if self.family == "moe" and self.moe is None:
            raise ValueError(f"{self.name}: moe family needs MoEConfig")
        for k in self.block_pattern:
            if k not in ("attn", "swa", "local_attn", "rglru", "rwkv6"):
                raise ValueError(f"{self.name}: unknown block kind {k!r}")
        if self.family == "ssm" and self.d_model % self.rwkv_head_dim:
            raise ValueError(f"{self.name}: d_model must divide rwkv_head_dim")
        return self


def compile_stages(n_layers: int, pattern: Sequence[str]) -> list[tuple[tuple[str, ...], int]]:
    """[(group_kinds, repeats)] — full cycles scanned, tail as its own stage."""
    p = len(pattern)
    full, rem = divmod(n_layers, p)
    stages: list[tuple[tuple[str, ...], int]] = []
    if full:
        stages.append((tuple(pattern), full))
    if rem:
        stages.append((tuple(pattern[:rem]), 1))
    return stages
