"""Qwen1.5/2-MoE A2.7B — fine-grained MoE: 60 routed experts top-4 plus
shared experts (shared FFN width 5632 = 4x1408) [hf:Qwen/Qwen1.5-MoE-A2.7B]."""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    d_ff=1408,            # routed per-expert FFN width
    vocab_size=151936,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    block_pattern=("attn",),
    mlp="gated_silu",
    norm="rmsnorm",
    rope_theta=1000000.0,
    moe=MoEConfig(n_experts=60, top_k=4, d_expert=1408, d_shared=5632),
    citation="hf:Qwen/Qwen1.5-MoE-A2.7B",
).validate()
