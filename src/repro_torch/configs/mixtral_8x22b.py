"""Mixtral 8x22B — MoE decoder: 8 experts, top-2, SWA [arXiv:2401.04088]."""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    d_ff=16384,          # per-expert FFN width
    vocab_size=32768,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    block_pattern=("swa",),
    window=4096,
    mlp="gated_silu",
    norm="rmsnorm",
    rope_theta=1000000.0,
    moe=MoEConfig(n_experts=8, top_k=2, d_expert=16384),
    citation="arXiv:2401.04088",
).validate()
