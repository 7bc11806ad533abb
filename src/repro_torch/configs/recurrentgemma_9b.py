"""RecurrentGemma 9B — Griffin hybrid: RG-LRU + local attention, 1 attn per
2 recurrent blocks, MQA (kv=1), 256k vocab [arXiv:2402.19427].

38 layers = 12 full (rglru, rglru, local_attn) cycles + 2 trailing rglru
blocks (compile_stages handles the tail as its own scan stage).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    d_ff=12288,
    vocab_size=256000,
    n_heads=16,
    n_kv_heads=1,
    head_dim=256,
    block_pattern=("rglru", "rglru", "local_attn"),
    window=2048,
    mlp="gated_silu",
    norm="rmsnorm",
    rope_theta=10000.0,
    citation="arXiv:2402.19427",
).validate()
