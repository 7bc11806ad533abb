"""Mistral Large 2 (123B) — dense GQA decoder
[hf:mistralai/Mistral-Large-Instruct-2407]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mistral-large-123b",
    family="dense",
    n_layers=88,
    d_model=12288,
    d_ff=28672,
    vocab_size=32768,
    n_heads=96,
    n_kv_heads=8,
    head_dim=128,
    block_pattern=("attn",),   # Large 2 dropped SWA: full attention
    mlp="gated_silu",
    norm="rmsnorm",
    rope_theta=1000000.0,
    citation="hf:mistralai/Mistral-Large-Instruct-2407",
).validate()
