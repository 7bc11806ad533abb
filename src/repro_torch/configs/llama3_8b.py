"""Llama 3 8B — dense GQA decoder, 128k vocab [arXiv:2407.21783]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    d_ff=14336,
    vocab_size=128256,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    block_pattern=("attn",),
    mlp="gated_silu",
    norm="rmsnorm",
    rope_theta=500000.0,
    citation="arXiv:2407.21783",
).validate()
