"""Llama 3 405B — dense GQA decoder, 126 layers [arXiv:2407.21783]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b",
    family="dense",
    n_layers=126,
    d_model=16384,
    d_ff=53248,
    vocab_size=128256,
    n_heads=128,
    n_kv_heads=8,
    head_dim=128,
    block_pattern=("attn",),
    mlp="gated_silu",
    norm="rmsnorm",
    rope_theta=500000.0,
    citation="arXiv:2407.21783",
).validate()
