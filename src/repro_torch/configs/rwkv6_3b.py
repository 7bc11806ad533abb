"""RWKV-6 "Finch" 3B — attention-free SSM with data-dependent decay
[arXiv:2404.05892]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    d_ff=8960,
    vocab_size=65536,
    n_heads=0,           # attention-free
    n_kv_heads=0,
    block_pattern=("rwkv6",),
    rwkv_head_dim=64,
    mlp="squared_relu",  # rwkv channel-mix uses relu^2 internally
    norm="layernorm",
    citation="arXiv:2404.05892",
).validate()
