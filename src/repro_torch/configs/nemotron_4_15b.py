"""Nemotron-4 15B — dense GQA decoder with squared-ReLU MLP and 256k vocab
[arXiv:2402.16819]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b",
    family="dense",
    n_layers=32,
    d_model=6144,
    d_ff=24576,
    vocab_size=256000,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    block_pattern=("attn",),
    mlp="squared_relu",
    norm="layernorm",
    rope_theta=10000.0,
    tie_embeddings=False,   # Nemotron-4 uses untied output layer
    citation="arXiv:2402.16819",
).validate()
