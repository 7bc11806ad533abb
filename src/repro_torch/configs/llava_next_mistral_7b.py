"""LLaVA-NeXT (Mistral-7B backbone) — VLM: anyres patch embeddings prefixed to
the text stream [hf:llava-hf/llava-v1.6-mistral-7b-hf].

Per the assignment carve-out, the vision tower (CLIP ViT-L/336 + projector)
is a stub: input_specs()/the data pipeline provide precomputed patch
embeddings of shape (B, n_prefix_embeds, d_model). 576 tokens = one 336px
tile; anyres tiling raises this to up to 2880 (4 tiles + base) via
``n_prefix_embeds`` override. The backbone keeps Mistral-7B's native
sliding-window attention, which is what qualifies this arch for long_500k.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    n_layers=32,
    d_model=4096,
    d_ff=14336,
    vocab_size=32000,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    block_pattern=("swa",),
    window=4096,
    mlp="gated_silu",
    norm="rmsnorm",
    rope_theta=10000.0,
    embed_kind="patches",
    n_prefix_embeds=576,
    citation="hf:llava-hf/llava-v1.6-mistral-7b-hf",
).validate()
