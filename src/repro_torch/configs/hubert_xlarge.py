"""HuBERT X-Large — audio encoder-only (wav2vec2 backbone arch), masked
frame prediction over 504 cluster targets [arXiv:2106.07447].

Per the assignment carve-out, the conv feature extractor (waveform ->
frames) is a stub: the pipeline provides precomputed frame embeddings
(B, S, d_model). Encoder-only => bidirectional attention, no decode shapes
(noted in DESIGN.md §Arch-applicability).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    d_ff=5120,
    vocab_size=504,
    n_heads=16,
    n_kv_heads=16,
    head_dim=80,
    block_pattern=("attn",),
    mlp="gelu",
    norm="layernorm",
    is_encoder=True,
    embed_kind="frames",
    tie_embeddings=False,
    citation="arXiv:2106.07447",
).validate()
