"""Model substrate: config, shared layers, the attention, RG-LRU and RWKV-6
blocks, and the layer-list assembly (``transformer.Model``)."""
from repro_torch.models.config import ModelConfig, MoEConfig, compile_stages  # noqa: F401
from repro_torch.models.transformer import Model  # noqa: F401
