"""Architecture registry: the 10 assigned configs and the four input shapes
(``shapes.py``), copied from the JAX package's ``configs`` as they are, and
the paper's own SVM runs (``gadget_svm.PAPER_RUNS``)."""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

__all__ = ["ARCH_IDS", "get_config", "list_configs"]

_MODULES = {
    "llama3-8b": "llama3_8b",
    "llama3-405b": "llama3_405b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "mixtral-8x22b": "mixtral_8x22b",
    "mistral-large-123b": "mistral_large_123b",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "rwkv6-3b": "rwkv6_3b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "nemotron-4-15b": "nemotron_4_15b",
    "hubert-xlarge": "hubert_xlarge",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.CONFIG


def list_configs() -> dict[str, ModelConfig]:
    return {k: get_config(k) for k in _MODULES}
