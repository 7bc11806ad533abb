"""The four assigned input shapes.

train_4k / prefill_32k lower a full-sequence step; decode shapes lower
``serve_step`` (one token against a seq_len-deep cache). Applicability per
architecture follows DESIGN.md §Arch-applicability: long_500k only for
sub-quadratic attention; no decode shapes for encoder-only models.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.models.config import ModelConfig

__all__ = ["InputShape", "SHAPES", "shape_applies", "skip_reason"]


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, InputShape] = {
    "train_4k":    InputShape("train_4k",    4_096,   256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768,  32,  "prefill"),
    "decode_32k":  InputShape("decode_32k",  32_768,  128, "decode"),
    "long_500k":   InputShape("long_500k",   524_288, 1,   "decode"),
}


def skip_reason(cfg: ModelConfig, shape: InputShape) -> str | None:
    """None = runs; else the DESIGN.md-documented reason to skip."""
    if shape.kind == "decode":
        if not cfg.supports_decode():
            return "encoder-only architecture: no decode step"
        if shape.name == "long_500k" and not cfg.subquadratic():
            return "pure full attention: 524k context requires sub-quadratic attention"
    return None


def shape_applies(cfg: ModelConfig, shape: InputShape) -> bool:
    return skip_reason(cfg, shape) is None
