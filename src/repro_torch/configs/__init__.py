"""Architecture registry: the 10 assigned architectures (+ the paper's own
Qwen serving models for end-to-end benchmarks)."""
from __future__ import annotations

import dataclasses

from .base import INPUT_SHAPES, LONG_CONTEXT_WINDOW, InputShape, ModelConfig
from .gemma_7b import CONFIG as GEMMA_7B
from .jamba_1_5_large import CONFIG as JAMBA_1_5_LARGE
from .llama4_maverick_400b import CONFIG as LLAMA4_MAVERICK
from .llama_3_2_vision_90b import CONFIG as LLAMA_3_2_VISION
from .mamba2_370m import CONFIG as MAMBA2_370M
from .musicgen_large import CONFIG as MUSICGEN_LARGE
from .olmoe_1b_7b import CONFIG as OLMOE_1B_7B
from .qwen2_72b import CONFIG as QWEN2_72B
from .tinyllama_1_1b import CONFIG as TINYLLAMA_1_1B
from .yi_34b import CONFIG as YI_34B

ARCHS = {
    c.name: c
    for c in [
        GEMMA_7B,
        OLMOE_1B_7B,
        MUSICGEN_LARGE,
        QWEN2_72B,
        TINYLLAMA_1_1B,
        LLAMA_3_2_VISION,
        YI_34B,
        MAMBA2_370M,
        LLAMA4_MAVERICK,
        JAMBA_1_5_LARGE,
    ]
}

# The paper's end-to-end evaluation models (Fig 12/13): parameter/KV sizes
# drive the serving benchmarks. [arXiv:2309.16609, arXiv:2505.09388]
PAPER_MODELS = {
    "qwen3-0.6b": ModelConfig(
        name="qwen3-0.6b", family="dense", n_layers=28, d_model=1024,
        n_heads=16, n_kv_heads=8, head_dim=128, d_ff=3072, vocab=151_936,
        qkv_bias=False, source="arXiv:2505.09388",
    ),
    "qwen3-4b": ModelConfig(
        name="qwen3-4b", family="dense", n_layers=36, d_model=2560,
        n_heads=32, n_kv_heads=8, head_dim=128, d_ff=9728, vocab=151_936,
        source="arXiv:2505.09388",
    ),
    "qwen-7b-chat": ModelConfig(
        name="qwen-7b-chat", family="dense", n_layers=32, d_model=4096,
        n_heads=32, n_kv_heads=32, d_ff=11008, vocab=151_936,
        qkv_bias=True, source="arXiv:2309.16609",
    ),
    "qwen3-32b": ModelConfig(
        name="qwen3-32b", family="dense", n_layers=64, d_model=5120,
        n_heads=64, n_kv_heads=8, head_dim=128, d_ff=25600, vocab=151_936,
        source="arXiv:2505.09388",
    ),
}


def get_config(name: str, shape: str | None = None) -> ModelConfig:
    """Look up an architecture; applies the sliding-window variant for
    ``long_500k`` on full-attention families (DESIGN.md §5)."""
    reg = {**ARCHS, **PAPER_MODELS}
    if name not in reg:
        raise KeyError(
            f"unknown arch {name!r}; available: {sorted(reg)}"
        )
    cfg = reg[name]
    if shape == "long_500k" and cfg.uses_attention and cfg.family not in (
        "ssm", "hybrid"
    ):
        cfg = dataclasses.replace(cfg, attn_window=LONG_CONTEXT_WINDOW)
    return cfg


__all__ = [
    "ARCHS", "PAPER_MODELS", "INPUT_SHAPES", "LONG_CONTEXT_WINDOW",
    "InputShape", "ModelConfig", "get_config",
]
