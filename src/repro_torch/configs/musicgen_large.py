"""musicgen-large [audio]: 48L d_model=2048 32H (kv=32) d_ff=8192
vocab=2048, decoder-only over EnCodec tokens [arXiv:2306.05284].

The EnCodec conv codec / mel frontend is STUBBED per the carve-out:
``input_specs`` supplies precomputed conditioning-frame embeddings consumed
by the decoder (inputs_embeds path)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=2048,
    n_frontend_tokens=256,     # conditioning frames (stub embeddings)
    rope_theta=10_000.0,
    source="arXiv:2306.05284",
)
