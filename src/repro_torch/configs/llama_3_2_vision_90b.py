"""llama-3.2-vision-90b [vlm]: 100L d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256, cross-attn image layers every 5th layer
[hf:meta-llama/Llama-3.2-11B-Vision].

The ViT/SigLIP vision encoder + projector is STUBBED per the carve-out:
``input_specs`` supplies precomputed patch embeddings of shape
(batch, n_frontend_tokens, d_model) consumed by the cross-attention layers."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab=128_256,
    cross_attn_every=5,
    n_frontend_tokens=576,     # ViT patch embeddings (stub)
    rope_theta=500_000.0,
    source="hf:meta-llama/Llama-3.2-11B-Vision",
)
