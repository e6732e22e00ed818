"""llama4-maverick-400b-a17b [moe]: 48L d_model=5120 40H (GQA kv=8) expert
d_ff=8192 vocab=202048, MoE 128 experts top-1, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E].

Early fusion means image tokens share the decoder stream; the image
tokenizer is STUBBED — ``input_specs`` can supply fused token embeddings
via the ``inputs_embeds`` path."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab=202_048,
    n_experts=128,
    top_k=1,
    moe_every=2,            # Llama-4 interleaves dense and MoE layers;
    moe_offset=1,           # 24 MoE layers x 128e ~= the 400B total

    capacity_factor=2.0,    # top-1 routing needs headroom against drops
    rope_theta=500_000.0,
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
)
