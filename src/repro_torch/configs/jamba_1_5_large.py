"""jamba-1.5-large-398b [hybrid]: 72L d_model=8192 64H (GQA kv=8)
d_ff=24576 vocab=65536, Mamba+attention 1:7 interleave, MoE 16e top-2
[arXiv:2403.19887]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab=65_536,
    n_experts=16,
    top_k=2,
    moe_every=2,            # MoE every other layer (Jamba cadence)
    moe_offset=1,
    attn_every=8,           # 1 attention layer per 8 (1:7 attn:mamba)
    ssm_state=16,           # Jamba uses d_state=16 mamba layers
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=256,
    rope_theta=10_000.0,
    source="arXiv:2403.19887",
)
