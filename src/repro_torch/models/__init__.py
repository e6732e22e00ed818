"""The dense GQA transformer on PyTorch: prefill and decode through the
K3 and K2 kernels. MoE, SSM, hybrid and cross-attention families are not
ported yet."""
from .attention import (
    decode_self_attention,
    init_kv_cache,
    out_proj,
    qkv_proj,
    self_attention,
)
from .init import init_params, param_bytes, params_from_jax
from .layers import (
    BATCH,
    MODEL,
    embed,
    mlp_forward,
    rms_norm,
    rope,
    shard,
    unembed,
)
from .model import decode_step, forward, prefill
from .transformer import init_caches, run_blocks, super_block
