"""The model families on PyTorch: the dense GQA transformer (prefill and
decode through the K3 and K2 kernels), Mamba2 (SSD prefill through the K4
kernel, recurrent decode), the MoE channel (top-k routing with capacity
drops, experts as products over the expert axis), cross-attention to a
frontend's embeddings (K3 without the causal mask, K2 at decode) and the
``inputs_embeds`` entry, and periods that interleave them (the hybrid
plan, MoE cadences, the VLM's cross-attention cadence); the training loss
(``loss_fn``) with remat per period; expert parallelism (``moe_ffn_ep``,
an explicit all-to-all over the ``model`` axis) and every entry point
under a device mesh (``use_mesh``: the parameters as DTensors, the JAX
package's sharding constraints, the kernels on each rank's local
heads)."""
from .attention import (
    causal_mask,
    cross_attention,
    decode_self_attention,
    gqa,
    init_kv_cache,
    out_proj,
    qkv_proj,
    self_attention,
)
from .init import (
    abstract_params,
    init_layer,
    init_params,
    init_period,
    param_bytes,
    params_from_jax,
    tree_bytes,
)
from .layers import (
    BATCH,
    MODEL,
    cross_entropy_loss,
    embed,
    mlp_forward,
    rms_norm,
    rope,
    pspec,
    shard,
    shard_map,
    unembed,
    use_mesh,
)
from .model import decode_step, forward, loss_fn, prefill
from .moe import load_balance_loss, moe_ffn, router
from .moe_ep import moe_ffn_ep
from .ssm import (
    causal_conv,
    conv_decode_step,
    init_ssm_state,
    mamba_block,
    mamba_block_decode,
    segsum,
    ssd_chunked,
    ssd_decode_step,
)
from .transformer import init_caches, run_blocks, super_block
