"""Attention: GQA self-attention (full / sliding-window), decode with
linear or ring-buffer KV caches, and cross-attention to a frontend's
embeddings.

There is one attention path: prefill and training run the K3
``flash_attention`` kernel, decode runs the K2 ``decode_attention`` kernel
(their wrappers take the plain PyTorch versions only for CPU tensors).
Cross-attention takes the same two kernels: K3 without the causal mask
for S > 1 query positions, K2 over all F frontend keys for one.
The projections stay plain matrix products, as XLA computed them outside
any kernel.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..kernels.decode_attention.ops import decode_attention_op
from ..kernels.flash_attention.ops import flash_attention_op
from .layers import rope


# ---------------------------------------------------------------------------
# Projections
# ---------------------------------------------------------------------------
def qkv_proj(params: Dict, x: torch.Tensor, cfg) -> Tuple[torch.Tensor, ...]:
    B, S, _ = x.shape
    H, G, D = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if cfg.qkv_bias:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    return q.view(B, S, H, D), k.view(B, S, G, D), v.view(B, S, G, D)


def out_proj(params: Dict, o: torch.Tensor, cfg) -> torch.Tensor:
    B, S = o.shape[:2]
    return o.reshape(B, S, cfg.n_heads * cfg.hd) @ params["wo"]


# ---------------------------------------------------------------------------
# Train / prefill self-attention
# ---------------------------------------------------------------------------
def self_attention(
    params: Dict,
    x: torch.Tensor,
    cfg,
    *,
    window: int = 0,
    return_cache: bool = False,
):
    B, S, _ = x.shape
    pos = torch.arange(S, device=x.device)
    q, k, v = qkv_proj(params, x, cfg)
    q = rope(q, pos, cfg.rope_theta)
    k = rope(k, pos, cfg.rope_theta)
    o = flash_attention_op(q, k, v, causal=True, window=window)
    y = out_proj(params, o, cfg)
    if return_cache:
        return y, {"k": k, "v": v}
    return y


# ---------------------------------------------------------------------------
# Decode self-attention with KV cache
# ---------------------------------------------------------------------------
def init_kv_cache(cfg, batch: int, max_len: int, window: int = 0,
                  device=None) -> Dict:
    """Linear cache (window=0) or ring buffer of size ``window``."""
    W = window if window else max_len
    shape = (batch, W, cfg.n_kv_heads, cfg.hd)
    return {
        "k": torch.zeros(shape, dtype=cfg.dtype, device=device),
        "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
    }


def decode_self_attention(
    params: Dict,
    x: torch.Tensor,           # (B, 1, d) — the new token's hidden state
    cache: Dict,               # {"k","v"}: (B, W, G, D)
    cache_len: int,            # tokens already in the cache
    cfg,
    *,
    window: int = 0,
) -> Tuple[torch.Tensor, Dict]:
    """Writes the new K/V at its slot in place, then attends over the
    valid cache. For a ring buffer every slot below min(cache_len + 1, W)
    is valid: the JAX mask keeps the same set, and softmax does not depend
    on the ring's order."""
    W = cache["k"].shape[1]
    q, k_new, v_new = qkv_proj(params, x, cfg)
    pos = torch.full((1,), cache_len, dtype=torch.int64, device=x.device)
    q = rope(q, pos, cfg.rope_theta)
    k_new = rope(k_new, pos, cfg.rope_theta)
    slot = cache_len % W if window else cache_len
    cache["k"][:, slot] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][:, slot] = v_new[:, 0].to(cache["v"].dtype)
    kv_len = min(cache_len + 1, W)
    o = decode_attention_op(q, cache["k"], cache["v"], kv_len)
    y = out_proj(params, o, cfg)
    return y, cache


# ---------------------------------------------------------------------------
# Cross-attention (modality frontend consumption; no causal mask, no RoPE)
# ---------------------------------------------------------------------------
def cross_attention(
    params: Dict,
    x: torch.Tensor,           # (B, S, d) decoder states
    frontend: torch.Tensor,    # (B, F, d) precomputed patch/frame embeddings
    cfg,
) -> torch.Tensor:
    """q from the decoder states, K/V from the frontend, recomputed at
    every call (decode included: the layer keeps no cache), as in the JAX
    package. The frontend is taken in the states' dtype, which the kernels
    need for q, k and v alike. One query position (a decode step) runs K2
    with every frontend key valid; K3 at Sq = 1 would fill one row of each
    64-row q tile."""
    B, S, _ = x.shape
    F = frontend.shape[1]
    H, G, D = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    frontend = frontend.to(x.dtype)
    q = (x @ params["wq"]).view(B, S, H, D)
    k = (frontend @ params["wk_cross"]).view(B, F, G, D)
    v = (frontend @ params["wv_cross"]).view(B, F, G, D)
    if S == 1:
        o = decode_attention_op(q, k, v, F)
    else:
        o = flash_attention_op(q, k, v, causal=False)
    return out_proj(params, o, cfg)
