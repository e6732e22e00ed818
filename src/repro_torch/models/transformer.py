"""Layer-stack composition over super-blocks of ``cfg.period`` layers,
with parameters and caches stacked along a leading ``n_periods`` axis as
in the JAX package. JAX's ``lax.scan`` over periods becomes a Python loop;
caches are updated in place (PyTorch has no need to rebuild them).

Attention, cross-attention and SSM mixers, MLP and MoE channels and no
channel at all are ported, in any interleave within a period (the hybrid
plan, MoE cadences, the VLM's cross-attention cadence); each MoE layer's
load-balance loss is summed into the aux that ``run_blocks`` returns. A
cross-attention layer reads the ``frontend`` embeddings and keeps no
cache. Expert parallelism (``cfg.moe_ep``) raises ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from .attention import (
    cross_attention,
    decode_self_attention,
    init_kv_cache,
    self_attention,
)
from .layers import mlp_forward, rms_norm
from .moe import moe_ffn
from .ssm import init_ssm_state, mamba_block, mamba_block_decode


def check_supported(cfg) -> None:
    if cfg.moe_ep and any(channel == "moe" for _, channel in cfg.layer_plan()):
        raise NotImplementedError(
            "expert-parallel MoE, moe_ep=True (ROADMAP.md, queue 1 item 12) "
            "is not ported to repro_torch yet"
        )


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------
def init_caches(cfg, batch: int, max_len: int, window: int = 0,
                device=None) -> List:
    """Per-period-position caches with a leading n_periods axis."""
    check_supported(cfg)
    caches: List = []
    for mixer, _ in cfg.layer_plan():
        if mixer == "attn":
            one = init_kv_cache(cfg, batch, max_len, window, device=device)
        elif mixer == "ssm":
            one = init_ssm_state(cfg, batch, device=device)
        else:                            # cross_attn has no mutable state
            one = {}
        caches.append({
            name: torch.zeros((cfg.n_periods,) + tuple(a.shape), dtype=a.dtype,
                              device=a.device)
            for name, a in one.items()
        })
    return caches


def _write_prefix(c: torch.Tensor, fresh: torch.Tensor, window: int) -> None:
    """Write prefix KV into cache ``c`` in place. For a ring buffer
    (window mode) only the last W positions survive, placed at slot =
    position % W so decode continues seamlessly."""
    fresh = fresh.to(c.dtype)
    S, W = fresh.shape[1], c.shape[1]
    if window and S >= W:
        c.copy_(torch.roll(fresh[:, S - W:], S % W, dims=1))
    else:
        c[:, :S] = fresh


# ---------------------------------------------------------------------------
# One super-block (cfg.period layers)
# ---------------------------------------------------------------------------
def super_block(
    params_period: List[Dict],
    x: torch.Tensor,
    cfg,
    *,
    mode: str,                       # train | prefill | decode
    frontend: Optional[torch.Tensor],
    caches: Optional[List],
    cache_len: Optional[int],
    window: int,
):
    """Returns (hidden, caches, aux): aux is the period's summed MoE
    load-balance loss, None when the period has no MoE layer."""
    check_supported(cfg)
    new_caches: List = []
    aux = None
    for j, (mixer, channel) in enumerate(cfg.layer_plan()):
        p = params_period[j]
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        cache_j = caches[j] if caches is not None else None
        if mixer == "cross_attn":    # every mode; its cache ({}) is unchanged
            y = cross_attention(p, h, frontend, cfg)
        elif mode == "train":
            y = (self_attention(p, h, cfg, window=window) if mixer == "attn"
                 else mamba_block(p, h, cfg))
        elif mixer == "attn" and mode == "decode":
            y, _ = decode_self_attention(
                p, h, cache_j, cache_len, cfg, window=window
            )
        elif mixer == "attn":
            y, kv = self_attention(p, h, cfg, window=window, return_cache=True)
            for name in ("k", "v"):
                _write_prefix(cache_j[name], kv[name], window)
        else:
            # the SSM state and conv tails replace the cache's in place
            if mode == "decode":
                y, state = mamba_block_decode(p, h, cache_j, cfg)
            else:
                y, state = mamba_block(p, h, cfg, return_state=True)
            for name, t in state.items():
                cache_j[name].copy_(t)
        x = x + y
        if channel == "moe":
            h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
            y2, aux_j = moe_ffn(p, h2, cfg, return_aux=True)
            x = x + y2
            aux = aux_j if aux is None else aux + aux_j
        elif channel != "none":
            h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
            x = x + mlp_forward(p, h2, cfg.mlp)
        new_caches.append(cache_j)
    return x, new_caches, aux


# ---------------------------------------------------------------------------
# Full stack: a loop over periods
# ---------------------------------------------------------------------------
def run_blocks(
    params: Dict,
    x: torch.Tensor,
    cfg,
    *,
    mode: str = "train",
    frontend: Optional[torch.Tensor] = None,
    caches: Optional[List] = None,
    cache_len: Optional[int] = None,
    window: int = 0,
):
    """Returns (hidden, caches, aux_loss). Period i uses leaf[i] of every
    stacked parameter and cache; the caches are the same objects, updated.
    aux_loss is the sum of the MoE layers' load-balance losses (fp32; 0
    without MoE layers). ``frontend`` (B, F, d) feeds the cross-attention
    layers; a model that has one raises ``ValueError`` without it."""
    if frontend is None and any(m == "cross_attn" for m, _ in cfg.layer_plan()):
        raise ValueError(
            f"{cfg.name} has cross-attention layers: pass frontend=(B, F, d_model) "
            f"embeddings"
        )
    blocks = params["blocks"]           # leaves: (n_periods, ...)
    aux = None
    for i in range(cfg.n_periods):
        params_period = [{k: a[i] for k, a in p.items()} for p in blocks]
        caches_period = (
            [{k: a[i] for k, a in c.items()} for c in caches]
            if caches is not None else None
        )
        x, _, aux_i = super_block(
            params_period, x, cfg, mode=mode, frontend=frontend,
            caches=caches_period, cache_len=cache_len, window=window,
        )
        if aux_i is not None:
            aux = aux_i if aux is None else aux + aux_i
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, caches, aux
