"""Layer-stack composition over super-blocks of ``cfg.period`` layers,
with parameters and caches stacked along a leading ``n_periods`` axis as
in the JAX package. JAX's ``lax.scan`` over periods becomes a Python loop;
caches are updated in place (PyTorch has no need to rebuild them).

Only attention mixers and MLP channels are ported; the SSM and
cross-attention mixers and the MoE channel raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from .attention import decode_self_attention, init_kv_cache, self_attention
from .layers import mlp_forward, rms_norm

_NOT_PORTED = {
    "ssm": "the Mamba2 SSM mixer (and its K4 ssd_chunk kernel)",
    "cross_attn": "the cross-attention mixer",
    "moe": "the MoE channel",
}


def _not_ported(kind: str) -> NotImplementedError:
    return NotImplementedError(
        f"{_NOT_PORTED[kind]} is not ported to repro_torch yet "
        f"(ROADMAP.md, queue 2)"
    )


def check_supported(cfg) -> None:
    for mixer, channel in cfg.layer_plan():
        if mixer != "attn":
            raise _not_ported(mixer)
        if channel == "moe":
            raise _not_ported(channel)


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------
def init_caches(cfg, batch: int, max_len: int, window: int = 0,
                device=None) -> List:
    """Per-period-position caches with a leading n_periods axis."""
    check_supported(cfg)
    caches: List = []
    for _ in cfg.layer_plan():
        one = init_kv_cache(cfg, batch, max_len, window, device=device)
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
    caches: Optional[List],
    cache_len: Optional[int],
    window: int,
):
    new_caches: List = []
    for j, (mixer, channel) in enumerate(cfg.layer_plan()):
        if mixer != "attn":
            raise _not_ported(mixer)
        p = params_period[j]
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        cache_j = caches[j] if caches is not None else None
        if mode == "decode":
            y, new_cache = decode_self_attention(
                p, h, cache_j, cache_len, cfg, window=window
            )
        elif mode == "prefill":
            y, kv = self_attention(p, h, cfg, window=window, return_cache=True)
            for name in ("k", "v"):
                _write_prefix(cache_j[name], kv[name], window)
            new_cache = cache_j
        else:
            y = self_attention(p, h, cfg, window=window)
            new_cache = cache_j
        x = x + y
        if channel != "none":
            if channel == "moe":
                raise _not_ported(channel)
            h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
            x = x + mlp_forward(p, h2, cfg.mlp)
        new_caches.append(new_cache)
    return x, new_caches


# ---------------------------------------------------------------------------
# Full stack: a loop over periods
# ---------------------------------------------------------------------------
def run_blocks(
    params: Dict,
    x: torch.Tensor,
    cfg,
    *,
    mode: str = "train",
    caches: Optional[List] = None,
    cache_len: Optional[int] = None,
    window: int = 0,
):
    """Returns (hidden, caches). Period i uses leaf[i] of every stacked
    parameter and cache; the caches are the same objects, updated."""
    blocks = params["blocks"]           # leaves: (n_periods, ...)
    for i in range(cfg.n_periods):
        params_period = [{k: a[i] for k, a in p.items()} for p in blocks]
        caches_period = (
            [{k: a[i] for k, a in c.items()} for c in caches]
            if caches is not None else None
        )
        x, _ = super_block(
            params_period, x, cfg, mode=mode, caches=caches_period,
            cache_len=cache_len, window=window,
        )
    return x, caches
