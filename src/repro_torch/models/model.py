"""LM wrapper: embeddings -> blocks -> head; the forward / prefill /
decode entry points the serving engine uses. Cache lengths are Python
ints, so decode steps never wait on the card to learn them."""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from .layers import embed, rms_norm, unembed
from .transformer import init_caches, run_blocks


def forward(
    params: Dict,
    tokens: torch.Tensor,
    cfg,
    *,
    mode: str = "train",
    caches: Optional[List] = None,
    cache_len: Optional[int] = None,
    window: int = 0,
):
    """Returns (logits, new_caches, aux_loss); aux_loss is the MoE layers'
    summed load-balance loss (fp32, 0 without MoE layers)."""
    x = embed(params, tokens)
    x, new_caches, aux = run_blocks(
        params, x, cfg, mode=mode, caches=caches, cache_len=cache_len,
        window=window,
    )
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = unembed(params, x)
    return logits, new_caches, aux


def prefill(
    params: Dict,
    tokens: torch.Tensor,
    cfg,
    *,
    max_len: int,
    window: int = 0,
):
    """Process a prompt, returning (last-position logits, caches, length)."""
    B, S = tokens.shape
    caches = init_caches(cfg, B, max_len, window, device=tokens.device)
    logits, caches, _ = forward(
        params, tokens, cfg, mode="prefill", caches=caches, cache_len=0,
        window=window,
    )
    return logits[:, -1], caches, S


def decode_step(
    params: Dict,
    token: torch.Tensor,         # (B,) or (B,1) token ids
    caches: List,
    cache_len: int,              # tokens already in the cache
    cfg,
    *,
    window: int = 0,
):
    """One decode step: returns (logits (B, vocab), caches updated in
    place)."""
    if token.dim() == 1:
        token = token[:, None]
    logits, new_caches, _ = forward(
        params, token, cfg, mode="decode", caches=caches,
        cache_len=int(cache_len), window=window,
    )
    return logits[:, 0], new_caches
