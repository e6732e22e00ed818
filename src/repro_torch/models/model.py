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
    tokens: Optional[torch.Tensor],
    cfg,
    *,
    mode: str = "train",
    inputs_embeds: Optional[torch.Tensor] = None,
    frontend: Optional[torch.Tensor] = None,
    caches: Optional[List] = None,
    cache_len: Optional[int] = None,
    window: int = 0,
):
    """Returns (logits, new_caches, aux_loss); aux_loss is the MoE layers'
    summed load-balance loss (fp32, 0 without MoE layers).

    ``inputs_embeds`` (B, S, d) replaces the token embedding (an audio
    frontend's precomputed frame embeddings), cast to ``cfg.dtype``;
    ``frontend`` (B, F, d) feeds the cross-attention layers (a VLM's patch
    embeddings), which raise ``ValueError`` without it.
    """
    if inputs_embeds is not None:
        x = inputs_embeds.to(cfg.dtype)
    else:
        x = embed(params, tokens)
    x, new_caches, aux = run_blocks(
        params, x, cfg, mode=mode, frontend=frontend, caches=caches,
        cache_len=cache_len, window=window,
    )
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = unembed(params, x)
    return logits, new_caches, aux


def prefill(
    params: Dict,
    tokens: Optional[torch.Tensor],
    cfg,
    *,
    max_len: int,
    window: int = 0,
    frontend: Optional[torch.Tensor] = None,
    inputs_embeds: Optional[torch.Tensor] = None,
):
    """Process a prompt, returning (last-position logits, caches, length).
    The prompt is ``tokens`` (B, S), or ``inputs_embeds`` (B, S, d) when
    ``tokens`` is None."""
    prompt = tokens if tokens is not None else inputs_embeds
    B, S = prompt.shape[:2]
    caches = init_caches(cfg, B, max_len, window, device=prompt.device)
    logits, caches, _ = forward(
        params, tokens, cfg, mode="prefill", caches=caches, cache_len=0,
        window=window, frontend=frontend, inputs_embeds=inputs_embeds,
    )
    return logits[:, -1], caches, S


def decode_step(
    params: Dict,
    token: Optional[torch.Tensor],   # (B,) or (B,1) token ids, or None
    caches: List,
    cache_len: int,                  # tokens already in the cache
    cfg,
    *,
    window: int = 0,
    frontend: Optional[torch.Tensor] = None,
    inputs_embeds: Optional[torch.Tensor] = None,   # (B, 1, d) with token=None
):
    """One decode step: returns (logits (B, vocab), caches updated in
    place)."""
    if token is not None and token.dim() == 1:
        token = token[:, None]
    logits, new_caches, _ = forward(
        params, token, cfg, mode="decode", caches=caches,
        cache_len=int(cache_len), window=window, frontend=frontend,
        inputs_embeds=inputs_embeds,
    )
    return logits[:, 0], new_caches
