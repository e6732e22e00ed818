"""LM wrapper: embeddings -> blocks -> head; the training loss and the
forward / prefill / decode entry points the trainer and the serving engine
use. Cache lengths are Python ints, so decode steps never wait on the card
to learn them."""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from .layers import (
    BATCH,
    MODEL,
    as_global,
    cross_entropy_loss,
    embed,
    rms_norm,
    shard,
    unembed,
)
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
    remat: bool = False,
):
    """Returns (logits, new_caches, aux_loss); aux_loss is the MoE layers'
    summed load-balance loss (fp32, 0 without MoE layers). ``remat``
    recomputes each period's activations in the backward pass in place of
    keeping them.

    ``inputs_embeds`` (B, S, d) replaces the token embedding (an audio
    frontend's precomputed frame embeddings), cast to ``cfg.dtype``;
    ``frontend`` (B, F, d) feeds the cross-attention layers (a VLM's patch
    embeddings), which raise ``ValueError`` without it.

    Under a mesh (``layers.use_mesh``, with the parameters as DTensors)
    plain token ids and embeddings are taken as the global batch, every
    rank holding it whole, and the logits come back as a DTensor with the
    vocabulary over ``model``.
    """
    if inputs_embeds is not None:
        x = as_global(inputs_embeds, BATCH, None, None).to(cfg.dtype)
    else:
        x = embed(params, as_global(tokens, BATCH, None))
    x = shard(x, BATCH, None, None)
    x, new_caches, aux = run_blocks(
        params, x, cfg, mode=mode, frontend=frontend, caches=caches,
        cache_len=cache_len, window=window, remat=remat,
    )
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = unembed(params, x)
    logits = shard(logits, BATCH, None, MODEL)
    return logits, new_caches, aux


# ---------------------------------------------------------------------------
def loss_fn(
    params: Dict,
    batch: Dict,
    cfg,
    *,
    aux_weight: float = 0.01,
    remat: bool = True,
):
    """Cross-entropy of ``batch["labels"]`` (under ``batch["mask"]`` when
    given) plus ``aux_weight`` times the MoE load-balance loss. Returns
    (loss, {"ce", "aux"}), as the JAX package's ``loss_fn``."""
    logits, _, aux = forward(
        params, batch["tokens"], cfg, mode="train",
        frontend=batch.get("frontend"),
        inputs_embeds=batch.get("inputs_embeds"),
        remat=remat,
    )
    ce = cross_entropy_loss(logits, batch["labels"], batch.get("mask"))
    return ce + aux_weight * aux, {"ce": ce, "aux": aux}


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
