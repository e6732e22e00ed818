"""Abstract input specs for every (architecture x input-shape) combination
— empty tensors on the meta device, torch's ``ShapeDtypeStruct``: a shape
and a dtype, nothing allocated — plus the step callables the dry-run runs.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from ..configs import InputShape, ModelConfig
from ..models import decode_step, init_caches, prefill
from ..models.init import abstract_params
from ..training.optimizer import AdamWConfig, init_adamw
from ..training.train_loop import TrainConfig, make_train_step


def sds(shape, dtype=torch.int32) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def effective_window(cfg: ModelConfig, shape: InputShape) -> int:
    """Sliding window applies to dense-family archs at 500k decode."""
    return cfg.attn_window


def cache_len_for(cfg: ModelConfig, shape: InputShape) -> int:
    """Device-side KV length: ring window if windowed, else full seq."""
    w = effective_window(cfg, shape)
    return min(w, shape.seq_len) if w else shape.seq_len


def input_specs(
    cfg: ModelConfig, shape: InputShape
) -> Dict[str, Any]:
    """Abstract inputs for the step function of this shape's kind."""
    B, S = shape.global_batch, shape.seq_len
    d = cfg.d_model
    if shape.kind == "train":
        batch: Dict[str, Any] = {
            "tokens": sds((B, S)),
            "labels": sds((B, S)),
        }
        if cfg.cross_attn_every:
            batch["frontend"] = sds((B, cfg.n_frontend_tokens, d), cfg.dtype)
        if cfg.family == "audio":
            # frame embeddings from the (stubbed) codec frontend
            batch["inputs_embeds"] = sds((B, S, d), cfg.dtype)
        return {"batch": batch}
    if shape.kind == "prefill":
        out: Dict[str, Any] = {"tokens": sds((B, S))}
        if cfg.cross_attn_every:
            out["frontend"] = sds((B, cfg.n_frontend_tokens, d), cfg.dtype)
        if cfg.family == "audio":
            out["inputs_embeds"] = sds((B, S, d), cfg.dtype)
        return out
    # decode: ONE new token against a seq_len KV cache
    W = effective_window(cfg, shape)
    out = {
        "token": sds((B,)),
        "caches": init_caches(cfg, B, S, W, device="meta"),
        "cache_len": sds((), torch.int32),
    }
    if cfg.cross_attn_every:
        out["frontend"] = sds((B, cfg.n_frontend_tokens, d), cfg.dtype)
    return out


# ---------------------------------------------------------------------------
# Step callables
# ---------------------------------------------------------------------------
def make_step(cfg: ModelConfig, shape: InputShape) -> Tuple[Callable, str]:
    """Returns (fn, kind). Signatures:
    train:   fn(params, opt_state, batch) -> (params, opt_state, metrics)
    prefill: fn(params, **specs) -> (logits, caches, cache_len)
    decode:  fn(params, token, caches, cache_len[, frontend]) ->
             (logits, caches)
    A decode step's ``cache_len`` is read on the host (an int, or a tensor
    off the meta device): the port's caches are written at a Python index.
    """
    W = effective_window(cfg, shape)
    if shape.kind == "train":
        tc = TrainConfig(remat=True, opt=AdamWConfig())
        return make_train_step(cfg, tc), "train"
    if shape.kind == "prefill":
        def prefill_step(params, tokens, frontend=None, inputs_embeds=None):
            return prefill(
                params, tokens, cfg, max_len=shape.seq_len, window=W,
                frontend=frontend, inputs_embeds=inputs_embeds,
            )
        return prefill_step, "prefill"

    def serve_step(params, token, caches, cache_len, frontend=None):
        return decode_step(
            params, token, caches, cache_len, cfg, window=W,
            frontend=frontend,
        )
    return serve_step, "decode"


def abstract_state(cfg: ModelConfig, with_opt: bool = False):
    params = abstract_params(cfg)
    if not with_opt:
        return params
    return params, init_adamw(params)
