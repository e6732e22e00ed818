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

Under a mesh (``layers.use_mesh``) q, k and v carry the JAX package's
``shard`` constraints (heads over ``model`` where they divide it, batch
over the data axes), the KV caches the layout of ``kv_cache_spec`` (JAX's
``cache_pspec``: with kv_seq_shard, where the KV heads do not divide the
``model`` axis, the positions are split over it instead), and each kernel
call runs through ``shard_map`` on each rank's local heads
(``_per_head``), attention being independent per head.

``gqa`` and ``causal_mask`` are the JAX package's XLA attention (its
default, ``attn_impl = "xla"``), in plain PyTorch with JAX's roundings: a
reference the tests and ``chip_smoke.py`` hold the kernels' bf16 results
to, not a path. The model reads no ``attn_impl``: K3 and K2 serve and train
on every device, so no served path gives way to ``gqa``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..kernels.decode_attention.ops import decode_attention_op
from ..kernels.flash_attention.ops import flash_attention_op
from .layers import (
    BATCH,
    MODEL,
    all_gather,
    axis_index,
    mesh_axis_sizes,
    model_rank,
    pspec,
    rope,
    shard,
    shard_map,
    split_last,
)


NEG_INF = -1e30


def kv_cache_spec(shape):
    """The spec of a KV cache (B, T, G, D) (or one with leading axes) under
    the active mesh, as distributed.sharding.cache_pspec lays it out:
    heads over ``model`` when they divide it; otherwise, with the
    kv_seq_shard option on, the sequence axis over ``model`` (the batch
    over the batch axes), or over ("data", "model") where the batch axes do
    not divide B."""
    from ..distributed.sharding import OPT

    lead = (None,) * (len(shape) - 4)
    m = mesh_axis_sizes().get(MODEL, 1)
    if m > 1 and shape[-2] % m != 0 and OPT["kv_seq_shard"]:
        if pspec(BATCH, dims=shape[-4:-3])[0] is not None:
            return pspec(*lead, BATCH, MODEL, None, None, dims=shape)
        return pspec(*lead, None, ("data", MODEL), None, None, dims=shape)
    return pspec(*lead, BATCH, None, MODEL, None, dims=shape)


def kv_seq_axes(spec) -> Tuple[str, ...]:
    """The mesh axes a KV cache spec splits the sequence axis over, major
    first (none unless kv_seq_shard put it there): each rank holds block
    ``axis_index(*axes)`` of the positions."""
    e = spec[-3]
    return () if e is None else (e,) if isinstance(e, str) else tuple(e)


def shard_kv_cache(x: torch.Tensor) -> torch.Tensor:
    """A KV cache (B, T, G, D) constrained to ``kv_cache_spec``'s layout
    (JAX's ``shard_kv_cache``): the identity with no mesh."""
    return shard(x, *kv_cache_spec(x.shape))


def _per_head(fn, q, k, v, *caches):
    """``fn(q, k, v, *caches, kv_heads)`` on each rank's local heads: q, k
    and v as ``shard(x, BATCH, None, MODEL, None)`` lays them out (every
    key position on every rank), the caches (B, T, G, D) as
    ``kv_cache_spec`` (a block of the positions where kv_seq_shard splits
    them). ``kv_heads`` maps a local (B, T, G,
    D) tensor to the KV heads of the local q heads: where q's heads are
    split over ``model`` and the G KV heads are not (G % m != 0), a rank's
    q heads [r*H/m, (r+1)*H/m) belong to KV heads [r*H/m // R, ...]
    (R = H/G), taken from the replicated tensor (never heads 0..);
    elsewhere it is the identity."""
    H, G = q.shape[2], k.shape[2]
    q_spec = pspec(BATCH, None, MODEL, None, dims=q.shape)
    kv_spec = pspec(BATCH, None, MODEL, None, dims=k.shape)

    def local(ql, kl, vl, *cl):
        kv_heads = _identity
        if q_spec[2] is not None and kv_spec[2] is None:
            R, Hl = H // G, ql.shape[2]
            first = model_rank() * Hl
            if Hl % R == 0 or R % Hl == 0:      # whole KV groups, or inside one
                pick = slice(first // R, first // R + max(1, Hl // R))
            else:                               # heads straddle groups unevenly
                pick = (first + torch.arange(Hl, device=ql.device)) // R

            def kv_heads(t):
                return t[:, :, pick].contiguous()
        return fn(ql, kl, vl, *cl, kv_heads)

    cache_specs = tuple(kv_cache_spec(c.shape) for c in caches)
    return shard_map(local, (q_spec, kv_spec, kv_spec) + cache_specs, q_spec,
                     q, k, v, *caches)


def _identity(t):
    return t


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
    q = shard(split_last(q, H, D), BATCH, None, MODEL, None)
    k = shard(split_last(k, G, D), BATCH, None, MODEL, None)
    v = shard(split_last(v, G, D), BATCH, None, MODEL, None)
    return q, k, v


def out_proj(params: Dict, o: torch.Tensor, cfg) -> torch.Tensor:
    B, S = o.shape[:2]
    return o.reshape(B, S, cfg.n_heads * cfg.hd) @ params["wo"]


# ---------------------------------------------------------------------------
# The JAX package's XLA attention (a reference; the model runs K3/K2)
# ---------------------------------------------------------------------------
def gqa(
    q: torch.Tensor,                  # (B, Sq, H, D)
    k: torch.Tensor,                  # (B, T, G, D)
    v: torch.Tensor,                  # (B, T, G, D)
    mask: Optional[torch.Tensor],     # broadcastable to (B, 1, 1, Sq, T)
) -> torch.Tensor:
    """Grouped attention as JAX's ``gqa`` rounds it: the scores' product in
    the inputs' dtype, then fp32 and the D^-0.5 scale; masked entries
    ``NEG_INF``; softmax in fp32; the probabilities cast to ``v``'s dtype
    before PV. Heads grouped (B, Sq, G, R, D); no KV head is repeated."""
    B, Sq, H, D = q.shape
    G = k.shape[2]
    qg = q.reshape(B, Sq, G, H // G, D)
    scores = torch.einsum("bsgrd,btgd->bgrst", qg, k).float() * D ** -0.5
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    o = torch.einsum("bgrst,btgd->bsgrd", p.to(v.dtype), v)
    return o.reshape(B, Sq, H, D)


def causal_mask(q_pos: torch.Tensor, kv_pos: torch.Tensor,
                window: int = 0) -> torch.Tensor:
    """(Sq,) and (T,) positions -> a (1, 1, 1, Sq, T) mask: a key at or
    before the query, and within ``window`` of it (0: unlimited)."""
    m = kv_pos[None, :] <= q_pos[:, None]
    if window:
        m &= kv_pos[None, :] > q_pos[:, None] - window
    return m[None, None, None]


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
    o = _per_head(lambda ql, kl, vl, kv: flash_attention_op(
        ql, kv(kl), kv(vl), causal=True, window=window), q, k, v)
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
    on the ring's order. Under a mesh the caches must already have the
    layout of ``kv_cache_spec`` (``transformer.run_blocks`` sees to it), so
    the write lands in each rank's local block. Where kv_seq_shard splits
    the positions, only the rank whose block holds the slot writes, and the
    blocks are gathered over the sequence axes for K2 (every rank then
    attends over the whole valid cache of its local heads). A linear cache
    (``window`` 0) that is full (``cache_len`` >= W) raises ``ValueError``
    before anything is written; JAX's ``dynamic_update_slice`` clamps the
    slot there and overwrites the last position's K/V."""
    W = cache["k"].shape[1]
    if not window and cache_len >= W:
        raise ValueError(f"decode at cache_len {cache_len} into a full linear KV "
                         f"cache of {W} (max_len): cache_len must be below W")
    q, k_new, v_new = qkv_proj(params, x, cfg)
    pos = torch.full((1,), cache_len, dtype=torch.int64, device=x.device)
    q = rope(q, pos, cfg.rope_theta)
    k_new = rope(k_new, pos, cfg.rope_theta)
    slot = cache_len % W if window else cache_len
    kv_len = min(cache_len + 1, W)
    seq = kv_seq_axes(kv_cache_spec(cache["k"].shape))

    def write_and_attend(ql, kn, vn, kc, vc, kv):
        at = slot - axis_index(*seq) * kc.shape[1]     # the slot in this rank's positions
        if 0 <= at < kc.shape[1]:
            kc[:, at] = kn[:, 0].to(kc.dtype)
            vc[:, at] = vn[:, 0].to(vc.dtype)
        kc, vc = all_gather(kc, 1, *seq), all_gather(vc, 1, *seq)
        return decode_attention_op(ql, kv(kc), kv(vc), kv_len)

    o = _per_head(write_and_attend, q, k_new, v_new, cache["k"], cache["v"])
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
    q = shard(split_last(x @ params["wq"], H, D), BATCH, None, MODEL, None)
    k = split_last(frontend @ params["wk_cross"], G, D)
    v = split_last(frontend @ params["wv_cross"], G, D)
    if S == 1:
        o = _per_head(lambda ql, kl, vl, kv: decode_attention_op(ql, kv(kl), kv(vl), F),
                      q, k, v)
    else:
        o = _per_head(lambda ql, kl, vl, kv: flash_attention_op(
            ql, kv(kl), kv(vl), causal=False), q, k, v)
    return out_proj(params, o, cfg)
