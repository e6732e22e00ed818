"""Layer-stack composition over super-blocks of ``cfg.period`` layers,
with parameters and caches stacked along a leading ``n_periods`` axis as
in the JAX package. JAX's ``lax.scan`` over periods becomes a Python loop;
caches are updated in place (PyTorch has no need to rebuild them).

Attention, cross-attention and SSM mixers, MLP and MoE channels and no
channel at all are ported, in any interleave within a period (the hybrid
plan, MoE cadences, the VLM's cross-attention cadence); each MoE layer's
load-balance loss is summed into the aux that ``run_blocks`` returns. A
cross-attention layer reads the ``frontend`` embeddings and keeps no
cache. With ``cfg.moe_ep`` the MoE channel is ``moe_ep.moe_ffn_ep``
(experts over the ``model`` axis, an explicit all-to-all), which is
``moe_ffn`` with no mesh or a ``model`` axis of 1.

Under a mesh (``layers.use_mesh``) the residual stream is constrained to
``(BATCH, None, None)`` after each add, as in the JAX package, and the
caches are DTensors in the layout the layers write them in: KV caches as
``attention.kv_cache_spec``, SSM states replicated over ``model``
(``_cache_spec``); ``run_blocks`` lays out caches that come in otherwise
(e.g. from ``cache_shardings``) once, in the caller's list.

``remat`` wraps each period in ``torch.utils.checkpoint`` (non-reentrant):
its activations are recomputed in the backward pass, as JAX's
``jax.checkpoint`` around the scan body. ``cfg.remat_policy`` chooses what
JAX keeps across that recompute; it changes memory and time, not values,
and the port recomputes the whole period whatever it says.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch
from torch.utils.checkpoint import checkpoint

from .attention import (
    cross_attention,
    decode_self_attention,
    init_kv_cache,
    kv_cache_spec,
    kv_seq_axes,
    self_attention,
)
from .layers import (
    BATCH,
    MODEL,
    _current_mesh,
    axis_index,
    lay_out,
    mlp_forward,
    pspec,
    rms_norm,
    shard,
    shard_map,
)
from .moe import moe_ffn
from .moe_ep import moe_ffn_ep
from .ssm import init_ssm_state, mamba_block, mamba_block_decode


def _cache_spec(name: str, shape, stacked: bool):
    """A cache leaf's layout under the active mesh: KV as the attention
    layers write it, SSM states and conv tails over the batch axes only.
    ``stacked`` leaves carry the leading n_periods axis."""
    if name in ("k", "v"):
        return kv_cache_spec(shape)
    lead = (None,) if stacked else ()
    return pspec(*lead, BATCH, *(None,) * (len(shape) - len(lead) - 1), dims=shape)


def _laid_out(name: str, a: torch.Tensor) -> torch.Tensor:
    """Stacked cache leaf ``a`` as a DTensor in ``_cache_spec`` layout on
    the active mesh (itself when it has it)."""
    return lay_out(a, _cache_spec(name, a.shape, stacked=True))


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------
def init_caches(cfg, batch: int, max_len: int, window: int = 0,
                device=None) -> List:
    """Per-period-position caches with a leading n_periods axis."""
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
    if _current_mesh() is not None:
        caches = [{k: _laid_out(k, a) for k, a in c.items()} for c in caches]
    return caches


def _write_prefix(c: torch.Tensor, fresh: torch.Tensor, window: int) -> None:
    """Write prefix KV into cache ``c`` in place. For a ring buffer
    (window mode) only the last W positions survive, placed at slot =
    position % W so decode continues seamlessly. Where kv_seq_shard splits
    the cache's positions, each rank writes its block of them."""
    W = c.shape[1]
    spec = kv_cache_spec(c.shape)
    seq = kv_seq_axes(spec)

    def write(cl, fl):
        fl = fl.to(cl.dtype)
        S = fl.shape[1]
        if window and S >= W:
            fl = torch.roll(fl[:, S - W:], S % W, dims=1)
        lo = axis_index(*seq) * cl.shape[1]
        part = fl[:, lo:lo + cl.shape[1]]
        cl[:, :part.shape[1]] = part

    shard_map(write, (spec, pspec(BATCH, None, MODEL, None, dims=fresh.shape)), None,
              c, fresh)


def _ssm_mixer(p: Dict, h: torch.Tensor, cfg, mode: str, cache: Optional[Dict]):
    """The Mamba2 mixer; in prefill and decode its SSM state and conv tails
    replace the cache's in place. Under a mesh it runs in one
    ``shard_map``, batch over the data axes and replicated over ``model``
    (its weights gathered there), K4 on each rank's local batch."""
    names, cnames = sorted(p), sorted(cache) if mode != "train" else []

    def local(hl, *leaves):
        pl = dict(zip(names, leaves[:len(names)]))
        cl = dict(zip(cnames, leaves[len(names):]))
        if mode == "train":
            return mamba_block(pl, hl, cfg)
        if mode == "decode":
            y, state = mamba_block_decode(pl, hl, cl, cfg)
        else:
            y, state = mamba_block(pl, hl, cfg, return_state=True)
        for name, t in state.items():
            cl[name].copy_(t)
        return y

    h_spec = pspec(BATCH, None, None, dims=h.shape)
    specs = ((h_spec,) + tuple(pspec(*(None,) * p[k].ndim) for k in names)
             + tuple(_cache_spec(k, cache[k].shape, stacked=False) for k in cnames))
    return shard_map(local, specs, h_spec, h, *(p[k] for k in names),
                     *(cache[k] for k in cnames))


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
    new_caches: List = []
    aux = None
    for j, (mixer, channel) in enumerate(cfg.layer_plan()):
        p = params_period[j]
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        cache_j = caches[j] if caches is not None else None
        if mixer == "cross_attn":    # every mode; its cache ({}) is unchanged
            y = cross_attention(p, h, frontend, cfg)
        elif mixer == "ssm":
            y = _ssm_mixer(p, h, cfg, mode, cache_j)
        elif mode == "train":
            y = self_attention(p, h, cfg, window=window)
        elif mode == "decode":
            y, _ = decode_self_attention(
                p, h, cache_j, cache_len, cfg, window=window
            )
        else:
            y, kv = self_attention(p, h, cfg, window=window, return_cache=True)
            for name in ("k", "v"):
                _write_prefix(cache_j[name], kv[name], window)
        x = shard(x + y, BATCH, None, None)
        if channel == "moe":
            h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
            ffn = moe_ffn_ep if cfg.moe_ep else moe_ffn
            y2, aux_j = ffn(p, h2, cfg, return_aux=True)
            x = shard(x + y2, BATCH, None, None)
            aux = aux_j if aux is None else aux + aux_j
        elif channel != "none":
            h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
            x = shard(x + mlp_forward(p, h2, cfg.mlp), BATCH, None, None)
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
    remat: bool = False,
):
    """Returns (hidden, caches, aux_loss). Period i uses leaf[i] of every
    stacked parameter and cache; the caches are the same objects, updated.
    aux_loss is the sum of the MoE layers' load-balance losses (fp32; 0
    without MoE layers). ``frontend`` (B, F, d) feeds the cross-attention
    layers; a model that has one raises ``ValueError`` without it.
    ``remat`` recomputes each period in the backward pass (when autograd
    records)."""
    if frontend is None and any(m == "cross_attn" for m, _ in cfg.layer_plan()):
        raise ValueError(
            f"{cfg.name} has cross-attention layers: pass frontend=(B, F, d_model) "
            f"embeddings"
        )
    # leaves: (n_periods, ...), unbound once: the backward of unbind stacks
    # the periods' gradients in one pass, where indexing each period would
    # add a zero-filled gradient of the whole stacked leaf per period
    blocks = [{k: a.unbind(0) for k, a in p.items()} for p in params["blocks"]]
    if caches is not None and _current_mesh() is not None:
        for c in caches:
            c.update({k: _laid_out(k, a) for k, a in c.items()})
    aux = None
    for i in range(cfg.n_periods):
        params_period = [{k: a[i] for k, a in p.items()} for p in blocks]
        caches_period = (
            [{k: a[i] for k, a in c.items()} for c in caches]
            if caches is not None else None
        )
        kw = dict(mode=mode, frontend=frontend, caches=caches_period,
                  cache_len=cache_len, window=window)
        if remat and torch.is_grad_enabled():
            x, _, aux_i = checkpoint(super_block, params_period, x, cfg,
                                     use_reentrant=False, **kw)
        else:
            x, _, aux_i = super_block(params_period, x, cfg, **kw)
        if aux_i is not None:
            aux = aux_i if aux is None else aux + aux_i
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, caches, aux
