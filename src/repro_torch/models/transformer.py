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
caches are DTensors in the layout the layers write them in, JAX's
``cache_pspec`` (``_cache_spec``): KV caches as
``attention.kv_cache_spec``, SSM states by heads and conv tails by
channels over ``model``. ``run_blocks`` lays out caches that come in
otherwise once, in the caller's list; those from ``cache_shardings``
already have it and pass through as they are.

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
from ..distributed.sharding import P
from .layers import (
    BATCH,
    MODEL,
    _current_mesh,
    all_gather,
    axis_index,
    lay_out,
    mlp_forward,
    model_rank,
    pspec,
    rms_norm,
    shard,
    shard_map,
)
from .moe import moe_ffn
from .moe_ep import moe_ffn_ep
from .ssm import _project, init_ssm_state, mamba_mix, mamba_mix_decode


def _cache_spec(name: str, shape, stacked: bool):
    """A cache leaf's layout under the active mesh, JAX's ``cache_pspec``:
    KV as the attention layers write it; the SSM state (B, h, p, n) over
    the batch axes and its heads over ``model``; a conv tail (B, w, ch)
    over the batch axes and its channels over ``model`` (each where the
    dimension divides). ``stacked`` leaves carry the leading n_periods
    axis."""
    if name in ("k", "v"):
        return kv_cache_spec(shape)
    lead = (None,) if stacked else ()
    if name == "ssm":
        return pspec(*lead, BATCH, MODEL, None, None, dims=shape)
    return pspec(*lead, BATCH, None, MODEL, dims=shape)


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
    the cache's positions, each rank writes its block of them. A linear
    cache (``window`` 0) takes at most W positions: a longer prefix raises
    ``ValueError`` before any rank writes (the shapes are global, so every
    rank raises alike), as JAX's ``dynamic_update_slice`` refuses it."""
    W, S = c.shape[1], fresh.shape[1]
    if not window and S > W:
        raise ValueError(f"prefill of {S} positions into a linear KV cache of "
                         f"{W} (max_len): S must be at most W")
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
    """The Mamba2 mixer in the JAX package's layout; in prefill and decode
    its SSM state and conv tails replace the cache's in place. Under a
    mesh the projections are products of DTensors under the parameter
    rules (``w_z``, ``w_x``, ``w_dt`` split by columns over ``model``,
    ``w_B``/``w_C`` replicated); the convs, the scan (K4), the skip, the
    gate and the norm run in one ``shard_map`` on each rank's local heads
    and their channels (JAX's ``shard(xin, BATCH, None, MODEL)``), B and C
    whole; ``w_out`` is split by rows, so the output comes out ``Partial``
    and is summed where the residual is constrained. Heads that do not
    divide ``model`` stay whole on every rank. The caches are in
    ``_cache_spec``'s layout (JAX's ``cache_pspec``): a conv tail split by
    channels where its projection is whole on the rank (``conv_B`` and
    ``conv_C`` always) is gathered over ``model`` at decode, and each rank
    writes back its own block."""
    z, xin, Bp, Cp, dt = _project(p, h, cfg)
    heads = pspec(BATCH, None, MODEL, dims=dt.shape)
    chans = pspec(BATCH, None, heads[2], dims=z.shape)
    whole = pspec(BATCH, None, None, dims=Bp.shape)
    local = pspec(heads[2])
    leaf_specs = {"conv_x_w": P(None, heads[2]), "conv_x_b": local, "dt_bias": local,
                  "A_log": local, "D": local, "norm": local}
    names = [k for k in sorted(p) if k.startswith("conv") or k in leaf_specs]
    cnames = sorted(cache) if mode != "train" else []

    def mix(zl, xl, Bl, Cl, dtl, *leaves):
        pl = dict(zip(names, leaves[:len(names)]))
        cl = dict(zip(cnames, leaves[len(names):]))
        if mode == "decode":
            width = {"conv_x": xl.shape[-1], "conv_B": Bl.shape[-1], "conv_C": Cl.shape[-1]}
            state = {k: _gather_block(t, width.get(k)) for k, t in cl.items()}
            y, state = mamba_mix_decode(pl, zl, xl, Bl, Cl, dtl, state, cfg)
        else:
            y, state = mamba_mix(pl, zl, xl, Bl, Cl, dtl, cfg)
        for name in cnames:
            _write_block(cl[name], state[name])
        return y

    specs = ((chans, chans, whole, whole, heads)
             + tuple(leaf_specs.get(k, P(*(None,) * p[k].ndim)) for k in names)
             + tuple(_cache_spec(k, cache[k].shape, stacked=False) for k in cnames))
    y = shard_map(mix, specs, chans, z, xin, Bp, Cp, dt, *(p[k] for k in names),
                  *(cache[k] for k in cnames))
    return (y @ p["w_out"]).to(h.dtype)


def _gather_block(t: torch.Tensor, width: Optional[int]) -> torch.Tensor:
    """A local conv tail (b, w, ch) as ``width`` channels: gathered over
    ``model`` where the rank holds a block of them."""
    if width is None or t.shape[-1] == width:
        return t
    return all_gather(t, t.dim() - 1, MODEL)


def _write_block(c: torch.Tensor, t: torch.Tensor) -> None:
    """Write state ``t`` into local cache leaf ``c``: whole, or this rank's
    block of its last axis where ``c`` holds a block over ``model``."""
    n = c.shape[-1]
    if t.shape[-1] != n:
        t = t[..., model_rank() * n:(model_rank() + 1) * n]
    c.copy_(t)


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
