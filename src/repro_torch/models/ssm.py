"""Mamba2 / SSD (state-space duality) token mixer [arXiv:2405.21060].

Chunked SSD: within a chunk the recurrence is computed in its quadratic
dual form by the K4 ``ssd_chunk`` kernel; across chunks a linear scan in
fp32 carries the (heads, headdim, dstate) state (``kernels/ssd_chunk/
ops.py``). Decode is the O(1) recurrent update. The projections stay
separate (w_z/w_x/w_B/w_C/w_dt), as in the JAX package, so both run on the
same parameter tree. Dtypes follow the JAX package: ``A_log`` is fp32, so
the decays are fp32, and the SSM state is kept in ``cfg.dtype`` between
steps.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels.ssd_chunk.ops import ssd_op
from .layers import MODEL, model_rank, psum_varying, rms_norm


# ---------------------------------------------------------------------------
# SSD core
# ---------------------------------------------------------------------------
def segsum(a: torch.Tensor) -> torch.Tensor:
    """(..., l) log-decays -> (..., l, l) cumulative segment sums;
    entry [i, j] = a[j+1] + ... + a[i] for i >= j, -inf above diagonal."""
    l = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((l, l), dtype=torch.bool, device=a.device))
    return torch.where(mask, diff, torch.full_like(diff, -float("inf")))


# The JAX model's name for chunked SSD: (xbar (b,l,h,p), a (b,l,h), B and C
# (b,l,g,n), chunk, initial_state (b,h,p,n)) -> (y, final_state in xbar's
# dtype). mamba_block calls ``ssd_op`` by its module name, so a test can
# patch the plain version in.
ssd_chunked = ssd_op


def ssd_decode_step(
    state: torch.Tensor,   # (b, h, p, n)
    x: torch.Tensor,       # (b, h, p) new token input
    dt: torch.Tensor,      # (b, h)
    a: torch.Tensor,       # (b, h) log decay
    B: torch.Tensor,       # (b, g, n)
    C: torch.Tensor,       # (b, g, n)
) -> Tuple[torch.Tensor, torch.Tensor]:
    r = state.shape[1] // B.shape[1]
    Bh = B.repeat_interleave(r, dim=1)                          # (b, h, n)
    Ch = C.repeat_interleave(r, dim=1)
    xbar = x * dt[..., None]
    state = state * torch.exp(a)[..., None, None] + torch.einsum(
        "bhp,bhn->bhpn", xbar, Bh
    )
    y = torch.einsum("bhpn,bhn->bhp", state, Ch.to(state.dtype))
    return y, state


# ---------------------------------------------------------------------------
# Depthwise causal conv (width cfg.conv_width)
# ---------------------------------------------------------------------------
def causal_conv(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                tail: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: (b, l, ch), w: (width, ch) depthwise. Causal: the positions before
    x are ``tail`` (b, width-1, ch), the raw inputs a state carries, or
    zeros without one. A zero tail gives the same bits as none: the conv
    reads one contiguous (b, ch, l+width-1) tensor of the same values."""
    width = w.shape[0]
    if tail is None:
        xp = F.pad(x.transpose(1, 2), (width - 1, 0))           # (b, ch, l+w-1)
    else:
        xp = torch.cat([tail.to(x.dtype), x], dim=1).transpose(1, 2).contiguous()
    out = F.conv1d(xp, w.t()[:, None, :], groups=x.shape[-1])    # (b, ch, l)
    return out.transpose(1, 2).contiguous() + bias


def conv_decode_step(
    conv_state: torch.Tensor,   # (b, width-1, ch)
    x_new: torch.Tensor,        # (b, 1, ch)
    w: torch.Tensor,
    bias: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    window = torch.cat([conv_state, x_new], dim=1)              # (b, width, ch)
    y = torch.einsum("bwc,wc->bc", window, w)[:, None, :] + bias
    return y, window[:, 1:, :]


# ---------------------------------------------------------------------------
# Full Mamba2 block
# ---------------------------------------------------------------------------
def _project(params: Dict, x: torch.Tensor, cfg):
    z = x @ params["w_z"]
    xin = x @ params["w_x"]
    Bp = x @ params["w_B"]
    Cp = x @ params["w_C"]
    dt = x @ params["w_dt"]
    return z, xin, Bp, Cp, dt


def _tail(x: torch.Tensor, n: int) -> torch.Tensor:
    """The last ``n`` positions of (b, l, ch), zero-filled on the left when
    l < n (what the causal conv's padding holds there)."""
    t = x[:, max(x.shape[1] - n, 0):]
    return F.pad(t, (0, 0, n - t.shape[1], 0)) if t.shape[1] < n else t


def _groups_of_heads(t: torch.Tensor, h: int, cfg) -> torch.Tensor:
    """B or C (b, ..., g, n) for the ``h`` local heads: the whole tensor
    when they are all of them or there is one group; else head j's group
    (model_rank * h + j) // (H / g) for each local head, one group a head."""
    H, g = cfg.ssm_heads, cfg.ssm_groups
    if h == H or g == 1:
        return t
    first = model_rank() * h
    return t[..., (first + torch.arange(h, device=t.device)) // (H // g), :]


def _gated_norm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor, cfg):
    """rms_norm(y * silu(z)) over all d_inner channels. Where a rank holds
    a block of them (the heads split over ``model``), the fp32 sum of
    squares of each block is summed over ``model`` in rank order."""
    g = y * F.silu(z)
    width = cfg.ssm_d_inner
    if g.shape[-1] == width:
        return rms_norm(g, scale, cfg.norm_eps)
    x32 = g.float()
    var = psum_varying(x32.square().sum(dim=-1, keepdim=True), MODEL) / width
    return (x32 * torch.rsqrt(var + cfg.norm_eps) * scale.float()).to(g.dtype)


def mamba_mix(params: Dict, z, xin_raw, Bp_raw, Cp_raw, dt, cfg,
              initial_state: Optional[Dict] = None):
    """The mixer between its projections, on the heads that ``dt`` (b, l,
    h) holds and their channels (``z``, ``xin_raw``, ``params``' per-head
    and per-channel leaves alike; B and C whole): the depthwise convs, the
    SSD scan (K4 through ``ssd_op``), the skip, the gate and the norm.
    Returns (y (b, l, h*p) before ``w_out``, the state in
    ``init_ssm_state``'s schema for these heads)."""
    b, l, h = dt.shape
    p, n = cfg.ssm_head_dim, cfg.ssm_state
    tail = cfg.conv_width - 1
    raw = {"conv_x": xin_raw, "conv_B": Bp_raw, "conv_C": Cp_raw}
    # a prefill continued from a state: the state's conv tails (each as wide
    # as its projection here: the rank's channels of conv_x under the
    # head-parallel mixer) precede the new positions, so two prefills equal
    # one. The JAX package's mamba_block reads only the ssm state here.
    tails = {k: None if initial_state is None else initial_state[k] for k in raw}
    xin, Bp, Cp = (F.silu(causal_conv(raw[k], params[k + "_w"], params[k + "_b"], tails[k]))
                   for k in raw)
    dt = F.softplus(dt + params["dt_bias"])                      # (b, l, h)
    a = -torch.exp(params["A_log"]) * dt                         # fp32
    xh = xin.reshape(b, l, h, p)
    xbar = xh * dt[..., None]
    s0 = initial_state["ssm"] if initial_state is not None else None
    y, final_ssm = ssd_op(
        xbar, a, _groups_of_heads(Bp.reshape(b, l, -1, n), h, cfg),
        _groups_of_heads(Cp.reshape(b, l, -1, n), h, cfg), cfg.ssm_chunk, s0,
    )
    y = y + params["D"][:, None] * xh                            # skip
    y = y.reshape(b, l, h * p).to(z.dtype)
    # conv tails: the last (width-1) raw projections, for exact decode; a
    # prefill shorter than the tail keeps the older ones
    state = {"ssm": final_ssm, **{
        k: _tail(t if tails[k] is None else torch.cat([tails[k].to(t.dtype), t], dim=1), tail)
        for k, t in raw.items()}}
    return _gated_norm(y, z, params["norm"], cfg), state


def mamba_mix_decode(params: Dict, z, xin, Bp, Cp, dt, state: Dict, cfg):
    """``mamba_mix`` for one token (b, 1, .) from ``state`` (its conv
    tails as wide as the projections they continue): the recurrent
    update. Returns (y (b, 1, h*p), the new state)."""
    b, _, h = dt.shape
    p, n = cfg.ssm_head_dim, cfg.ssm_state
    xin, conv_x = conv_decode_step(
        state["conv_x"], xin, params["conv_x_w"], params["conv_x_b"]
    )
    Bp, conv_B = conv_decode_step(
        state["conv_B"], Bp, params["conv_B_w"], params["conv_B_b"]
    )
    Cp, conv_C = conv_decode_step(
        state["conv_C"], Cp, params["conv_C_w"], params["conv_C_b"]
    )
    xin = F.silu(xin)[:, 0]                                      # (b, h*p)
    Bp = F.silu(Bp)[:, 0]
    Cp = F.silu(Cp)[:, 0]
    dt = F.softplus(dt[:, 0] + params["dt_bias"])                # (b, h)
    a = -torch.exp(params["A_log"]) * dt
    y, ssm = ssd_decode_step(
        state["ssm"], xin.reshape(b, h, p), dt, a,
        _groups_of_heads(Bp.reshape(b, -1, n), h, cfg),
        _groups_of_heads(Cp.reshape(b, -1, n), h, cfg),
    )
    y = y + params["D"][:, None] * xin.reshape(b, h, p)
    y = y.reshape(b, 1, h * p).to(z.dtype)
    return _gated_norm(y, z, params["norm"], cfg), {
        "ssm": ssm.to(state["ssm"].dtype),
        "conv_x": conv_x.to(state["conv_x"].dtype),
        "conv_B": conv_B.to(state["conv_B"].dtype),
        "conv_C": conv_C.to(state["conv_C"].dtype),
    }


def mamba_block(
    params: Dict,
    x: torch.Tensor,                 # (b, l, d)
    cfg,
    *,
    return_state: bool = False,
    initial_state: Optional[Dict] = None,
):
    """``initial_state`` and the returned state follow the
    ``init_ssm_state`` schema ({ssm, conv_x, conv_B, conv_C}), so prefill
    -> decode continuation is exact (SSM state + conv tails)."""
    y, state = mamba_mix(params, *_project(params, x, cfg), cfg, initial_state)
    out = (y @ params["w_out"]).to(x.dtype)
    return (out, state) if return_state else out


def init_ssm_state(cfg, batch: int, device=None) -> Dict:
    h, p, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    ch = cfg.ssm_d_inner
    gn = cfg.ssm_groups * cfg.ssm_state
    w = cfg.conv_width - 1
    return {
        "ssm": torch.zeros((batch, h, p, n), dtype=cfg.dtype, device=device),
        "conv_x": torch.zeros((batch, w, ch), dtype=cfg.dtype, device=device),
        "conv_B": torch.zeros((batch, w, gn), dtype=cfg.dtype, device=device),
        "conv_C": torch.zeros((batch, w, gn), dtype=cfg.dtype, device=device),
    }


def mamba_block_decode(
    params: Dict,
    x: torch.Tensor,        # (b, 1, d)
    state: Dict,            # from init_ssm_state
    cfg,
) -> Tuple[torch.Tensor, Dict]:
    y, state = mamba_mix_decode(params, *_project(params, x, cfg), state, cfg)
    return (y @ params["w_out"]).to(x.dtype), state
