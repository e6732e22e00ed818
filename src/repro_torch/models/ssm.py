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
from .layers import BATCH, MODEL, rms_norm, shard


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
def causal_conv(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """x: (b, l, ch), w: (width, ch) depthwise. Causal (left) padding."""
    width = w.shape[0]
    xp = F.pad(x.transpose(1, 2), (width - 1, 0))               # (b, ch, l+w-1)
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
    b, l, _ = x.shape
    h, p, n, g = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_groups
    tail = cfg.conv_width - 1
    z, xin_raw, Bp_raw, Cp_raw, dt = _project(params, x, cfg)
    xin = F.silu(causal_conv(xin_raw, params["conv_x_w"], params["conv_x_b"]))
    xin = shard(xin, BATCH, None, MODEL)
    Bp = F.silu(causal_conv(Bp_raw, params["conv_B_w"], params["conv_B_b"]))
    Cp = F.silu(causal_conv(Cp_raw, params["conv_C_w"], params["conv_C_b"]))
    dt = F.softplus(dt + params["dt_bias"])                      # (b, l, h)
    a = -torch.exp(params["A_log"]) * dt                         # fp32
    xh = xin.reshape(b, l, h, p)
    xbar = xh * dt[..., None]
    s0 = initial_state["ssm"] if initial_state is not None else None
    y, final_ssm = ssd_op(
        xbar, a, Bp.reshape(b, l, g, n), Cp.reshape(b, l, g, n),
        cfg.ssm_chunk, s0,
    )
    y = y + params["D"][:, None] * xh                            # skip
    y = y.reshape(b, l, h * p).to(x.dtype)
    y = rms_norm(y * F.silu(z), params["norm"], cfg.norm_eps)
    out = (y @ params["w_out"]).to(x.dtype)
    if return_state:
        state = {
            "ssm": final_ssm,
            # conv tails: the last (width-1) raw projections, for exact decode
            "conv_x": _tail(xin_raw, tail),
            "conv_B": _tail(Bp_raw, tail),
            "conv_C": _tail(Cp_raw, tail),
        }
        return out, state
    return out


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
    b = x.shape[0]
    h, p, n, g = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_groups
    z, xin, Bp, Cp, dt = _project(params, x, cfg)
    xin, conv_x = conv_decode_step(
        state["conv_x"], xin, params["conv_x_w"], params["conv_x_b"]
    )
    Bp, conv_B = conv_decode_step(
        state["conv_B"], Bp, params["conv_B_w"], params["conv_B_b"]
    )
    Cp, conv_C = conv_decode_step(
        state["conv_C"], Cp, params["conv_C_w"], params["conv_C_b"]
    )
    xin = F.silu(xin)[:, 0]                                      # (b, di)
    Bp = F.silu(Bp)[:, 0]
    Cp = F.silu(Cp)[:, 0]
    dt = F.softplus(dt[:, 0] + params["dt_bias"])                # (b, h)
    a = -torch.exp(params["A_log"]) * dt
    y, ssm = ssd_decode_step(
        state["ssm"], xin.reshape(b, h, p), dt, a,
        Bp.reshape(b, g, n), Cp.reshape(b, g, n),
    )
    y = y + params["D"][:, None] * xin.reshape(b, h, p)
    y = y.reshape(b, 1, h * p).to(x.dtype)
    y = rms_norm(y * F.silu(z), params["norm"], cfg.norm_eps)
    out = (y @ params["w_out"]).to(x.dtype)
    return out, {
        "ssm": ssm.to(state["ssm"].dtype),
        "conv_x": conv_x.to(state["conv_x"].dtype),
        "conv_B": conv_B.to(state["conv_B"].dtype),
        "conv_C": conv_C.to(state["conv_C"].dtype),
    }
