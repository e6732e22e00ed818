"""Mamba2-370m as the configuration runs it, in plain PyTorch in fp32 (TF32
off): the reference that decides ``correct`` for the Mamba2 cells.

Per layer: RMS norm; the projections z, x, B, C and dt; a causal
depthwise convolution of width ``conv_width`` with bias over each of x, B
and C, then SiLU; dt = softplus(dt + dt_bias), a = -exp(A_log) * dt; the
SSD recurrence h_t = exp(a_t) h_{t-1} + dt_t x_t B_t^T, y_t = h_t C_t,
computed a chunk at a time in its quadratic form with the state carried
between chunks; the skip D x; RMS norm of y * silu(z); the out projection
and the residual add. Then the final norm and the head at the last
position.

It reads the weights in the port's layout as the benchmark made them and
works out everything else itself. ``fp8_control=True`` is the control:
every weight product with fp8 operands (see ``plain.Matmul``).
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from .plain import Matmul, rms_norm

Sizes = Dict[str, float]


def conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Causal depthwise conv: x (S, ch), w (width, ch): out_t = b + sum_j
    w_j x_{t - width + 1 + j}, zeros before the start."""
    width = w.shape[0]
    xp = F.pad(x.T[None], (width - 1, 0))                     # (1, ch, S + width - 1)
    return F.conv1d(xp, w.float().T[:, None, :], b.float(), groups=x.shape[1])[0].T


def ssd(xbar: torch.Tensor, a: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
        chunk: int) -> torch.Tensor:
    """xbar (S, h, p), a (S, h) log decays, B and C (S, n) (one group):
    y (S, h, p) of the recurrence from a zero state."""
    S, h, p = xbar.shape
    n = B.shape[-1]
    state = torch.zeros(h, p, n, dtype=torch.float32, device=xbar.device)
    ys = []
    for c0 in range(0, S, chunk):
        xs, As, Bs, Cs = xbar[c0:c0 + chunk], a[c0:c0 + chunk], B[c0:c0 + chunk], C[c0:c0 + chunk]
        Q = xs.shape[0]
        cum = As.cumsum(0)                                   # (Q, h)
        seg = cum[:, None, :] - cum[None, :, :]              # (i, j, h)
        causal = torch.ones(Q, Q, dtype=torch.bool, device=xs.device).tril()
        L = torch.where(causal[..., None], seg, torch.full_like(seg, float("-inf"))).exp()
        M = (L * (Cs @ Bs.T)[..., None]).permute(2, 0, 1)    # (h, i, j)
        y = torch.bmm(M, xs.permute(1, 0, 2)).permute(1, 0, 2)
        y = y + torch.einsum("in,hpn->ihp", Cs, state) * cum.exp()[..., None]
        to_end = (cum[-1:] - cum).exp()                      # (Q, h)
        state = state * cum[-1].exp()[:, None, None] + torch.einsum(
            "jh,jn,jhp->hpn", to_end, Bs, xs)
        ys.append(y)
    return torch.cat(ys)


def last_logits(weights: Dict, tokens: torch.Tensor, z: Sizes,
                fp8_control: bool = False) -> torch.Tensor:
    """The fp32 logits (V,) at the last position of ``tokens`` (S,)."""
    mm = Matmul(fp8_control)
    p = weights["blocks"][0]
    eps = float(z["norm_eps"])
    h_, pd, n, g = int(z["ssm_heads"]), int(z["ssm_head_dim"]), int(z["ssm_state"]), int(z["ssm_groups"])
    if g != 1:
        raise ValueError("the reference takes one B/C group")
    S = tokens.shape[0]
    x = weights["embedding"][tokens].float()
    for i in range(int(z["n_layers"])):
        hn = rms_norm(x, p["ln1"][i], eps)
        zg = mm(hn, p["w_z"][i])
        xin = F.silu(conv(mm(hn, p["w_x"][i]), p["conv_x_w"][i], p["conv_x_b"][i]))
        Bm = F.silu(conv(mm(hn, p["w_B"][i]), p["conv_B_w"][i], p["conv_B_b"][i]))
        Cm = F.silu(conv(mm(hn, p["w_C"][i]), p["conv_C_w"][i], p["conv_C_b"][i]))
        dt = F.softplus(mm(hn, p["w_dt"][i]) + p["dt_bias"][i].float())       # (S, h)
        a = -torch.exp(p["A_log"][i].float()) * dt
        xh = xin.reshape(S, h_, pd)
        y = ssd(xh * dt[..., None], a, Bm, Cm, int(z["ssm_chunk"]))
        y = (y + p["D"][i].float()[:, None] * xh).reshape(S, h_ * pd)
        y = rms_norm(y * F.silu(zg), p["norm"][i], eps)
        x = x + mm(y, p["w_out"][i])
    hn = rms_norm(x[-1:], weights["ln_f"], eps)
    head = weights["head"] if "head" in weights else weights["embedding"].T
    return mm(hn, head)[0]
