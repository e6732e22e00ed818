"""Plain PyTorch version of K4 and of its gradient (K4b): the intra-chunk
SSD dual form, batched over the fused batch*heads axis (what ``jax.vmap``
of the JAX oracle gives), fp32 inside as the Pallas kernel computes it."""
from __future__ import annotations

from typing import Tuple

import torch


def ssd_chunk_ref(
    xbar: torch.Tensor,    # (BH, nc, Q, P)  inputs pre-multiplied by dt
    a: torch.Tensor,       # (BH, nc, Q)     log decays
    B: torch.Tensor,       # (BH, nc, Q, N)
    C: torch.Tensor,       # (BH, nc, Q, N)
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (y_diag (BH,nc,Q,P) in xbar's dtype, states (BH,nc,P,N)
    fp32, out_decay (BH,nc,Q) fp32).

    y_diag:    intra-chunk contribution.
    states:    sum_j exp(a_{j+1..Q}) * B_j (x) xbar_j, the state each chunk
               contributes to the carry.
    out_decay: exp(cumsum(a)), the per-position decay applied to the
               carried state's contribution.
    """
    Q = xbar.shape[-2]
    x, B, C = xbar.float(), B.float(), C.float()
    cs = torch.cumsum(a.float(), dim=-1)                      # (BH, nc, Q)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=a.device))
    L = torch.where(mask, torch.exp(diff), torch.zeros_like(diff))
    scores = torch.einsum("bcin,bcjn->bcij", C, B) * L
    y_diag = torch.einsum("bcij,bcjp->bcip", scores, x)
    decay_states = torch.exp(cs[..., -1:] - cs)               # (BH, nc, Q)
    states = torch.einsum("bcjp,bcj,bcjn->bcpn", x, decay_states, B)
    return y_diag.to(xbar.dtype), states, torch.exp(cs)


def ssd_chunk_bwd_f32(xbar, a, B, C, dy, dstates, ddecay):
    """``ssd_chunk_bwd_ref`` with every gradient left in fp32."""
    Q = xbar.shape[-2]
    x, B, C = xbar.float(), B.float(), C.float()
    dy, dstates, ddecay = dy.float(), dstates.float(), ddecay.float()
    cs = torch.cumsum(a.float(), dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=a.device))
    L = torch.where(mask, torch.exp(diff), torch.zeros_like(diff))
    S = torch.einsum("bcin,bcjn->bcij", C, B)
    M = S * L
    dS = torch.einsum("bcip,bcjp->bcij", dy, x) * L          # dM o L
    w = torch.exp(cs[..., -1:] - cs)                          # (BH, nc, Q)
    ds_B = torch.einsum("bcpn,bcjn->bcjp", dstates, B)        # dstates B_j
    dx = torch.einsum("bcij,bcip->bcjp", M, dy) + w[..., None] * ds_B
    dC = torch.einsum("bcij,bcjn->bcin", dS, B)
    dB = (torch.einsum("bcij,bcin->bcjn", dS, C)
          + w[..., None] * torch.einsum("bcpn,bcjp->bcjn", dstates, x))
    G = dS * S                                                # dM o M
    u = w * (x * ds_B).sum(-1)
    dcs = G.sum(-1) - G.sum(-2) - u + ddecay * torch.exp(cs)
    dcs[..., -1] += u.sum(-1)
    da = torch.flip(torch.cumsum(torch.flip(dcs, (-1,)), -1), (-1,))
    return dx, da, dB, dC


def bf16_parts(v: torch.Tensor, parts: int) -> torch.Tensor:
    """``v`` (fp32) as the sum of ``parts`` bf16 values, each the bf16
    rounding of what the ones before it leave: what the tensor-core K4b
    hands the tensor cores for a value it builds in registers."""
    out, rest = torch.zeros_like(v), v.float()
    for _ in range(parts):
        part = rest.to(torch.bfloat16).float()
        out, rest = out + part, rest - part
    return out


def ssd_chunk_bwd_tc_emulated(xbar, a, B, C, dy, dstates, ddecay,
                              parts: Tuple[int, int, int]):
    """A plain emulation of the tensor-core K4b's arithmetic, for the
    tests: x, B, C and dy rounded to bf16 (the kernel's operands), S = C
    B^T and dM = dy x^T exact in fp32, M = S o L, dS = dM o L and dstates
    rounded to ``parts`` = (M's, dS's, dstates') bf16 parts before the
    products they enter (dx's, dC's and dB's, the state terms), fp32 sums;
    G = dS o S and the exponents stay fp32, as in the kernel. Returns
    (dx, da, dB, dC) in fp32, the layout of ``ssd_chunk_bwd_f32``."""
    pm, pds, pst = parts
    Q = xbar.shape[-2]
    x, B, C, dy = (t.to(torch.bfloat16).float() for t in (xbar, B, C, dy))
    cs = torch.cumsum(a.float(), dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=a.device))
    L = torch.where(mask, torch.exp(torch.where(mask, diff, 0.0)), 0.0)
    S = torch.einsum("bcin,bcjn->bcij", C, B)
    dS = torch.einsum("bcip,bcjp->bcij", dy, x) * L
    Mq, dSq, dq = bf16_parts(S * L, pm), bf16_parts(dS, pds), bf16_parts(dstates, pst)
    w = torch.exp(cs[..., -1:] - cs)
    t1 = torch.einsum("bcpn,bcjn->bcjp", dq, B)                # B_j dstates^T
    dx = torch.einsum("bcij,bcip->bcjp", Mq, dy) + w[..., None] * t1
    dC = torch.einsum("bcij,bcjn->bcin", dSq, B)
    dB = (torch.einsum("bcij,bcin->bcjn", dSq, C)
          + w[..., None] * torch.einsum("bcpn,bcjp->bcjn", dq, x))
    G = dS * S
    u = w * (x * t1).sum(-1)
    dcs = G.sum(-1) - G.sum(-2) - u + ddecay.float() * torch.exp(cs)
    dcs[..., -1] += u.sum(-1)
    da = torch.flip(torch.cumsum(torch.flip(dcs, (-1,)), -1), (-1,))
    return dx, da, dB, dC


def ssd_chunk_bwd_ref(
    xbar: torch.Tensor,      # (BH, nc, Q, P)
    a: torch.Tensor,         # (BH, nc, Q)
    B: torch.Tensor,         # (BH, nc, Q, N)
    C: torch.Tensor,         # (BH, nc, Q, N)
    dy: torch.Tensor,        # (BH, nc, Q, P)  gradient of y_diag
    dstates: torch.Tensor,   # (BH, nc, P, N)  gradient of states
    ddecay: torch.Tensor,    # (BH, nc, Q)     gradient of out_decay
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of ``ssd_chunk_ref``'s three outputs with respect to
    xbar, a, B and C, in closed form (not autograd), fp32 inside. With cs
    = cumsum(a), L_ij = exp(cs_i - cs_j) for i >= j, S = C B^T, M = S o L,
    w_j = exp(cs_last - cs_j) and dM_ij = dy_i . x_j:

      dx_j = sum_i M_ij dy_i + w_j dstates B_j
      dC_i = sum_j (dM o L)_ij B_j
      dB_j = sum_i (dM o L)_ij C_i + w_j dstates^T x_j
      dcs_i = sum_j G_ij - sum_k G_ki - u_i + [i = last] sum_j u_j
              + ddecay_i exp(cs_i),  G = dM o M,  u_j = w_j x_j . dstates B_j
      da = the reverse cumsum of dcs within the chunk.

    Returns (dx, da, dB, dC): dx, dB and dC in the inputs' dtypes, da fp32."""
    dx, da, dB, dC = ssd_chunk_bwd_f32(xbar, a, B, C, dy, dstates, ddecay)
    return dx.to(xbar.dtype), da, dB.to(B.dtype), dC.to(C.dtype)
