"""Plain PyTorch version of K4: the intra-chunk SSD dual form, batched over
the fused batch*heads axis (what ``jax.vmap`` of the JAX oracle gives),
fp32 inside as the Pallas kernel computes it."""
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
