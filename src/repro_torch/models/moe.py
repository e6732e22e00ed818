"""Mixture-of-Experts channel mixer on tensors: the JAX package's
``models/moe.py`` (scatter dispatch into per-expert capacity buffers,
experts as batched products over the expert axis, a weighted gather back,
top-k routing with capacity drops and the load-balance loss).

It computes the same function as the JAX module, drops included:

* each batch row is a dispatch group with capacity ``capacity(S, cfg)``,
  the JAX expression as written (not ``math.ceil``);
* an assignment's slot is the count of earlier assignments to the same
  expert in its row, in token-major then k order, k by descending
  probability;
* an assignment over capacity is clamped onto slot C-1 with its
  contribution zeroed, so the scatter adds (the kept token there plus
  zeros) and the gather multiplies its read by ``keep = 0``.

The expert products stay PyTorch products, as the JAX package computes
them with einsums outside any Pallas kernel. The buffers hold every
expert, so a decode step (C = 1) reads every expert's weights.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F


def router(params: Dict, x: torch.Tensor, cfg) -> Tuple[torch.Tensor, ...]:
    """Returns (top-k probs renormalised, in ``x.dtype``; top-k expert
    indices, descending probability; fp32 probs over every expert)."""
    logits = torch.einsum("bsd,de->bse", x.float(), params["router"].float())
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.topk(probs, cfg.top_k, dim=-1, sorted=True)
    top_p = top_p / top_p.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    return top_p.to(x.dtype), top_i, probs


def load_balance_loss(probs: torch.Tensor, top_i: torch.Tensor,
                      n_experts: int) -> torch.Tensor:
    """Switch-style aux loss: E * sum_e f_e * P_e."""
    sel = F.one_hot(top_i, n_experts).float()                 # (B, S, K, E)
    frac_tokens = sel.mean(dim=2).mean(dim=(0, 1))            # (E,), sums to 1
    mean_prob = probs.mean(dim=(0, 1))                        # (E,)
    return n_experts * torch.sum(frac_tokens * mean_prob)


def capacity(S: int, cfg) -> int:
    """Slots per expert in a dispatch group of S tokens."""
    K, E = cfg.top_k, cfg.n_experts
    C = max(1, int((S * K / E) * cfg.capacity_factor + 0.9999))
    return min(C, S * K)


def slot_positions(top_i: torch.Tensor, n_experts: int) -> torch.Tensor:
    """(B, S, K) slot of each assignment in its expert's buffer: the count
    of earlier assignments to that expert in the row, token-major then k."""
    B, S, K = top_i.shape
    flat = F.one_hot(top_i, n_experts).reshape(B, S * K, n_experts)
    prior = flat.cumsum(dim=1) - flat                         # exclusive count
    return prior.gather(-1, top_i.reshape(B, S * K, 1)).reshape(B, S, K)


def moe_ffn(params: Dict, x: torch.Tensor, cfg, *, return_aux: bool = False):
    """x: (B, S, d). SwiGLU experts over (B, E, C, d) capacity buffers."""
    B, S, d = x.shape
    E = cfg.n_experts
    top_p, top_i, probs = router(params, x, cfg)
    C = capacity(S, cfg)
    pos = slot_positions(top_i, E)
    keep = (pos < C).to(x.dtype)                              # capacity drop
    pos_c = pos.clamp_max(C - 1)

    # Scatter into the buffers; a dropped assignment adds zeros at C-1.
    bidx = torch.arange(B, device=x.device)[:, None, None].expand_as(top_i)
    contrib = x[:, :, None, :] * keep[..., None]              # (B, S, K, d)
    buffers = torch.zeros((B, E, C, d), dtype=x.dtype, device=x.device)
    buffers.index_put_((bidx, top_i, pos_c), contrib, accumulate=True)

    h_gate = torch.einsum("becd,edf->becf", buffers, params["w_gate"])
    h_up = torch.einsum("becd,edf->becf", buffers, params["w_up"])
    h = F.silu(h_gate) * h_up
    out_buf = torch.einsum("becf,efd->becd", h, params["w_down"])

    # Gather back to token order with router weighting.
    gathered = out_buf[bidx, top_i, pos_c]                    # (B, S, K, d)
    y = torch.sum(gathered * (top_p * keep)[..., None], dim=2)
    if return_aux:
        return y, load_balance_loss(probs, top_i, E)
    return y
