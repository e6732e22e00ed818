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

Under a mesh the layer runs in three ``shard_map`` stages with the JAX
package's ``shard`` constraints between them: routing and the scatter
on each rank's local batch (DTensor has no rule for top-k or the
scatter), the expert products on the buffers' and the expert leaves'
local experts (expert axis over ``model``), and the weighted gather on
the buffers gathered over ``model``.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..distributed.sharding import P
from ..obs import card
from .layers import BATCH, MODEL, pspec, shard, shard_map


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """JAX's ``lax.top_k``: the k largest along the last axis, descending,
    the lower index first among equal values (a zero token's uniform
    probabilities, say), which ``torch.topk`` does not promise."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def router(params: Dict, x: torch.Tensor, cfg) -> Tuple[torch.Tensor, ...]:
    """Returns (top-k probs renormalised, in ``x.dtype``; top-k expert
    indices, descending probability; fp32 probs over every expert)."""
    logits = torch.einsum("bsd,de->bse", x.float(), params["router"].float())
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = top_k(probs, cfg.top_k)
    top_p = top_p / top_p.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    return top_p.to(x.dtype), top_i, probs


def _chosen_share(top_i: torch.Tensor, n_experts: int) -> torch.Tensor:
    """(B, S, E): the share of each token's K choices that went to each
    expert."""
    return F.one_hot(top_i, n_experts).float().mean(dim=2)


def _balance(chosen: torch.Tensor, probs: torch.Tensor, n_experts: int) -> torch.Tensor:
    frac_tokens = chosen.mean(dim=(0, 1))                     # (E,), sums to 1
    mean_prob = probs.mean(dim=(0, 1))                        # (E,)
    return n_experts * torch.sum(frac_tokens * mean_prob)


def load_balance_loss(probs: torch.Tensor, top_i: torch.Tensor,
                      n_experts: int) -> torch.Tensor:
    """Switch-style aux loss: E * sum_e f_e * P_e."""
    return _balance(_chosen_share(top_i, n_experts), probs, n_experts)


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
    """x: (B, S, d). SwiGLU experts over (B, E, C, d) capacity buffers; one
    span a stage on the card tracer (``obs.card``), timed on the card."""
    B, S, d = x.shape
    E = cfg.n_experts
    C = capacity(S, cfg)

    def route(xl, w_router):
        top_p, top_i, probs = router({"router": w_router}, xl, cfg)
        pos = slot_positions(top_i, E)
        keep = (pos < C).to(xl.dtype)                         # capacity drop
        pos_c = pos.clamp_max(C - 1)
        # Scatter into the buffers; a dropped assignment adds zeros at C-1.
        bidx = torch.arange(xl.shape[0], device=xl.device)[:, None, None].expand_as(top_i)
        contrib = xl[:, :, None, :] * keep[..., None]         # (B, S, K, d)
        buffers = torch.zeros((xl.shape[0], E, C, d), dtype=xl.dtype, device=xl.device)
        buffers.index_put_((bidx, top_i, pos_c), contrib, accumulate=True)
        return buffers, top_p * keep, top_i, pos_c, probs, _chosen_share(top_i, E)

    def experts(buffers, w_gate, w_up, w_down):
        h_gate = torch.einsum("becd,edf->becf", buffers, w_gate)
        h_up = torch.einsum("becd,edf->becf", buffers, w_up)
        h = F.silu(h_gate) * h_up
        return torch.einsum("becf,efd->becd", h, w_down)

    def combine(out_buf, weight, top_i, pos_c):
        # Gather back to token order with router weighting.
        bidx = torch.arange(out_buf.shape[0], device=out_buf.device)[:, None, None]
        gathered = out_buf[bidx.expand_as(top_i), top_i, pos_c]   # (B, S, K, d)
        return torch.sum(gathered * weight[..., None], dim=2)

    tok = pspec(BATCH, None, None, dims=x.shape)              # (B, S, ·) leaves
    buf = pspec(BATCH, None, None, None, dims=(B, E, C, d))
    with card.span("mma.moe"):
        card.count("mma.moe.tokens", B * S)
        with card.span("mma.moe.route", device=x.device):
            buffers, weight, top_i, pos_c, probs, chosen = shard_map(
                route, (tok, P()), (buf, tok, tok, tok, tok, tok), x,
                params["router"])
            buffers = shard(buffers, BATCH, MODEL, None, None)
        with card.span("mma.moe.experts", device=x.device):
            ex = pspec(BATCH, MODEL, None, None, dims=buffers.shape)
            w = pspec(MODEL, None, None, dims=params["w_gate"].shape)
            out_buf = shard_map(experts, (ex, w, w, w), ex, buffers,
                                params["w_gate"], params["w_up"], params["w_down"])
            out_buf = shard(out_buf, BATCH, MODEL, None, None)
        with card.span("mma.moe.combine", device=x.device):
            y = shard_map(combine, (buf, tok, tok, tok), tok, out_buf, weight,
                          top_i, pos_c)
            y = shard(y, BATCH, None, None)
    if return_aux:
        return y, _balance(chosen, probs, E)
    return y
