"""Plain PyTorch version of K3: causal (optionally sliding-window) GQA
attention over the (B, H, S, D) query layout, fp32 inside."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def flash_attention_ref(
    q: torch.Tensor,        # (B, H, Sq, D)
    k: torch.Tensor,        # (B, G, T, D)
    v: torch.Tensor,        # (B, G, T, D)
    *,
    causal: bool = True,
    window: int = 0,
    q_offset: int = 0,
) -> torch.Tensor:
    B, H, Sq, D = q.shape
    G, T = k.shape[1], k.shape[2]
    R = H // G
    qg = q.reshape(B, G, R, Sq, D).float()
    s = torch.einsum("bgrsd,bgtd->bgrst", qg, k.float()) * (D ** -0.5)
    q_idx = torch.arange(Sq, device=q.device) + q_offset
    k_idx = torch.arange(T, device=q.device)
    mask = torch.ones((Sq, T), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_idx[None, :] <= q_idx[:, None]
    if window:
        mask &= k_idx[None, :] > q_idx[:, None] - window
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bgrst,bgtd->bgrsd", p, v.float())
    return o.reshape(B, H, Sq, D).to(q.dtype)
