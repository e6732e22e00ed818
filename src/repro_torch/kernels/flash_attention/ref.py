"""Plain PyTorch version of K3: causal (optionally sliding-window) GQA
attention over the (B, H, S, D) query layout, fp32 inside; and the row
log-sum-exp of its masked scores, which K3's forward writes for K3b."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def visible(Sq: int, T: int, *, causal: bool, window: int, q_offset: int,
            device=None) -> torch.Tensor:
    """(Sq, T) bool: key t is visible to query row s (position s +
    q_offset) when t <= s + q_offset under the causal mask and t > s +
    q_offset - window under a window."""
    q_idx = torch.arange(Sq, device=device) + q_offset
    k_idx = torch.arange(T, device=device)
    mask = torch.ones((Sq, T), dtype=torch.bool, device=device)
    if causal:
        mask &= k_idx[None, :] <= q_idx[:, None]
    if window:
        mask &= k_idx[None, :] > q_idx[:, None] - window
    return mask


def no_key_rows(Sq: int, T: int, *, causal: bool, window: int, q_offset: int):
    """(n_pre, s_suf): for T >= 1 the rows that see no key are [0, n_pre),
    whose positions lie before 0 under the causal mask, and [s_suf, Sq),
    whose positions are T + window - 1 or more under a window (the window
    has passed the last key). Every other row sees at least one key."""
    n_pre = min(Sq, max(0, -q_offset)) if causal else 0
    s_suf = min(Sq, max(0, T + window - 1 - q_offset)) if window > 0 else Sq
    return n_pre, s_suf


def _masked_scores(q, k, causal, window, q_offset) -> torch.Tensor:
    """(B, G, R, Sq, T) fp32 scores D^-0.5 q kᵀ, -1e30 where masked."""
    B, H, Sq, D = q.shape
    G, T = k.shape[1], k.shape[2]
    qg = q.reshape(B, G, H // G, Sq, D).float()
    s = torch.einsum("bgrsd,bgtd->bgrst", qg, k.float()) * (D ** -0.5)
    mask = visible(Sq, T, causal=causal, window=window, q_offset=q_offset, device=q.device)
    return torch.where(mask, s, torch.full_like(s, NEG_INF))


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
    p = torch.softmax(_masked_scores(q, k, causal, window, q_offset), dim=-1)
    o = torch.einsum("bgrst,bgtd->bgrsd", p, v.float())
    return o.reshape(B, H, Sq, D).to(q.dtype)


def flash_attention_lse_ref(q, k, *, causal=True, window=0, q_offset=0) -> torch.Tensor:
    """(B, H, Sq) fp32: log Σ_t exp(s_t) over each row's masked scores. A
    row that sees no key has T scores of -1e30, so its value is -1e30 (the
    log T it adds is below fp32's resolution there)."""
    B, H, Sq, _ = q.shape
    return torch.logsumexp(_masked_scores(q, k, causal, window, q_offset), -1).reshape(B, H, Sq)
