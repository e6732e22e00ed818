"""Plain PyTorch version of K2: single-query GQA attention against a KV
cache with a valid-length mask, fp32 inside."""
from __future__ import annotations

from typing import Union

import torch

NEG_INF = -1e30


def decode_attention_ref(
    q: torch.Tensor,                    # (B, H, D) — one new token per sequence
    k: torch.Tensor,                    # (B, G, T, D) KV cache (possibly padded)
    v: torch.Tensor,                    # (B, G, T, D)
    kv_len: Union[int, torch.Tensor],   # scalar or (B,) — valid cache entries
) -> torch.Tensor:
    B, H, D = q.shape
    G, T = k.shape[1], k.shape[2]
    R = H // G
    qg = q.reshape(B, G, R, D).float()
    s = torch.einsum("bgrd,bgtd->bgrt", qg, k.float()) * (D ** -0.5)
    kv_len = torch.as_tensor(kv_len, device=q.device).reshape(-1)
    valid = torch.arange(T, device=q.device)[None] < kv_len[:, None]
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bgrt,bgtd->bgrd", p, v.float())
    return o.reshape(B, H, D).to(q.dtype)
