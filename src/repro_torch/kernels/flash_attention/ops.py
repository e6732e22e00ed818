"""K3 in the model's layout: (B, S, H, D) queries, (B, T, G, D) keys and
values, as ``models.attention`` produces them."""
from __future__ import annotations

import torch

from .flash_attention import check_inputs, launch
from .ref import flash_attention_ref


def flash_attention_op(
    q: torch.Tensor,          # (B, S, H, D) — model layout
    k: torch.Tensor,          # (B, T, G, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    q_offset: int = 0,
) -> torch.Tensor:
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError("flash_attention_op: q and k must be 4-D")
    B, Sq, H, D = q.shape
    T, G = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D:
        raise ValueError(
            f"flash_attention_op: q {tuple(q.shape)} vs k {tuple(k.shape)}"
        )
    check_inputs("flash_attention_op", q, k, v, (B, H, G, D))
    if q.device.type == "cpu":
        return flash_attention_op_ref(q, k, v, causal=causal, window=window,
                                      q_offset=q_offset)
    out = torch.empty_like(q)
    launch(
        q, k, v, out, (B, H, G, Sq, T, D),
        (q.stride(0), q.stride(1), q.stride(2),
         k.stride(0), k.stride(1), k.stride(2),
         v.stride(0), v.stride(1), v.stride(2),
         out.stride(0), out.stride(1), out.stride(2)),
        causal=causal, window=window, q_offset=q_offset,
    )
    return out


def flash_attention_op_ref(q, k, v, *, causal=True, window=0, q_offset=0):
    """The plain version in the model's layout, on any device."""
    out = flash_attention_ref(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=causal, window=window, q_offset=q_offset,
    )
    return out.transpose(1, 2).contiguous()
