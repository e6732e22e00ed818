"""K2 in the model's layout: (B, 1, H, D) single-token queries against
(B, T, G, D) caches, as ``models.attention`` keeps them."""
from __future__ import annotations

from typing import Union

import torch

from ..flash_attention.flash_attention import check_inputs
from .decode_attention import check_kv_len, launch
from .ref import decode_attention_ref


def decode_attention_op(
    q: torch.Tensor,                    # (B, 1, H, D) model layout
    k_cache: torch.Tensor,              # (B, T, G, D)
    v_cache: torch.Tensor,
    kv_len: Union[int, torch.Tensor],
) -> torch.Tensor:
    if q.dim() != 4 or q.shape[1] != 1 or k_cache.dim() != 4:
        raise ValueError("decode_attention_op: q must be (B, 1, H, D), k 4-D")
    B, _, H, D = q.shape
    T, G = k_cache.shape[1], k_cache.shape[2]
    if k_cache.shape[0] != B or k_cache.shape[3] != D:
        raise ValueError(
            f"decode_attention_op: q {tuple(q.shape)} vs k "
            f"{tuple(k_cache.shape)}"
        )
    check_inputs("decode_attention_op", q, k_cache, v_cache, (B, H, G, D))
    check_kv_len(kv_len, B)
    if q.device.type == "cpu":
        return decode_attention_op_ref(q, k_cache, v_cache, kv_len)
    out = torch.empty_like(q)
    launch(
        q, k_cache, v_cache, kv_len, out,
        (B, H, G, T, D),
        (q.stride(0), q.stride(2),
         k_cache.stride(0), k_cache.stride(1), k_cache.stride(2),
         v_cache.stride(0), v_cache.stride(1), v_cache.stride(2),
         out.stride(0), out.stride(2)),
    )
    return out


def decode_attention_op_ref(q, k_cache, v_cache, kv_len):
    """The plain version in the model's layout, on any device."""
    out = decode_attention_ref(
        q[:, 0], k_cache.transpose(1, 2), v_cache.transpose(1, 2), kv_len
    )
    return out[:, None]
