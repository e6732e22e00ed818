"""K2 wrapper: split-KV flash-decode (``csrc/decode_attention.cu``).

On a CUDA tensor it launches the kernel; on a CPU tensor it runs the plain
version. There is no fallback from the one to the other. The kernel takes
element strides, so the (B, G, T, D) cache layout here and the model's
(B, T, G, D) layout (``ops.py``) launch it without a transposing copy."""
from __future__ import annotations

import functools
import math
from typing import Sequence, Union

import torch

from .. import build
from ..flash_attention.flash_attention import DTYPES, check_inputs
from .ref import decode_attention_ref

TILE_K = 32              # keys per tile in the kernel
MAX_GROUP = 32           # R = H / G the kernel takes (8 warps x 4 rows)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def split_plan(T: int, B: int, G: int, sms: int):
    """(n_splits, split_len): enough (split, G, B) blocks to cover the SMs
    about twice, each split a whole number of 32-key tiles."""
    want = max(1, math.ceil(2 * sms / max(B * G, 1)))
    split_len = max(TILE_K, math.ceil(math.ceil(T / want) / TILE_K) * TILE_K)
    return math.ceil(T / split_len), split_len


def kv_len_tensor(kv_len: Union[int, torch.Tensor], B: int, device) -> torch.Tensor:
    if isinstance(kv_len, torch.Tensor):
        t = kv_len.to(device=device, dtype=torch.int32).reshape(-1)
        return t.expand(B).contiguous() if t.numel() == 1 else t.contiguous()
    return torch.full((B,), int(kv_len), dtype=torch.int32, device=device)


def launch(q, k, v, kv_len: torch.Tensor, out, dims: Sequence[int],
           strides: Sequence[int]) -> None:
    """Launch K2. dims = (B, H, G, T, D); strides in elements:
    q (b, h), k (b, t, g), v (b, t, g), out (b, h)."""
    B, H, G, T, D = dims
    if H // G > MAX_GROUP:
        raise ValueError(f"decode_attention: H/G = {H // G} > {MAX_GROUP}")
    if kv_len.shape != (B,) or kv_len.dtype != torch.int32 or \
            kv_len.device != q.device:
        raise ValueError("decode_attention: kv_len must be (B,) int32 on q's device")
    if out.numel() == 0 or T == 0:
        return
    n_splits, split_len = split_plan(T, B, G, _sm_count(q.device.index or 0))
    part = torch.empty((2, B * H * n_splits), dtype=torch.float32, device=q.device)
    acc = torch.empty((B * H * n_splits, D), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        rc = build.library().decode_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
            out.data_ptr(), part[0].data_ptr(), part[1].data_ptr(),
            acc.data_ptr(), DTYPES[q.dtype], B, H, G, T, D, *strides,
            n_splits, split_len, float(D ** -0.5), build.stream_handle(q),
        )
    build.check(rc, "decode_attention")
    decode_attention.launches += 1


def decode_attention(
    q: torch.Tensor,                    # (B, H, D)
    k: torch.Tensor,                    # (B, G, T, D)
    v: torch.Tensor,                    # (B, G, T, D)
    kv_len: Union[int, torch.Tensor],   # scalar or (B,) int32 valid lengths
) -> torch.Tensor:
    """One query token per sequence against its cache; out (B, H, D) in
    q's dtype. Only keys [0, kv_len[b]) are read."""
    if q.dim() != 3 or k.dim() != 4:
        raise ValueError("decode_attention: q must be 3-D and k 4-D")
    B, H, D = q.shape
    G, T = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D:
        raise ValueError(
            f"decode_attention: q {tuple(q.shape)} vs k {tuple(k.shape)}"
        )
    check_inputs("decode_attention", q, k, v, (B, H, G, D))
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, kv_len)
    out = torch.empty_like(q)
    launch(
        q, k, v, kv_len_tensor(kv_len, B, q.device), out, (B, H, G, T, D),
        (q.stride(0), q.stride(1),
         k.stride(0), k.stride(2), k.stride(1),
         v.stride(0), v.stride(2), v.stride(1),
         out.stride(0), out.stride(1)),
    )
    return out


decode_attention.launches = 0
