"""K2 wrapper: flash-decode in one cluster launch (``csrc/decode_attention.cu``).

On a CUDA tensor it launches the kernel; on a CPU tensor it runs the plain
version. There is no fallback from the one to the other. Each (KV head,
sequence) is one thread-block cluster of ``cluster_plan`` blocks that split
the valid cache between them (``split_range``) and combine their partials
in distributed shared memory, so a call is one launch and allocates only
its output. The kernel takes element strides, so the (B, G, T, D) cache
layout here and the model's (B, T, G, D) layout (``ops.py``) launch it
without a transposing copy."""
from __future__ import annotations

import functools
import math
from typing import Optional, Sequence, Tuple, Union

import torch

from .. import build
from ..flash_attention.flash_attention import DTYPES, check_head_dim, check_inputs
from .ref import NEG_INF, decode_attention_ref  # noqa: F401  (JAX's name: a masked score)

TILE_K = 32              # keys per tile in the kernel
MAX_GROUP = 32           # R = H / G the kernel takes up to D = 128 (8 warps x 4 rows)
MAX_GROUP_WIDE = 16      # R it takes past D = 128: the staged q rows and the
                         # cluster's partials must fit in shared memory
MAX_CLUSTER = 8          # blocks per cluster, the portable limit


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def cluster_plan(n_keys: int, B: int, G: int, sms: int) -> int:
    """Blocks per (KV head, sequence) cluster: enough B * G clusters to
    cover the SMs about twice, at most 8, and no more than the 32-key tiles
    of the longest valid cache (``n_keys``) can keep busy."""
    want = math.ceil(2 * sms / max(B * G, 1))
    return max(1, min(MAX_CLUSTER, want, math.ceil(n_keys / TILE_K)))


def split_range(rank: int, cluster: int, kv_len: int) -> Tuple[int, int]:
    """Keys [begin, end) that block ``rank`` of a cluster takes from a
    sequence with ``kv_len`` valid keys (empty when end <= begin), as the
    kernel computes them: ceil(kv_len / cluster) rounded up to whole tiles."""
    if kv_len <= 0:
        return 0, 0
    split = math.ceil(math.ceil(kv_len / cluster) / TILE_K) * TILE_K
    begin = rank * split
    return begin, min(begin + split, kv_len)


def max_group(D: int) -> int:
    """The largest R = H / G the kernel takes at head width D."""
    return MAX_GROUP if D <= 128 else MAX_GROUP_WIDE


def check_kv_len(kv_len: Union[int, torch.Tensor], B: int) -> None:
    """kv_len is one length, or one per sequence."""
    if isinstance(kv_len, torch.Tensor) and kv_len.numel() not in (1, B):
        raise ValueError(
            f"decode_attention: kv_len must be a scalar or ({B},), got "
            f"{tuple(kv_len.shape)}"
        )


def kv_len_arg(kv_len: Union[int, torch.Tensor], B: int,
               device) -> Tuple[Optional[torch.Tensor], int]:
    """(device array or None, value) for the kernel: a tensor becomes a (B,)
    int32 array on q's device; an int is passed by value, with no device
    work."""
    if isinstance(kv_len, torch.Tensor):
        t = kv_len.to(device=device, dtype=torch.int32).reshape(-1)
        return (t.expand(B).contiguous() if t.numel() == 1 else t.contiguous()), 0
    return None, int(kv_len)


def launch(q, k, v, kv_len: Union[int, torch.Tensor], out, dims: Sequence[int],
           strides: Sequence[int]) -> None:
    """Launch K2. dims = (B, H, G, T, D); strides in elements:
    q (b, h), k (b, t, g), v (b, t, g), out (b, h)."""
    build.refuse_grad("decode_attention", q, k, v,
                      why="K2 serves decode only, which takes no gradient")
    B, H, G, T, D = dims
    check_head_dim("decode_attention", D)
    if H // G > max_group(D):
        raise ValueError(f"decode_attention: the CUDA kernel takes H/G <= {max_group(D)} "
                         f"at D = {D}, got {H // G}")
    lens, value = kv_len_arg(kv_len, B, q.device)
    if out.numel() == 0 or T == 0:
        return
    n_keys = T if lens is not None else max(0, min(value, T))
    cluster = cluster_plan(n_keys, B, G, _sm_count(q.device.index or 0))
    with torch.cuda.device(q.device):
        rc = build.library().decode_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if lens is None else lens.data_ptr(), value,
            out.data_ptr(), DTYPES[q.dtype], B, H, G, T, D, *strides,
            cluster, float(D ** -0.5), build.stream_handle(q),
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
    check_kv_len(kv_len, B)
    # meta: the dry-run's route, shapes only; nothing is launched
    if q.device.type in ("cpu", "meta"):
        return decode_attention_ref(q, k, v, kv_len)
    out = torch.empty_like(q)
    launch(
        q, k, v, kv_len, out, (B, H, G, T, D),
        (q.stride(0), q.stride(1),
         k.stride(0), k.stride(2), k.stride(1),
         v.stride(0), v.stride(2), v.stride(1),
         out.stride(0), out.stride(1)),
    )
    return out


decode_attention.launches = 0
