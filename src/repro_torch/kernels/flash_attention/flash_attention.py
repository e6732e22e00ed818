"""K3 wrapper: prefill flash attention (``csrc/flash_attention.cu``).

On a CUDA tensor it launches the kernel; on a CPU tensor it runs the plain
version. There is no fallback from the one to the other. The kernel takes
element strides, so the (B, H, S, D) layout here and the model's
(B, S, H, D) layout (``ops.py``) launch it without a transposing copy."""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from .. import build
from .ref import NEG_INF, flash_attention_ref  # noqa: F401  (JAX's name: a masked score)

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256       # D the CUDA kernels take; the plain versions take any
TILE_Q = 64              # q rows per block of the bf16 (tensor-core) kernel


def block_order(n_qt: int, H: int, B: int) -> List[Tuple[int, int, int]]:
    """(q tile, head, batch) of each block of the bf16 kernel, by block
    index (``block_coords`` in ``csrc/flash_attention.cu``): the last q tile
    first, since under the causal mask it has the most key tiles, and the
    R = H / G heads that share a KV head next to each other. Without the
    causal mask (cross-attention) every q tile walks all key tiles, so the
    first half of the order changes nothing and the second still keeps a
    KV head's tiles in L2 for its R heads."""
    return [(n_qt - 1 - i // (H * B), i % (H * B) % H, i % (H * B) // H)
            for i in range(n_qt * H * B)]


def check_inputs(name: str, q, k, v, dims) -> None:
    """Shared device / dtype / shape / contiguity checks of K2 and K3, on
    every device. ``dims`` = (B, H, G, D) as read from the caller's
    layout. What only the CUDA kernels refuse is ``check_head_dim``'s."""
    B, H, G, D = dims
    tensors = (q, k, v)
    if any(t.device != q.device for t in tensors):
        raise ValueError(f"{name}: q, k, v must be on one device")
    if q.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"{name}: unsupported device {q.device}")
    if any(t.dtype != q.dtype for t in tensors) or q.dtype not in DTYPES:
        raise TypeError(
            f"{name}: q, k, v must share a dtype in {list(DTYPES)}, got "
            f"{[t.dtype for t in tensors]}"
        )
    if k.shape != v.shape:
        raise ValueError(f"{name}: k {tuple(k.shape)} != v {tuple(v.shape)}")
    if G < 1 or H % G or D < 1:
        raise ValueError(f"{name}: need H % G == 0 and D >= 1, got H={H} G={G} D={D}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: q, k, v must be contiguous")


def check_head_dim(name: str, D: int) -> None:
    """The head widths the CUDA kernels of K2 and K3 take (the plain
    versions, on the CPU and meta devices, take any)."""
    if not 1 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"{name}: the CUDA kernel takes 1 <= D <= {MAX_HEAD_DIM}, got D={D}")


def launch(q, k, v, out, dims: Sequence[int], strides: Sequence[int], *,
           causal: bool, window: int, q_offset: int) -> None:
    """Launch K3. dims = (B, H, G, Sq, T, D); strides in elements:
    q (b, s, h), k (b, t, g), v (b, t, g), out (b, s, h)."""
    build.refuse_grad("flash_attention", q, k, v,
                      why="call flash_attention_op, whose FlashAttentionFn carries it")
    B, H, G, Sq, T, D = dims
    check_head_dim("flash_attention", D)
    if out.numel() == 0:
        return
    with torch.cuda.device(q.device):
        rc = build.library().flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            DTYPES[q.dtype], B, H, G, Sq, T, D, *strides,
            int(causal), int(window), int(q_offset), float(D ** -0.5),
            build.stream_handle(q),
        )
    build.check(rc, "flash_attention")
    flash_attention.launches += 1


def flash_attention(
    q: torch.Tensor,        # (B, H, Sq, D)
    k: torch.Tensor,        # (B, G, T, D)
    v: torch.Tensor,        # (B, G, T, D)
    *,
    causal: bool = True,
    window: int = 0,
    q_offset: int = 0,
) -> torch.Tensor:
    """Forward GQA attention; out (B, H, Sq, D) in q's dtype."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError("flash_attention: q and k must be 4-D")
    B, H, Sq, D = q.shape
    G, T = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D:
        raise ValueError(
            f"flash_attention: q {tuple(q.shape)} vs k {tuple(k.shape)}"
        )
    check_inputs("flash_attention", q, k, v, (B, H, G, D))
    # meta: the dry-run's route, shapes only; nothing is launched
    if q.device.type in ("cpu", "meta"):
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset)
    out = torch.empty_like(q)
    launch(
        q, k, v, out, (B, H, G, Sq, T, D),
        (q.stride(0), q.stride(2), q.stride(1),
         k.stride(0), k.stride(2), k.stride(1),
         v.stride(0), v.stride(2), v.stride(1),
         out.stride(0), out.stride(2), out.stride(1)),
        causal=causal, window=window, q_offset=q_offset,
    )
    return out


flash_attention.launches = 0
