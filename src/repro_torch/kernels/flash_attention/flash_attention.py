"""K3 wrapper: prefill flash attention (``csrc/flash_attention.cu``), and
the launch of its gradient, K3b (``csrc/flash_attention_bwd.cu``).

On a CUDA tensor it launches the kernel; on a CPU tensor it runs the plain
version. There is no fallback from the one to the other. The kernels take
element strides, so the (B, H, S, D) layout here and the model's
(B, S, H, D) layout (``ops.py``) launch them without a transposing copy."""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from .. import build
from .ref import NEG_INF, flash_attention_ref, no_key_rows  # noqa: F401  (NEG_INF: JAX's name)

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256       # D the CUDA kernels take; the plain versions take any
TILE_Q = 64              # q rows per block of the bf16 (tensor-core) kernel
BWD_TC_MAX_HEAD_DIM = 128   # K3b's tensor-core route: bf16 at D <= 128
BWD_OWN = 64             # rows a K3b block owns: keys (dK/dV pass), query rows (dQ pass)


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


def bwd_route(dtype: torch.dtype, D: int) -> str:
    """K3b's route (``flash_attention_bwd_launch``'s rule): bf16 at D <=
    128 on the tensor cores, fp32 and bf16 past D = 128 on the CUDA cores.
    Neither is a fallback for the other."""
    return ("tensor_cores" if dtype == torch.bfloat16 and D <= BWD_TC_MAX_HEAD_DIM
            else "cuda_cores")


def bwd_tiles(dtype: torch.dtype, D: int) -> Tuple[int, int]:
    """(owned, walked) rows a tile of K3b's blocks: a block owns 64 keys
    (dK/dV pass) or 64 query rows (dQ pass) and walks tiles of the other
    side. The tensor cores walk 64; the CUDA cores walk 32 up to D = 128
    and 16 past it (``walk_rows`` in the C source), so that the fp32 tiles
    fit shared memory."""
    if bwd_route(dtype, D) == "tensor_cores":
        return BWD_OWN, 64
    return BWD_OWN, 32 if D <= 128 else 16


def bwd_slice_heads(H: int, G: int, slices: int, g: int, sl: int) -> List[int]:
    """The query heads slice ``sl`` of KV head ``g`` holds, in the order
    its block walks them: heads g R + sl R/slices + j, j < R/slices."""
    R = H // G
    rs = R // slices
    return [g * R + sl * rs + j for j in range(rs)]


def bwd_key_tiles(qt: int, tile: int, Sq: int, T: int, *, causal: bool, window: int,
                  q_offset: int, k_tile: Optional[int] = None) -> List[int]:
    """The key tiles (of ``k_tile`` keys, ``tile`` by default) K3b's dQ
    pass walks for query tile ``qt`` (``tile`` rows), as K3's forward walks
    them: every tile holding a key that some row of the query tile sees
    (``key_tiles`` in the C source). Rows that see no key get no dQ, so
    they add no tile."""
    kt_ = k_tile or tile
    q0 = qt * tile
    p_lo, p_hi = q0 + q_offset, min(q0 + tile, Sq) - 1 + q_offset
    k_end = min(T, p_hi + 1) if causal else T
    k_begin = max(0, p_lo - window + 1) // kt_ * kt_ if window > 0 else 0
    return list(range(k_begin // kt_, -(-k_end // kt_))) if k_end > k_begin else []


def bwd_query_tiles(kt: int, tile: int, Sq: int, T: int, *, causal: bool, window: int,
                    q_offset: int, q_tile: Optional[int] = None) -> List[int]:
    """The query tiles (of ``q_tile`` rows, ``tile`` by default) K3b's
    dK/dV pass walks for key tile ``kt`` (``tile`` keys), in order
    (``query_tiles`` in ``csrc/flash_attention_bwd.cu``): the tiles of the
    rows that see a key of the tile, and every tile holding a row that sees
    no key, since such a row's softmax puts 1/T on each of the T keys and
    so reaches every key's dV. Those rows lie before position 0 (causal)
    and at or past position T + window - 1 (a window)."""
    qt_ = q_tile or tile
    n_qt = -(-Sq // qt_)
    t_hi = min(kt * tile + tile, T) - 1
    s_lo = max(0, kt * tile - q_offset) if causal else 0
    s_hi = min(Sq - 1, t_hi + window - 1 - q_offset) if window > 0 else Sq - 1
    n_pre, s_suf = no_key_rows(Sq, T, causal=causal, window=window, q_offset=q_offset)
    tiles = list(range(-(-n_pre // qt_)))
    if s_lo <= s_hi:
        tiles += range(max(len(tiles), s_lo // qt_), s_hi // qt_ + 1)
    if s_suf < Sq:
        tiles += range(max(tiles[-1] + 1 if tiles else 0, s_suf // qt_), n_qt)
    return tiles


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
           causal: bool, window: int, q_offset: int,
           lse: Optional[torch.Tensor] = None) -> None:
    """Launch K3. dims = (B, H, G, Sq, T, D); strides in elements:
    q (b, s, h), k (b, t, g), v (b, t, g), out (b, s, h). ``lse``, a
    contiguous fp32 (B, H, Sq) tensor, also gets each row's log-sum-exp
    (for K3b); without it (every served call) the kernel writes only out."""
    build.refuse_grad("flash_attention", q, k, v,
                      why="call flash_attention_op, whose FlashAttentionFn carries it")
    B, H, G, Sq, T, D = dims
    check_head_dim("flash_attention", D)
    if lse is not None and (lse.shape != (B, H, Sq) or lse.dtype != torch.float32
                            or not lse.is_contiguous() or lse.device != q.device):
        raise ValueError(f"flash_attention: lse must be a contiguous fp32 {(B, H, Sq)} "
                         f"tensor on {q.device}")
    if out.numel() == 0:
        return
    with torch.cuda.device(q.device):
        rc = build.library().flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            DTYPES[q.dtype], B, H, G, Sq, T, D, *strides,
            int(causal), int(window), int(q_offset), float(D ** -0.5),
            build.stream_handle(q),
        )
    build.check(rc, "flash_attention")
    flash_attention.launches += 1


def launch_bwd(q, k, v, o, do, lse, dq, dk, dv, *, causal: bool, window: int,
               q_offset: int) -> None:
    """Launch K3b on the model's layout: q, o, do, dq (B, Sq, H, D); k, v,
    dk, dv (B, T, G, D), one dtype, the last dim contiguous; lse the
    forward's fp32 (B, H, Sq), contiguous. Everything it cannot take is
    refused here, before the library is asked for."""
    B, Sq, H, D = q.shape
    T, G = k.shape[1], k.shape[2]
    tensors = (q, k, v, o, do, dq, dk, dv)
    if any(t.device != q.device for t in tensors + (lse,)):
        raise ValueError("flash_attention_bwd: every tensor must be on one device")
    if q.dtype not in DTYPES or any(t.dtype != q.dtype for t in tensors):
        raise TypeError(f"flash_attention_bwd: q, k, v, o, dO and the gradients must "
                        f"share a dtype in {list(DTYPES)}, got {[t.dtype for t in tensors]}")
    if (any(t.shape != q.shape for t in (o, do, dq))
            or any(t.shape != (B, T, G, D) for t in (k, v, dk, dv))):
        raise ValueError(f"flash_attention_bwd: q, o, dO, dq must be {tuple(q.shape)} "
                         f"and k, v, dk, dv {(B, T, G, D)}")
    if lse.shape != (B, H, Sq) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"flash_attention_bwd: lse must be a contiguous fp32 "
                         f"{(B, H, Sq)} tensor, got {tuple(lse.shape)} {lse.dtype}")
    if G < 1 or H % G:
        raise ValueError(f"flash_attention_bwd: need H % G == 0, got H={H} G={G}")
    if any(t.stride(-1) != 1 for t in tensors):
        raise ValueError("flash_attention_bwd: the last dim of every tensor must be "
                         "contiguous")
    check_head_dim("flash_attention_bwd", D)
    if q.numel() == 0 or k.numel() == 0:
        raise ValueError("flash_attention_bwd: empty q or k")
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    lib = build.library()
    # the head slices' fp32 dK and dV partials (none with one slice)
    scratch = torch.empty(lib.flash_attention_bwd_scratch_floats(B, H, G, T, D),
                          dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        rc = lib.flash_attention_bwd_launch(
            *(t.data_ptr() for t in (q, k, v, o, do, lse, delta, scratch, dq, dk, dv)),
            DTYPES[q.dtype], B, H, G, Sq, T, D,
            *(s for t in tensors for s in t.stride()[:3]),
            int(causal), int(window), int(q_offset), float(D ** -0.5),
            build.stream_handle(q),
        )
    build.check(rc, "flash_attention_bwd")


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
