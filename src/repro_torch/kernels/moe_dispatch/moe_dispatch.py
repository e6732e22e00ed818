"""MoE dispatch wrapper (``csrc/moe_dispatch.cu``): each assignment's slot
in its expert's capacity buffer and the scatter of the token rows into the
buffers, in one kernel call of two launches.

On a CUDA tensor it launches the kernel; on a CPU tensor, and on meta (the
dry-run's route: shapes only), it runs the plain version. There is no
fallback from the one to the other."""
from __future__ import annotations

from typing import Tuple

import torch

from .. import build
from .ref import moe_dispatch_ref

# the bits of 1 in each dtype the kernel takes, which it writes into keep
ONE_BITS = {torch.bfloat16: 0x3F80, torch.float16: 0x3C00, torch.float32: 0x3F800000}
MAX_EXPERTS = 512          # the C source's kMaxExperts
THREADS = 256              # the C source's kThreads: assignments ranked a pass
MAX_TILES = 256            # tiles a row before tiles grow past one pass


def tiles(S: int, K: int) -> Tuple[int, int]:
    """(tokens a tile, tiles a row). A tile holds one ranking pass of
    assignments (at least one token), and more where a row would take over
    ``MAX_TILES`` tiles, since each block sums the counts of every tile of
    its row."""
    tile = max(1, THREADS // K, -(-S // MAX_TILES))
    return tile, -(-S // tile)


def check_inputs(x: torch.Tensor, top_i: torch.Tensor, n_experts: int, capacity: int) -> None:
    """Raise on what the kernel does not take, on every device."""
    if x.dim() != 3 or top_i.dim() != 3 or top_i.shape[:2] != x.shape[:2]:
        raise ValueError(f"moe_dispatch: x {tuple(x.shape)} must be (B, S, d) and "
                         f"top_i {tuple(top_i.shape)} (B, S, K)")
    if x.dtype not in ONE_BITS:
        raise TypeError(f"moe_dispatch: x must be one of {tuple(ONE_BITS)}, got {x.dtype}")
    if top_i.dtype != torch.int64:
        raise TypeError(f"moe_dispatch: top_i must be int64, got {top_i.dtype}")
    if top_i.device != x.device:
        raise ValueError("moe_dispatch: x and top_i on different devices")
    if not 1 <= n_experts <= MAX_EXPERTS:
        raise ValueError(f"moe_dispatch: {n_experts} experts; the kernel takes 1 to "
                         f"{MAX_EXPERTS}")
    if capacity < (1 if top_i.numel() else 0):
        raise ValueError(f"moe_dispatch: capacity {capacity} for {top_i.numel()} assignments")
    if x.shape[0] > 65535:
        raise ValueError(f"moe_dispatch: batch {x.shape[0]} past the grid's 65535 rows")


def moe_dispatch(x: torch.Tensor, top_i: torch.Tensor, n_experts: int,
                 capacity: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(buffers (B, E, C, d), pos_c (B, S, K) int64, keep (B, S, K)), equal
    to ``moe_dispatch_ref``'s wherever x is finite. x: (B, S, d) in bf16,
    fp16 or fp32; top_i: (B, S, K) int64 expert indices in [0, E) (the
    kernel does not range-check them), any strides. No gradient: a call
    autograd would record raises (``moe_dispatch_op`` carries it)."""
    check_inputs(x, top_i, n_experts, capacity)
    # meta: the dry-run's route, shapes only; nothing is launched
    if x.device.type in ("cpu", "meta"):
        return moe_dispatch_ref(x, top_i, n_experts, capacity)
    if x.device.type != "cuda":
        raise ValueError(f"moe_dispatch: unsupported device {x.device}")
    build.refuse_grad("moe_dispatch", x, why="moe_dispatch_op takes its gradient through "
                      "MoEDispatchFn")
    B, S, d = x.shape
    K = top_i.shape[-1]
    x = x.contiguous()
    buffers = torch.empty((B, n_experts, capacity, d), dtype=x.dtype, device=x.device)
    pos_c = torch.empty((B, S, K), dtype=torch.int64, device=x.device)
    keep = torch.empty((B, S, K), dtype=x.dtype, device=x.device)
    if top_i.numel() == 0:                 # no assignment: every slot is empty
        return buffers.zero_(), pos_c, keep
    tile, n_tiles = tiles(S, K)
    counts = torch.empty((B, n_tiles, n_experts), dtype=torch.int32, device=x.device)
    lib = build.library()
    with torch.cuda.device(x.device):
        rc = lib.moe_dispatch_launch(
            x.data_ptr(), top_i.data_ptr(), buffers.data_ptr(), pos_c.data_ptr(),
            keep.data_ptr(), counts.data_ptr(), B, S, K, n_experts, capacity, tile, n_tiles,
            x.element_size(), ONE_BITS[x.dtype], d * x.element_size(), *top_i.stride(),
            build.stream_handle(x),
        )
    build.check(rc, "moe_dispatch")
    moe_dispatch.launches += 1
    return buffers, pos_c, keep


moe_dispatch.launches = 0
