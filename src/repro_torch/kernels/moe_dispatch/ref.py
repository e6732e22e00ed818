"""Plain PyTorch version of the MoE dispatch: each assignment's slot in its
expert's capacity buffer and the scatter of the token rows into the
buffers, as ``models/moe.py`` of the JAX package computes them (XLA's
one-hot count and scatter-add), and the gradient of that scatter."""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def slot_positions(top_i: torch.Tensor, n_experts: int) -> torch.Tensor:
    """(B, S, K) slot of each assignment in its expert's buffer: the count
    of earlier assignments to that expert in the row, token-major then k."""
    B, S, K = top_i.shape
    flat = F.one_hot(top_i, n_experts).reshape(B, S * K, n_experts)
    prior = flat.cumsum(dim=1) - flat                         # exclusive count
    return prior.gather(-1, top_i.reshape(B, S * K, 1)).reshape(B, S, K)


def _batch_index(top_i: torch.Tensor) -> torch.Tensor:
    return torch.arange(top_i.shape[0], device=top_i.device)[:, None, None].expand_as(top_i)


def moe_dispatch_ref(x: torch.Tensor, top_i: torch.Tensor, n_experts: int,
                     capacity: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (B, S, d), top_i (B, S, K) int64. Returns the buffers (B, E, C, d)
    in x's dtype, pos_c (B, S, K) int64, each slot clamped to C-1, and keep
    (B, S, K) in x's dtype, 0 where the slot is past capacity. A dropped
    assignment adds x * 0 at slot C-1."""
    pos = slot_positions(top_i, n_experts)
    keep = (pos < capacity).to(x.dtype)                       # capacity drop
    pos_c = pos.clamp_max(capacity - 1)
    contrib = x[:, :, None, :] * keep[..., None]              # (B, S, K, d)
    buffers = torch.zeros((x.shape[0], n_experts, capacity, x.shape[-1]), dtype=x.dtype,
                          device=x.device)
    buffers.index_put_((_batch_index(top_i), top_i, pos_c), contrib, accumulate=True)
    return buffers, pos_c, keep


def moe_dispatch_bwd(grad_buffers: torch.Tensor, top_i: torch.Tensor, pos_c: torch.Tensor,
                     keep: torch.Tensor) -> torch.Tensor:
    """The gradient of the dispatch with respect to x, (B, S, d): each
    token's kept slots' gradients summed over its K assignments, the
    operations autograd records through ``moe_dispatch_ref``."""
    gathered = grad_buffers[_batch_index(top_i), top_i, pos_c]   # (B, S, K, d)
    return (gathered * keep[..., None]).sum(dim=2)
