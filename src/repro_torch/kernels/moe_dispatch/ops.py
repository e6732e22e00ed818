"""The MoE dispatch as the model calls it, with its gradient.

``moe_dispatch_op`` goes through ``MoEDispatchFn`` where autograd records a
call on the card: the forward is the kernel, the backward the gather
``moe_dispatch_bwd`` (plain PyTorch: the JAX package has no kernel on
either side, XLA differentiates its scatter). On the CPU and on meta the
plain version runs and autograd records its operations, as before the
kernel existed."""
from __future__ import annotations

from typing import Tuple

import torch
from torch.autograd.function import once_differentiable

from .moe_dispatch import moe_dispatch
from .ref import moe_dispatch_bwd


class MoEDispatchFn(torch.autograd.Function):
    """The kernel with a gradient with respect to x; top_i, pos_c and keep
    carry none. A second order raises."""

    @staticmethod
    def forward(ctx, x, top_i, n_experts: int, capacity: int):
        buffers, pos_c, keep = moe_dispatch(x, top_i, n_experts, capacity)
        ctx.save_for_backward(top_i, pos_c, keep)
        ctx.mark_non_differentiable(pos_c, keep)
        return buffers, pos_c, keep

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_buffers, _grad_pos_c, _grad_keep):
        top_i, pos_c, keep = ctx.saved_tensors
        return moe_dispatch_bwd(grad_buffers, top_i, pos_c, keep), None, None, None


def moe_dispatch_op(x: torch.Tensor, top_i: torch.Tensor, n_experts: int,
                    capacity: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(buffers (B, E, C, d), pos_c (B, S, K), keep (B, S, K)) of
    ``moe_dispatch``, differentiable in x on every device."""
    if x.device.type == "cuda" and torch.is_grad_enabled() and x.requires_grad:
        return MoEDispatchFn.apply(x, top_i, n_experts, capacity)
    return moe_dispatch(x, top_i, n_experts, capacity)
