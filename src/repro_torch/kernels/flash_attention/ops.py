"""K3 in the model's layout: (B, S, H, D) queries, (B, T, G, D) keys and
values, as ``models.attention`` produces them, with its gradient.

``flash_attention_op`` goes through ``FlashAttentionFn`` on every device:
the forward is K3 on the card and the plain version on the CPU; the
backward (``flash_attention_bwd``) is one function of PyTorch ops for
both, which recomputes the probabilities from the saved inputs. The JAX
package has no backward kernel: its attention gradient is XLA's autodiff
of an einsum, outside any Pallas kernel."""
from __future__ import annotations

from typing import Tuple

import torch

from .flash_attention import check_inputs, launch
from .ref import NEG_INF, flash_attention_ref


def _forward(q, k, v, causal: bool, window: int, q_offset: int) -> torch.Tensor:
    B, Sq, H, D = q.shape
    T, G = k.shape[1], k.shape[2]
    # meta: the dry-run's route, shapes only; nothing is launched
    if q.device.type in ("cpu", "meta"):
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


def flash_attention_bwd(
    q: torch.Tensor,          # (B, S, H, D)
    k: torch.Tensor,          # (B, T, G, D)
    v: torch.Tensor,
    o: torch.Tensor,          # (B, S, H, D), the forward's output
    do: torch.Tensor,         # (B, S, H, D), the gradient of o
    *,
    causal: bool = True,
    window: int = 0,
    q_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of K3 in fp32, cast back to the inputs' dtype. P =
    softmax(scale q kᵀ + mask) is recomputed with the causal or window
    mask and ``q_offset`` as K3 applies them; dV = Pᵀ dO and dK = scale
    dSᵀ Q are summed over the R = H/G query heads of a KV head; dS = P ∘
    (dO Vᵀ − rowsum(dO ∘ O)), dQ = scale dS K. Its peak is three (B, G, R,
    S, T) fp32 tensors."""
    B, S, H, D = q.shape
    T, G = k.shape[1], k.shape[2]
    R = H // G
    scale = D ** -0.5
    qf = q.float().reshape(B, S, G, R, D)
    kf, vf = k.float(), v.float()
    dof = do.float().reshape(B, S, G, R, D)
    s = torch.einsum("bsgrd,btgd->bgrst", qf, kf).mul_(scale)
    q_idx = torch.arange(S, device=q.device) + q_offset
    k_idx = torch.arange(T, device=q.device)
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_idx[None, :] <= q_idx[:, None]
    if window:
        mask &= k_idx[None, :] > q_idx[:, None] - window
    p = torch.softmax(s.masked_fill_(~mask, NEG_INF), dim=-1)
    del s
    dv = torch.einsum("bgrst,bsgrd->btgd", p, dof)
    delta = (dof * o.float().reshape(B, S, G, R, D)).sum(-1)     # (b, s, g, r)
    ds = torch.einsum("bsgrd,btgd->bgrst", dof, vf)
    ds.sub_(delta.permute(0, 2, 3, 1)[..., None]).mul_(p)
    del p
    dq = torch.einsum("bgrst,btgd->bsgrd", ds, kf).mul_(scale)
    dk = torch.einsum("bgrst,bsgrd->btgd", ds, qf).mul_(scale)
    return (dq.reshape(B, S, H, D).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))


class FlashAttentionFn(torch.autograd.Function):
    """K3 with a gradient: the forward saves q, k, v and the output, the
    backward is ``flash_attention_bwd``."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, q_offset: int):
        out = _forward(q, k, v, causal, window, q_offset)
        ctx.save_for_backward(q, k, v, out)
        ctx.opts = dict(causal=causal, window=window, q_offset=q_offset)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, do, **ctx.opts)
        return dq, dk, dv, None, None, None


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
    G = k.shape[2]
    if k.shape[0] != B or k.shape[3] != D:
        raise ValueError(
            f"flash_attention_op: q {tuple(q.shape)} vs k {tuple(k.shape)}"
        )
    check_inputs("flash_attention_op", q, k, v, (B, H, G, D))
    return FlashAttentionFn.apply(q, k, v, causal, window, q_offset)


def flash_attention_op_ref(q, k, v, *, causal=True, window=0, q_offset=0):
    """The plain version in the model's layout, on any device."""
    out = flash_attention_ref(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=causal, window=window, q_offset=q_offset,
    )
    return out.transpose(1, 2).contiguous()
