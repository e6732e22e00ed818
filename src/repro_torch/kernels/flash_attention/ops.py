"""K3 in the model's layout: (B, S, H, D) queries, (B, T, G, D) keys and
values, as ``models.attention`` produces them, with its gradient.

``flash_attention_op`` goes through ``FlashAttentionFn`` wherever autograd
records the call: the forward is K3 on the card, which also writes each
row's log-sum-exp, and the plain version on the CPU; the backward,
``flash_attention_op_bwd``, is K3b (``csrc/flash_attention_bwd.cu``) on
the card and ``flash_attention_bwd`` (PyTorch ops that recompute the
probabilities) on the CPU and meta. The JAX package has no backward
kernel: its attention gradient is XLA's autodiff of an einsum, outside
any Pallas kernel."""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from .flash_attention import check_inputs, launch, launch_bwd
from .ref import NEG_INF, flash_attention_lse_ref, flash_attention_ref, no_key_rows, visible


def _forward(q, k, v, causal: bool, window: int, q_offset: int, with_lse: bool = False):
    """out, or (out, lse) with ``with_lse``: lse (B, H, Sq) fp32 from K3 on
    the card and from the plain helper on the CPU; None on meta, where the
    dry-run counts what a call does and the plain backward reads no lse."""
    B, Sq, H, D = q.shape
    T, G = k.shape[1], k.shape[2]
    # meta: the dry-run's route, shapes only; nothing is launched
    if q.device.type in ("cpu", "meta"):
        out = flash_attention_op_ref(q, k, v, causal=causal, window=window, q_offset=q_offset)
        if not with_lse:
            return out
        lse = None if q.device.type == "meta" else flash_attention_lse_ref(
            q.transpose(1, 2), k.transpose(1, 2), causal=causal, window=window,
            q_offset=q_offset)
        return out, lse
    out = torch.empty_like(q)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    launch(
        q, k, v, out, (B, H, G, Sq, T, D),
        (q.stride(0), q.stride(1), q.stride(2),
         k.stride(0), k.stride(1), k.stride(2),
         v.stride(0), v.stride(1), v.stride(2),
         out.stride(0), out.stride(1), out.stride(2)),
        causal=causal, window=window, q_offset=q_offset, lse=lse,
    )
    return (out, lse) if with_lse else out


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
    """(dq, dk, dv) of K3 in fp32, cast back to the inputs' dtype: the
    plain version of K3b. P = softmax(scale q kᵀ + mask) is recomputed with
    the causal or window mask and ``q_offset`` as K3 applies them; dV = Pᵀ
    dO and dK = scale dSᵀ Q are summed over the R = H/G query heads of a KV
    head; dS = P ∘ (dO Vᵀ − rowsum(dO ∘ O)) where the mask is on and 0
    where it is off, dQ = scale dS K. On a row that sees no key the softmax
    of its T equal masked scores is 1/T everywhere: dV keeps it, and no
    masked score passes a gradient on to dQ or dK, as JAX's ``where`` does
    not. Its peak is three (B, G, R, S, T) fp32 tensors."""
    B, S, H, D = q.shape
    T, G = k.shape[1], k.shape[2]
    R = H // G
    scale = D ** -0.5
    qf = q.float().reshape(B, S, G, R, D)
    kf, vf = k.float(), v.float()
    dof = do.float().reshape(B, S, G, R, D)
    s = torch.einsum("bsgrd,btgd->bgrst", qf, kf).mul_(scale)
    off = ~visible(S, T, causal=causal, window=window, q_offset=q_offset, device=q.device)
    p = torch.softmax(s.masked_fill_(off, NEG_INF), dim=-1)
    del s
    dv = torch.einsum("bgrst,bsgrd->btgd", p, dof)
    delta = (dof * o.float().reshape(B, S, G, R, D)).sum(-1)     # (b, s, g, r)
    ds = torch.einsum("bsgrd,btgd->bgrst", dof, vf)
    ds.sub_(delta.permute(0, 2, 3, 1)[..., None]).mul_(p)
    del p
    # Where a row sees a key, P is exactly 0 off the mask, and so is dS; only
    # rows that see no key need the fill (and only they add its op to the
    # dry-run's count)
    n_pre, s_suf = no_key_rows(S, T, causal=causal, window=window, q_offset=q_offset)
    if n_pre or s_suf < S:
        ds.masked_fill_(off, 0.0)
    dq = torch.einsum("bgrst,btgd->bsgrd", ds, kf).mul_(scale)
    dk = torch.einsum("bgrst,bsgrd->btgd", ds, qf).mul_(scale)
    return (dq.reshape(B, S, H, D).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))


def flash_attention_op_bwd(
    q: torch.Tensor,          # (B, S, H, D)
    k: torch.Tensor,          # (B, T, G, D)
    v: torch.Tensor,
    o: torch.Tensor,          # (B, S, H, D), the forward's output
    do: torch.Tensor,         # (B, S, H, D), the gradient of o
    lse: Optional[torch.Tensor],   # (B, H, S) fp32, the forward's row log-sum-exp
    *,
    causal: bool = True,
    window: int = 0,
    q_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of K3 in the inputs' dtype: K3b on a CUDA tensor,
    ``flash_attention_bwd`` (which reads no lse) on the CPU and on meta.
    A build or launch failure raises; nothing hands the call on."""
    if q.device.type in ("cpu", "meta"):
        return flash_attention_bwd(q, k, v, o, do, causal=causal, window=window,
                                   q_offset=q_offset)
    if lse is None:
        raise ValueError("flash_attention_op_bwd: K3b needs the forward's lse")
    if q.numel() == 0 or k.numel() == 0:       # no rows, or no keys: every gradient is 0
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    do = do.to(q.dtype)
    if do.stride(-1) != 1:
        do = do.contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    launch_bwd(q, k, v, o, do, lse, dq, dk, dv, causal=causal, window=window,
               q_offset=q_offset)
    flash_attention_op_bwd.launches += 1
    return dq, dk, dv


flash_attention_op_bwd.launches = 0


class FlashAttentionFn(torch.autograd.Function):
    """K3 with a gradient: the forward saves q, k, v, the output and each
    row's log-sum-exp; the backward is ``flash_attention_op_bwd`` (K3b on
    the card). It has no gradient of its own: a second order raises."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, q_offset: int):
        out, lse = _forward(q, k, v, causal, window, q_offset, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = dict(causal=causal, window=window, q_offset=q_offset)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_op_bwd(q, k, v, out, do, lse, **ctx.opts)
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
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttentionFn.apply(q, k, v, causal, window, q_offset)
    return _forward(q, k, v, causal, window, q_offset)


def flash_attention_op_ref(q, k, v, *, causal=True, window=0, q_offset=0):
    """The plain version in the model's layout, on any device."""
    out = flash_attention_ref(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=causal, window=window, q_offset=q_offset,
    )
    return out.transpose(1, 2).contiguous()
