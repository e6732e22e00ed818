"""K4 in the model's layout, composed with the inter-chunk scan: the
counterpart of the JAX package's ``kernels/ssd_chunk/ops.py::ssd_op``, and
what ``models.ssm.ssd_chunked`` computes. Beyond the JAX wrapper it takes
g B/C groups that divide h (the kernel reads head h's group itself), a
length that is not a multiple of the chunk (the kernel treats positions
past it as the JAX model's zero padding), and an initial state."""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .ref import ssd_chunk_ref
from .ssd_chunk import check_inputs, launch


def _check(x, a, B, C, chunk: int) -> None:
    if x.dim() != 4 or a.dim() != 3 or B.dim() != 4:
        raise ValueError("ssd_chunk_op: xbar and B must be 4-D, a 3-D")
    b, l, h, _ = x.shape
    g = B.shape[2]
    if a.shape != (b, l, h) or B.shape[:2] != (b, l) or g < 1 or h % g:
        raise ValueError(
            f"ssd_chunk_op: xbar {tuple(x.shape)}, a {tuple(a.shape)}, "
            f"B {tuple(B.shape)} do not agree (groups must divide heads)"
        )
    if chunk < 1:
        raise ValueError(f"ssd_chunk_op: chunk must be positive, got {chunk}")
    check_inputs("ssd_chunk_op", x, a, B, C)


def ssd_chunk_op(
    xbar: torch.Tensor,    # (b, l, h, p)
    a: torch.Tensor,       # (b, l, h)
    B: torch.Tensor,       # (b, l, g, n)
    C: torch.Tensor,       # (b, l, g, n)
    chunk: int,
    *,
    which: Optional[str] = None,
):
    """K4 over chunks of ``chunk`` positions. Returns (y_diag (b,l,h,p) in
    xbar's dtype, states (b,h,nc,p,n) fp32, out_decay (b,h,nc,chunk) fp32),
    nc = ceil(l / chunk); a ragged last chunk is zero-padded. ``which``
    names a route (``ssd_chunk.route``'s default otherwise); the CPU runs
    the plain version whatever it says."""
    _check(xbar, a, B, C, chunk)
    # meta: the dry-run's route, shapes only; nothing is launched
    if xbar.device.type in ("cpu", "meta"):
        return ssd_chunk_op_ref(xbar, a, B, C, chunk)
    b, l, h, p = xbar.shape
    g, n = B.shape[2], B.shape[3]
    nc = -(-l // chunk)
    a = a.float()
    y = torch.empty((b, l, h, p), dtype=xbar.dtype, device=xbar.device)
    states = torch.empty((b, h, nc, p, n), dtype=torch.float32, device=xbar.device)
    decay = torch.empty((b, h, nc, chunk), dtype=torch.float32, device=xbar.device)
    launch(xbar, a, B, C, y, states, decay, (b, h, g, l, chunk, p, n),
           (xbar.stride(0), xbar.stride(1), xbar.stride(2),
            a.stride(0), a.stride(1), a.stride(2),
            B.stride(0), B.stride(1), B.stride(2),
            C.stride(0), C.stride(1), C.stride(2),
            y.stride(0), y.stride(1), y.stride(2)), which)
    return y, states, decay


def _pad_to(t: torch.Tensor, length: int) -> torch.Tensor:
    """Zero-pad dim 1 up to ``length``."""
    extra = length - t.shape[1]
    if not extra:
        return t
    return F.pad(t, (0, 0) * (t.dim() - 2) + (0, extra))


def ssd_chunk_op_ref(xbar, a, B, C, chunk: int):
    """The plain version in the model's layout, on any device: pad to a
    chunk multiple, fuse (b, h), broadcast B/C over each group's heads, and
    run ``ssd_chunk_ref``."""
    b, l, h, p = xbar.shape
    g, n = B.shape[2], B.shape[3]
    nc = -(-l // chunk)
    lp = nc * chunk

    def fuse(t):                       # (b, lp, h, ...) -> (b*h, nc, Q, ...)
        t = t.reshape(b, nc, chunk, h, -1).permute(0, 3, 1, 2, 4)
        return t.reshape(b * h, nc, chunk, -1)

    def per_head(t):                   # (b, lp, g, n) -> (b, lp, h, n)
        return t[:, :, :, None].expand(b, lp, g, h // g, n).reshape(b, lp, h, n)

    xc = fuse(_pad_to(xbar, lp))
    ac = fuse(_pad_to(a, lp)[..., None])[..., 0]
    Bc = fuse(per_head(_pad_to(B, lp)))
    Cc = fuse(per_head(_pad_to(C, lp)))
    y, states, decay = ssd_chunk_ref(xc, ac, Bc, Cc)
    y = y.reshape(b, h, lp, p).transpose(1, 2)[:, :l].contiguous()
    return (y, states.reshape(b, h, nc, p, n), decay.reshape(b, h, nc, chunk))


def _ssd(intra, xbar, a, B, C, chunk, initial_state):
    b, l, h, p = xbar.shape
    g, n = B.shape[2], B.shape[3]
    r = h // g
    y_diag, states, decay = intra(xbar, a, B, C, chunk)
    nc = states.shape[2]

    # inter-chunk recurrence in fp32, emitting the state before each chunk
    chunk_decay = decay[..., -1]                                 # (b, h, nc)
    s = (initial_state.float() if initial_state is not None else
         torch.zeros((b, h, p, n), dtype=torch.float32, device=xbar.device))
    prev = torch.empty_like(states)
    for c in range(nc):
        prev[:, :, c] = s
        s = s * chunk_decay[:, :, c, None, None] + states[:, :, c]

    # contribution of the carried state: C_i . prev * out_decay_i
    Cc = _pad_to(C, nc * chunk).float().reshape(b, nc, chunk, g, n)
    pr = prev.to(xbar.dtype).float().reshape(b, g, r, nc, p, n)
    dr = decay.reshape(b, g, r, nc, chunk).permute(0, 3, 4, 1, 2)  # (b,c,i,g,r)
    y_off = torch.einsum("bcign,bgrcpn->bcigrp", Cc, pr) * dr[..., None]
    y_off = y_off.reshape(b, nc * chunk, h, p)[:, :l]
    y = (y_diag.float() + y_off).to(torch.promote_types(xbar.dtype, a.dtype))
    return y, s.to(xbar.dtype)


def ssd_op(
    xbar: torch.Tensor,                          # (b, l, h, p), times dt
    a: torch.Tensor,                             # (b, l, h) log decays
    B: torch.Tensor,                             # (b, l, g, n)
    C: torch.Tensor,                             # (b, l, g, n)
    chunk: int,
    initial_state: Optional[torch.Tensor] = None,  # (b, h, p, n)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD through K4: returns (y (b,l,h,p), final_state
    (b,h,p,n) in xbar's dtype). y is in the promotion of xbar's and a's
    dtypes, as the JAX model's einsums give it."""
    return _ssd(ssd_chunk_op, xbar, a, B, C, chunk, initial_state)


def ssd_op_ref(xbar, a, B, C, chunk, initial_state=None):
    """``ssd_op`` with the plain version of K4 in place of the kernel."""
    return _ssd(ssd_chunk_op_ref, xbar, a, B, C, chunk, initial_state)
