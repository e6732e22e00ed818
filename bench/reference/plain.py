"""Pieces the plain references share: fp32 with TF32 off, an RMS norm,
and the fp8 rounding that makes a reference into its control.

Nothing here imports JAX, the JAX package or the port."""
from __future__ import annotations

import torch

FP8_MAX = 448.0          # float8_e4m3fn's largest finite value


def tf32_off() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale.float()


def fp8(t: torch.Tensor, dim) -> torch.Tensor:
    """``t`` rounded to float8_e4m3fn with a scale per slice along ``dim``
    (amax / 448; ``None``: one scale for the tensor), back in fp32."""
    t = t.float()
    amax = t.abs().amax() if dim is None else t.abs().amax(dim=dim, keepdim=True)
    scale = (amax / FP8_MAX).clamp_min(1e-12)
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


class Matmul:
    """``x @ w`` in fp32, or, for the control (``fp8_control=True``), with
    x and w each rounded to fp8 under one scale a tensor, as an fp8 GEMM
    with per-tensor scaling takes them."""

    def __init__(self, fp8_control: bool) -> None:
        self.fp8 = fp8_control

    def __call__(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if not self.fp8:
            return x.float() @ w.float()
        return fp8(x, None) @ fp8(w, None)
