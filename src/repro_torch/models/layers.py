"""Common neural-net building blocks on tensors.

The JAX package's sharding helpers (``shard``, ``pspec`` and the mesh
queries) have no work to do on one card; they are kept as no-ops so the
model code reads like its counterpart.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

Axis = Union[None, str, Tuple[str, ...]]

# Logical batch axes of the JAX package's meshes (unused here).
BATCH: Tuple[str, ...] = ("pod", "data")
MODEL = "model"


def mesh_axis_sizes() -> dict:
    return {}


def shard(x: torch.Tensor, *spec: Axis) -> torch.Tensor:
    """No mesh on one card: the identity."""
    return x


# ---------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def rope(
    x: torch.Tensor, positions: torch.Tensor, theta: float = 10_000.0
) -> torch.Tensor:
    """Rotary position embedding, half-split, in fp32 before the cast.
    x: (..., S, H, D); positions: (..., S)."""
    d = x.shape[-1]
    half = d // 2
    freqs = 1.0 / (
        theta ** (torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    )
    angles = positions[..., :, None].float() * freqs     # (..., S, half)
    cos = torch.cos(angles)[..., :, None, :]              # broadcast over heads
    sin = torch.sin(angles)[..., :, None, :]
    x32 = x.float()
    x1, x2 = x32[..., :half], x32[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def mlp_forward(params: dict, x: torch.Tensor, kind: str = "swiglu") -> torch.Tensor:
    """Gated MLP: SwiGLU (llama-family) or GeGLU (gemma; tanh-approximate
    GELU, jax.nn.gelu's default)."""
    h_gate = x @ params["w_gate"]
    h_up = x @ params["w_up"]
    act = F.gelu(h_gate, approximate="tanh") if kind == "geglu" else F.silu(h_gate)
    return (act * h_up) @ params["w_down"]


def embed(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    return params["embedding"][tokens]


def unembed(params: dict, x: torch.Tensor) -> torch.Tensor:
    """A separate head is (d, V); the tied embedding is (V, d)."""
    w = params.get("head", params["embedding"])
    if w.shape[0] != x.shape[-1]:
        return x @ w.t()
    return x @ w


def cross_entropy_loss(
    logits: torch.Tensor, labels: torch.Tensor, mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Mean next-token negative log-likelihood in fp32 (logsumexp minus
    the gold logit), over the positions where ``mask`` is set when given."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = logz - gold
    if mask is not None:
        mask = mask.float()
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)
