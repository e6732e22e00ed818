"""Operations and bytes of the work the cells do, from shapes alone: the
numerators of the roofline and ``mfu`` shares. Matrix products count 2
operations a multiply-add; elementwise work is not counted. Each input is
read once and each output written once, whatever a kernel reads again."""
from __future__ import annotations

from typing import Dict

Sizes = Dict[str, float]


def attention_flops(B: int, H: int, S: int, T: int, D: int, causal: bool = True) -> float:
    """QK^T and PV over the (query, key) pairs a causal mask keeps (the
    queries are the last S of T positions), or over all S * T."""
    if causal and T >= S:
        pairs = S * (T - S) + S * (S + 1) / 2
    else:
        pairs = S * T
    return 4.0 * B * H * D * pairs


def ssd_flops(b: int, l: int, h: int, p: int, g: int, n: int, chunk: int) -> float:
    """Chunked SSD: per chunk of q positions, C B^T per group over the
    causal half, (L o C B^T) x per head over the causal half, the chunk's
    state (B^T x) and the carried state's output (C h) per head."""
    total = 0.0
    for c0 in range(0, l, chunk):
        q = min(chunk, l - c0)
        half = q * (q + 1) / 2
        total += 2 * g * half * n + 2 * h * half * p + 2 * (2 * q * h * p * n)
    return b * total


def ssd_bytes(b: int, l: int, h: int, p: int, g: int, n: int, in_bytes: int = 2) -> float:
    """xbar, a (fp32), B and C in; y (fp32) and the final state out."""
    return b * (l * h * p * in_bytes + l * h * 4 + 2 * l * g * n * in_bytes
                + l * h * p * 4 + h * p * n * in_bytes)


def moe_flops(S: int, z: Sizes) -> float:
    """The router over all experts and the top-k experts' SwiGLU products,
    for every token (the capacity buffers' padding and drops not counted)."""
    d, E, K, f = z["d_model"], z["n_experts"], z["top_k"], z["d_ff"]
    return 2 * S * d * E + 2 * S * K * 3 * d * f


def moe_bytes(S: int, z: Sizes) -> float:
    """Every expert's weights and the router once, the input and output."""
    d, E, f = z["d_model"], z["n_experts"], z["d_ff"]
    return 2 * 3 * E * d * f + 4 * d * E + 2 * 2 * S * d


def window_pairs(S: int, W: int) -> float:
    """(query, key) pairs of a causal self-attention over S positions in
    which each query sees itself and the W - 1 keys before it."""
    if S <= W:
        return S * (S + 1) / 2
    return W * (W + 1) / 2 + (S - W) * W


def prefill_flops(S: int, z: Sizes) -> float:
    """A prefill of S tokens that emits one token, layer by layer over
    ``z["plan"]``: each layer's weight products over the S positions (its
    ``macs``), the attention pairs on ``attn`` layers (within the window
    where ``attn_window`` > 0) and the SSD scan on ``ssm`` layers; then the
    head at the last position."""
    d, V = z["d_model"], z["vocab"]
    total = 2 * d * V
    for layer in z["plan"]:
        total += 2 * S * layer["macs"]
        if layer["mixer"] == "attn":
            H, D, W = z["n_heads"], z["hd"], z.get("attn_window", 0)
            total += (4.0 * H * D * window_pairs(S, W) if W
                      else attention_flops(1, H, S, S, D))
        elif layer["mixer"] == "ssm":
            total += ssd_flops(1, S, z["ssm_heads"], z["ssm_head_dim"], z["ssm_groups"],
                               z["ssm_state"], int(z["ssm_chunk"]))
    return total
