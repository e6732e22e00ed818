"""OLMoE-1B-7B as the configuration runs it, in plain PyTorch in fp32 (TF32
off): the reference that decides ``correct`` for the OLMoE cells.

Per layer: RMS norm, multi-head attention (rotary embedding, half-split,
on q and k; causal softmax in fp32), the residual add, RMS norm, and the
MoE channel: an fp32 router over all experts, the top-k by probability
renormalised to sum to one, capacity ``C = int(S * k / E * cf + 0.9999)``
per expert in each sequence, assignments taken in token order and then by
rank, those past C dropped, and each expert a SwiGLU on the tokens it
keeps. Then the final norm and the head, at the last position only.

It reads the weights in the port's layout as the benchmark made them
(``blocks[0][name][layer]``) and works out everything else itself; only
the tokens an expert keeps are computed, a layer at a time.
``fp8_control=True`` is the control: every weight product with fp8
operands (see ``plain.Matmul``); the router stays fp32.
"""
from __future__ import annotations

from typing import Dict

import torch

from .plain import Matmul, rms_norm

Sizes = Dict[str, float]


def capacity(S: int, k: int, E: int, cf: float) -> int:
    return min(max(1, int((S * k / E) * cf + 0.9999)), S * k)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (S, H, D), positions 0..S-1, the two halves of D rotated."""
    S, _, D = x.shape
    half = D // 2
    freqs = 1.0 / theta ** (torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def attention(q, k, v, heads_per_block: int = 4) -> torch.Tensor:
    """Causal softmax attention, q, k, v (S, H, D) fp32, a few heads at a
    time; returns (S, H*D)."""
    S, H, D = q.shape
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    out = torch.empty(S, H, D, dtype=torch.float32, device=q.device)
    for h0 in range(0, H, heads_per_block):
        h1 = min(h0 + heads_per_block, H)
        s = torch.einsum("shd,thd->hst", q[:, h0:h1], k[:, h0:h1]) * D ** -0.5
        s = s.masked_fill(~mask, float("-inf")).softmax(-1)
        out[:, h0:h1] = torch.einsum("hst,thd->shd", s, v[:, h0:h1])
    return out.reshape(S, H * D)


def moe(h: torch.Tensor, p: Dict, i: int, z: Sizes, mm: Matmul) -> torch.Tensor:
    S = h.shape[0]
    E, K = int(z["n_experts"]), int(z["top_k"])
    probs = (h @ p["router"][i].float()).softmax(-1)
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = top_p[:, :K], top_i[:, :K]
    top_p = top_p / top_p.sum(-1, keepdim=True)
    C = capacity(S, K, E, float(z["capacity_factor"]))
    flat_e = top_i.reshape(-1)                      # token-major, then rank
    onehot = torch.nn.functional.one_hot(flat_e, E)
    slot = (onehot.cumsum(0) - onehot).gather(1, flat_e[:, None])[:, 0]
    kept = slot < C
    tok = torch.arange(S, device=h.device).repeat_interleave(K)[kept]
    wts = top_p.reshape(-1)[kept]
    exp = flat_e[kept]
    order = torch.argsort(exp, stable=True)          # each expert's tokens, in order
    tok, wts = tok[order], wts[order]
    counts = torch.bincount(exp, minlength=E).tolist()
    y = torch.zeros_like(h)
    start = 0
    for e, n in enumerate(counts):
        if n:
            t = tok[start:start + n]
            x = h[t]
            a = torch.nn.functional.silu(mm(x, p["w_gate"][i, e])) * mm(x, p["w_up"][i, e])
            y.index_add_(0, t, mm(a, p["w_down"][i, e]) * wts[start:start + n, None])
        start += n
    return y


def last_logits(weights: Dict, tokens: torch.Tensor, z: Sizes,
                fp8_control: bool = False) -> torch.Tensor:
    """The fp32 logits (V,) at the last position of ``tokens`` (S,)."""
    mm = Matmul(fp8_control)
    p = weights["blocks"][0]
    eps, H, G, D = float(z["norm_eps"]), int(z["n_heads"]), int(z["n_kv_heads"]), int(z["hd"])
    S = tokens.shape[0]
    x = weights["embedding"][tokens].float()
    for i in range(int(z["n_layers"])):
        h = rms_norm(x, p["ln1"][i], eps)
        q = rope(mm(h, p["wq"][i]).reshape(S, H, D), float(z["rope_theta"]))
        k = rope(mm(h, p["wk"][i]).reshape(S, G, D), float(z["rope_theta"]))
        v = mm(h, p["wv"][i]).reshape(S, G, D)
        if G != H:
            k, v = (t.repeat_interleave(H // G, dim=1) for t in (k, v))
        x = x + mm(attention(q, k, v), p["wo"][i])
        x = x + moe(rms_norm(x, p["ln2"][i], eps), p, i, z, mm)
    h = rms_norm(x[-1:], weights["ln_f"], eps)
    return mm(h, weights["head"])[0]
