"""Expert-parallel MoE with an explicit all-to-all: the JAX package's
``models/moe_ep.py`` (its ``shard_map`` body) on a ``DeviceMesh``.

Tokens are sequence-sharded over the ``model`` axis (S padded to a
multiple of its size m) and batch-sharded over the data axes; each shard
routes its own N = B_loc * S_loc tokens with a capacity of its own,
C = ceil(N * K / E * capacity_factor) as the JAX expression writes it,
scatters them into (E, C, d) buffers (slots counted token-major over the
shard, then k), exchanges the buffers shard-major through one
``all_to_all_single`` over the ``model`` group (shard j owns experts
[j*E/m, (j+1)*E/m)), runs its local experts' products, and sends the
results back through a second one. The load-balance loss averages its
per-expert token share and mean probability over every mesh axis (JAX's
``pmean``).

Both all-to-alls carry gradients (``torch.distributed.nn.functional``);
the mean (``layers.pmean``) passes its replicated cotangent back divided
by the number of ranks, without a collective, as JAX transposes ``pmean``
onto a replicated result. So ``moe_ffn_ep`` has the gradient of
``moe_ffn`` when no token is dropped.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.distributed.nn.functional as dist_fn
import torch.nn.functional as F

from ..distributed.sharding import P
from .layers import BATCH, MODEL, _current_mesh, mesh_axis_sizes, pmean, shard, shard_map
from .moe import moe_ffn, top_k


def moe_ffn_ep(params: Dict, x: torch.Tensor, cfg, *, return_aux: bool = False):
    """Drop-in for moe_ffn; falls back when no model axis / E not
    divisible. x: (B, S, d)."""
    sizes = mesh_axis_sizes()
    m = sizes.get(MODEL, 1)
    E, K = cfg.n_experts, cfg.top_k
    if m == 1 or E % m != 0:
        return moe_ffn(params, x, cfg, return_aux=return_aux)

    mesh = _current_mesh()
    group = mesh.get_group(MODEL)
    B, S, d = x.shape
    ba = tuple(a for a in BATCH if a in sizes)
    n_batch = math.prod(sizes[a] for a in ba)
    if B % n_batch:
        raise ValueError(f"batch {B} does not divide the {ba} axes ({n_batch})")
    S_pad = math.ceil(S / m) * m
    rows = P(ba if ba else None, None, None)
    if S_pad != S:
        x = shard_map(lambda xl: F.pad(xl, (0, 0, 0, S_pad - S)), (rows,), rows, x)
    x_spec = P(ba if ba else None, MODEL, None)
    E_loc = E // m
    cf = cfg.capacity_factor

    def local(w_router, wg, wu, wd, xl):
        Bl, Sl, _ = xl.shape
        N = Bl * Sl
        xt = xl.reshape(N, d)
        logits = xt.float() @ w_router.float()
        probs = torch.softmax(logits, dim=-1)
        top_p, top_i = top_k(probs, K)
        top_p = (top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)).to(xt.dtype)
        C = max(1, int(N * K / E * cf + 0.9999))
        C = min(C, N * K)

        sel = F.one_hot(top_i, E)                                # (N, K, E)
        flat = sel.reshape(N * K, E)
        prior = flat.cumsum(dim=0) - flat
        pos = prior.gather(-1, top_i.reshape(N * K, 1)).reshape(N, K)
        keep = (pos < C).to(xt.dtype)
        pos_c = pos.clamp_max(C - 1)

        buf = torch.zeros((E, C, d), dtype=xt.dtype, device=xt.device)
        buf = buf.index_put((top_i, pos_c), xt[:, None, :] * keep[..., None],
                            accumulate=True)
        # exchange: shard-major expert order — shard j owns experts
        # [j*E_loc, (j+1)*E_loc)
        sent = dist_fn.all_to_all_single(torch.empty_like(buf), buf, group=group)
        sent = sent.reshape(m, E_loc, C, d)
        hg = torch.einsum("mecd,edf->mecf", sent, wg)
        hu = torch.einsum("mecd,edf->mecf", sent, wu)
        h = F.silu(hg) * hu
        out = torch.einsum("mecf,efd->mecd", h, wd).reshape(E, C, d)
        back = dist_fn.all_to_all_single(torch.empty_like(out), out, group=group)
        y = back[top_i, pos_c]                                   # (N, K, d)
        y = torch.sum(y * (top_p * keep)[..., None], dim=1)
        y = y.reshape(Bl, Sl, d)

        # load-balance loss, averaged over every mesh axis
        axes_all = (MODEL,) + ba
        fr = pmean(sel.float().mean(dim=(0, 1)), *axes_all)
        mp = pmean(probs.mean(dim=0), *axes_all)
        aux = E * torch.sum(fr * mp)
        return y, aux

    experts = P(MODEL, None, None)
    y, aux = shard_map(
        local, (P(), experts, experts, experts, x_spec), (x_spec, P()),
        params["router"], params["w_gate"], params["w_up"], params["w_down"], x)
    y = shard(y, BATCH, None, None)
    if S_pad != S:
        y = y[:, :S]
    if return_aux:
        return y, aux
    return y
