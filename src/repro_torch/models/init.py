"""Parameter initialization in the JAX package's layout: (d_in, d_out)
weights, every block leaf stacked along a leading ``n_periods`` axis, and
``params["blocks"]`` a list with one dict per position in the period.

``init_params`` draws the JAX package's distributions (scaled normals,
ones, zeros) from a ``torch.Generator`` — the numbers differ from
``jax.random``'s. A normal's default scale is (fan-in)^-0.5, the first
axis of the unstacked leaf as the JAX package takes it; where that is not
the second-last axis (the stacked expert leaves, whose JAX scale is
E^-0.5) the scale is passed explicitly. ``params_from_jax`` converts a
JAX parameter tree (as numpy arrays) so both packages can run on the same
weights.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..tree import tree_leaves, tree_map
from .transformer import check_supported


def _dense(gen, shape, dtype, device, scale=None) -> torch.Tensor:
    scale = scale if scale is not None else shape[-2] ** -0.5
    w = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    # in place: one fp32 draw of OLMoE's stacked expert leaf is 8.6 GB
    return w.mul_(scale).to(device=device, dtype=dtype)


def init_params(cfg, generator: Optional[torch.Generator] = None,
                device=None) -> Dict:
    """Random parameters on ``device`` (the current card by default).
    Normals are drawn on the generator's device, so a CUDA generator keeps
    a full-size init on the card."""
    check_supported(cfg)
    device = resolve_device(device)
    gen = generator if generator is not None else torch.Generator(device)
    d, dt, n = cfg.d_model, cfg.dtype, cfg.n_periods
    H, G, D = cfg.n_heads, cfg.n_kv_heads, cfg.hd

    def dense(*shape, scale=None, dtype=dt):
        return _dense(gen, (n,) + shape, dtype, device, scale)

    def const(value, *shape):
        return torch.full((n,) + shape, value, dtype=dt, device=device)

    params: Dict = {
        "embedding": _dense(gen, (cfg.vocab, d), dt, device, scale=0.02),
        "ln_f": torch.ones((d,), dtype=dt, device=device),
    }
    if not cfg.tie_embeddings:
        params["head"] = _dense(gen, (d, cfg.vocab), dt, device)
    blocks: List[Dict] = []
    for mixer, channel in cfg.layer_plan():
        p = {"ln1": const(1.0, d)}
        if mixer == "attn":
            p.update(wq=dense(d, H * D), wo=dense(H * D, d),
                     wk=dense(d, G * D), wv=dense(d, G * D))
            if cfg.qkv_bias:
                p.update(bq=const(0.0, H * D), bk=const(0.0, G * D),
                         bv=const(0.0, G * D))
        else:                                    # ssm
            di, h, w = cfg.ssm_d_inner, cfg.ssm_heads, cfg.conv_width
            gn = cfg.ssm_groups * cfg.ssm_state
            p.update(
                w_z=dense(d, di), w_x=dense(d, di), w_B=dense(d, gn),
                w_C=dense(d, gn), w_dt=dense(d, h),
                conv_x_w=dense(w, di, scale=w ** -0.5), conv_x_b=const(0.0, di),
                conv_B_w=dense(w, gn, scale=w ** -0.5), conv_B_b=const(0.0, gn),
                conv_C_w=dense(w, gn, scale=w ** -0.5), conv_C_b=const(0.0, gn),
                dt_bias=const(0.5, h),
                A_log=torch.zeros((n, h), dtype=torch.float32, device=device),
                D=const(1.0, h), norm=const(1.0, di), w_out=dense(di, d),
            )
        if channel == "mlp":
            p.update(ln2=const(1.0, d), w_gate=dense(d, cfg.d_ff),
                     w_up=dense(d, cfg.d_ff), w_down=dense(cfg.d_ff, d))
        elif channel == "moe":
            # JAX scales (E, d_in, d_out) expert leaves by E^-0.5, the
            # first axis of the unstacked shape (ROADMAP.md, queue 3)
            E, f = cfg.n_experts, cfg.d_ff
            p.update(ln2=const(1.0, d),
                     router=dense(d, E, scale=d ** -0.5, dtype=torch.float32),
                     w_gate=dense(E, d, f, scale=E ** -0.5),
                     w_up=dense(E, d, f, scale=E ** -0.5),
                     w_down=dense(E, f, d, scale=E ** -0.5))
        blocks.append(p)
    params["blocks"] = blocks
    return params


def _leaf_from_numpy(a, device) -> torch.Tensor:
    a = np.array(a)                      # a writable copy
    if a.dtype.name == "bfloat16":       # ml_dtypes: torch cannot take it
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_jax(tree, cfg, device=None) -> Dict:
    """The JAX package's parameter tree (leaves as numpy arrays, e.g.
    ``jax.tree.map(np.asarray, params)``) as the port's parameters."""
    check_supported(cfg)
    device = resolve_device(device)
    return tree_map(lambda a: _leaf_from_numpy(a, device), tree)


def param_bytes(params) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(params))
