"""Parameter initialization in the JAX package's layout: (d_in, d_out)
weights, every block leaf stacked along a leading ``n_periods`` axis, and
``params["blocks"]`` a list with one dict per position in the period.

``init_params`` draws the JAX package's distributions (scaled normals,
ones, zeros) from a ``torch.Generator`` — the numbers differ from
``jax.random``'s. ``params_from_jax`` converts a JAX parameter tree (as
numpy arrays) so both packages can run on the same weights.
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
    return (w * scale).to(device=device, dtype=dtype)


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

    def dense(*shape, scale=None):
        return _dense(gen, (n,) + shape, dt, device, scale)

    def const(value, *shape):
        return torch.full((n,) + shape, value, dtype=dt, device=device)

    params: Dict = {
        "embedding": _dense(gen, (cfg.vocab, d), dt, device, scale=0.02),
        "ln_f": torch.ones((d,), dtype=dt, device=device),
    }
    if not cfg.tie_embeddings:
        params["head"] = _dense(gen, (d, cfg.vocab), dt, device)
    blocks: List[Dict] = []
    for _ in cfg.layer_plan():
        p = {
            "ln1": const(1.0, d),
            "wq": dense(d, H * D),
            "wo": dense(H * D, d),
            "wk": dense(d, G * D),
            "wv": dense(d, G * D),
            "ln2": const(1.0, d),
            "w_gate": dense(d, cfg.d_ff),
            "w_up": dense(d, cfg.d_ff),
            "w_down": dense(cfg.d_ff, d),
        }
        if cfg.qkv_bias:
            p.update(bq=const(0.0, H * D), bk=const(0.0, G * D),
                     bv=const(0.0, G * D))
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
