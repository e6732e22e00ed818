"""Parameter initialization in the JAX package's layout: (d_in, d_out)
weights, every block leaf stacked along a leading ``n_periods`` axis, and
``params["blocks"]`` a list with one dict per position in the period.

``init_params`` (and ``init_layer``/``init_period``, one layer or period
unstacked) draws the JAX package's distributions (scaled normals,
ones, zeros) from a ``torch.Generator`` — the numbers differ from
``jax.random``'s. A normal's default scale is (fan-in)^-0.5, the first
axis of the unstacked leaf as the JAX package takes it; where that is not
the second-last axis (the stacked expert leaves, whose JAX scale is
E^-0.5) the scale is passed explicitly. ``abstract_params`` gives the same
tree on the meta device, from the same leaf specs (``_layer_specs``), and
``param_bytes(cfg)`` sizes it. ``params_from_jax`` converts a JAX
parameter tree (as numpy arrays) so both packages can run on the same
weights.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..tree import tree_leaves, tree_map


def _dense(gen, shape, dtype, device, scale=None) -> torch.Tensor:
    scale = scale if scale is not None else shape[-2] ** -0.5
    w = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    # in place: one fp32 draw of OLMoE's stacked expert leaf is 8.6 GB
    return w.mul_(scale).to(device=device, dtype=dtype)


# A leaf's spec: (shape, dtype, init), init ("normal", scale or None for
# the fan-in default) or ("full", value). Block shapes leave out the
# leading n_periods axis.
Spec = Tuple[Tuple[int, ...], torch.dtype, Tuple[str, Optional[float]]]


def _layer_specs(cfg, mixer: str, channel: str) -> Dict[str, Spec]:
    """One layer's leaves, in the order ``init_params`` draws them."""
    d, dt = cfg.d_model, cfg.dtype
    H, G, D = cfg.n_heads, cfg.n_kv_heads, cfg.hd

    def normal(*shape, scale=None, dtype=dt):
        return shape, dtype, ("normal", scale)

    def full(value, *shape, dtype=dt):
        return shape, dtype, ("full", value)

    p: Dict[str, Spec] = {"ln1": full(1.0, d)}
    if mixer == "attn":
        p.update(wq=normal(d, H * D), wo=normal(H * D, d),
                 wk=normal(d, G * D), wv=normal(d, G * D))
        if cfg.qkv_bias:
            p.update(bq=full(0.0, H * D), bk=full(0.0, G * D),
                     bv=full(0.0, G * D))
    elif mixer == "cross_attn":                  # no bias, whatever qkv_bias
        p.update(wq=normal(d, H * D), wo=normal(H * D, d),
                 wk_cross=normal(d, G * D), wv_cross=normal(d, G * D))
    else:                                        # ssm
        di, h, w = cfg.ssm_d_inner, cfg.ssm_heads, cfg.conv_width
        gn = cfg.ssm_groups * cfg.ssm_state
        p.update(
            w_z=normal(d, di), w_x=normal(d, di), w_B=normal(d, gn),
            w_C=normal(d, gn), w_dt=normal(d, h),
            conv_x_w=normal(w, di, scale=w ** -0.5), conv_x_b=full(0.0, di),
            conv_B_w=normal(w, gn, scale=w ** -0.5), conv_B_b=full(0.0, gn),
            conv_C_w=normal(w, gn, scale=w ** -0.5), conv_C_b=full(0.0, gn),
            dt_bias=full(0.5, h), A_log=full(0.0, h, dtype=torch.float32),
            D=full(1.0, h), norm=full(1.0, di), w_out=normal(di, d),
        )
    if channel == "mlp":
        p.update(ln2=full(1.0, d), w_gate=normal(d, cfg.d_ff),
                 w_up=normal(d, cfg.d_ff), w_down=normal(cfg.d_ff, d))
    elif channel == "moe":
        # JAX scales (E, d_in, d_out) expert leaves by E^-0.5, the
        # first axis of the unstacked shape (ROADMAP.md, queue 3)
        E, f = cfg.n_experts, cfg.d_ff
        p.update(ln2=full(1.0, d),
                 router=normal(d, E, scale=d ** -0.5, dtype=torch.float32),
                 w_gate=normal(E, d, f, scale=E ** -0.5),
                 w_up=normal(E, d, f, scale=E ** -0.5),
                 w_down=normal(E, f, d, scale=E ** -0.5))
    return p


def _build(cfg, make: Callable[[Spec], torch.Tensor]) -> Dict:
    """The parameter tree with every leaf made by ``make(spec)``, block
    specs carrying the leading n_periods axis."""
    d, dt, n = cfg.d_model, cfg.dtype, cfg.n_periods
    params: Dict = {
        "embedding": make(((cfg.vocab, d), dt, ("normal", 0.02))),
        "ln_f": make(((d,), dt, ("full", 1.0))),
    }
    if not cfg.tie_embeddings:
        params["head"] = make(((d, cfg.vocab), dt, ("normal", None)))
    params["blocks"] = [
        {name: make(((n,) + shape, dtype, init))
         for name, (shape, dtype, init) in _layer_specs(cfg, mixer, channel).items()}
        for mixer, channel in cfg.layer_plan()
    ]
    return params


def _maker(generator: Optional[torch.Generator], device) -> Callable[[Spec], torch.Tensor]:
    """``make(spec)`` drawing from ``generator`` (a fresh one on ``device``
    when None) onto ``device`` (the current card by default)."""
    device = resolve_device(device)
    gen = generator if generator is not None else torch.Generator(device)

    def make(spec: Spec) -> torch.Tensor:
        shape, dtype, (kind, value) = spec
        if kind == "normal":
            return _dense(gen, shape, dtype, device, value)
        return torch.full(shape, value, dtype=dtype, device=device)

    return make


def init_params(cfg, generator: Optional[torch.Generator] = None,
                device=None) -> Dict:
    """Random parameters on ``device`` (the current card by default).
    Normals are drawn on the generator's device, so a CUDA generator keeps
    a full-size init on the card."""
    return _build(cfg, _maker(generator, device))


def init_layer(cfg, mixer: str, channel: str,
               generator: Optional[torch.Generator] = None, device=None) -> Dict:
    """One layer's leaves, unstacked (the JAX package's ``init_layer``,
    drawn from a ``torch.Generator`` in place of a ``jax.random`` key)."""
    make = _maker(generator, device)
    return {name: make(spec)
            for name, spec in _layer_specs(cfg, mixer, channel).items()}


def init_period(cfg, generator: Optional[torch.Generator] = None,
                device=None) -> List[Dict]:
    """One period's layers, one dict per position of ``cfg.layer_plan()``
    (the JAX package's ``init_period``): the leaves of ``init_params``'s
    blocks without their leading n_periods axis."""
    return [init_layer(cfg, mixer, channel, generator, device)
            for mixer, channel in cfg.layer_plan()]


def abstract_params(cfg) -> Dict:
    """The parameter tree of ``init_params`` as empty tensors on the meta
    device: the same leaf names, shapes and dtypes, nothing allocated
    (the JAX package's ``abstract_params``)."""
    return _build(cfg, lambda spec: torch.empty(spec[0], dtype=spec[1],
                                                device="meta"))


def _leaf_from_numpy(a, device) -> torch.Tensor:
    a = np.array(a)                      # a writable copy
    if a.dtype.name == "bfloat16":       # ml_dtypes: torch cannot take it
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_jax(tree, cfg, device=None) -> Dict:
    """The JAX package's parameter tree (leaves as numpy arrays, e.g.
    ``jax.tree.map(np.asarray, params)``) as the port's parameters."""
    device = resolve_device(device)
    return tree_map(lambda a: _leaf_from_numpy(a, device), tree)


def tree_bytes(params) -> int:
    """Bytes of the leaves of a parameter (or any tensor) tree."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(params))


def param_bytes(cfg) -> int:
    """Bytes of ``cfg``'s parameters, sized from ``abstract_params``
    (the JAX package's ``param_bytes``; Python integers, so a leaf of
    2^31 elements or more is counted whole)."""
    return tree_bytes(abstract_params(cfg))
