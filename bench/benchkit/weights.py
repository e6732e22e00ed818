"""Weights made on the device from the seed, in the port's parameter
layout: ``embedding`` (V, d), ``head`` (d, V), ``ln_f`` (d,), and
``blocks``, one dict per position of the layer plan with every leaf
stacked along a leading n_periods axis.

Every leaf has a generator of its own, seeded from (seed, leaf name), and
is drawn in one call in the dtype it is served in, so the reference can
make any leaf again without making the others. The distributions are the
configuration file's ``initializer_range`` rule (see ``assumed.weights``
there); the port's own ``init_params`` is not used.
"""
from __future__ import annotations

import hashlib
import math
from typing import Callable, Dict, Iterator, List, Tuple

import torch

Leaf = Tuple[Tuple[int, ...], torch.dtype, Tuple[str, float, float]]


def leaf_seed(seed: int, name: str) -> int:
    digest = hashlib.sha256(f"{seed}/{name}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)


def layout(cfg, init_range: float) -> Dict[str, Leaf]:
    """{leaf path: (shape, dtype, (kind, a, b))} for a port ``ModelConfig``.
    kind: ``normal`` (std a), ``uniform`` [a, b), ``full`` a, ``log_uniform``
    (log U[a, b]) or ``dt_bias`` (inverse softplus of exp U[log a, log b])."""
    d, dt, n = cfg.d_model, cfg.dtype, cfg.n_periods
    f32 = torch.float32
    out: Dict[str, Leaf] = {
        "embedding": ((cfg.vocab, d), dt, ("normal", init_range, 0.0)),
        "ln_f": ((d,), dt, ("full", 1.0, 0.0)),
    }
    if not cfg.tie_embeddings:
        out["head"] = ((d, cfg.vocab), dt, ("normal", init_range, 0.0))
    for j, (mixer, channel) in enumerate(cfg.layer_plan()):
        p = f"blocks.{j}."

        def put(name, shape, kind, a=0.0, b=0.0, dtype=dt):
            out[p + name] = ((n,) + tuple(shape), dtype, (kind, a, b))

        put("ln1", (d,), "full", 1.0)
        if mixer == "attn":
            H, G, D = cfg.n_heads, cfg.n_kv_heads, cfg.hd
            put("wq", (d, H * D), "normal", init_range)
            put("wo", (H * D, d), "normal", init_range)
            put("wk", (d, G * D), "normal", init_range)
            put("wv", (d, G * D), "normal", init_range)
            if cfg.qkv_bias:
                for name, w in (("bq", H * D), ("bk", G * D), ("bv", G * D)):
                    put(name, (w,), "full", 0.0)
        elif mixer == "ssm":
            di, h, w = cfg.ssm_d_inner, cfg.ssm_heads, cfg.conv_width
            gn = cfg.ssm_groups * cfg.ssm_state
            for name, width in (("w_z", di), ("w_x", di), ("w_B", gn), ("w_C", gn),
                                ("w_dt", h)):
                put(name, (d, width), "normal", init_range)
            for k, width in (("x", di), ("B", gn), ("C", gn)):
                put(f"conv_{k}_w", (w, width), "uniform", -0.5, 0.5)
                put(f"conv_{k}_b", (width,), "uniform", -0.5, 0.5)
            put("dt_bias", (h,), "dt_bias", 1e-3, 1e-1)
            put("A_log", (h,), "log_uniform", 1.0, 16.0, dtype=f32)
            put("D", (h,), "full", 1.0)
            put("norm", (di,), "full", 1.0)
            put("w_out", (di, d), "normal", init_range / math.sqrt(cfg.n_layers))
        else:
            raise ValueError(f"no weights rule for a {mixer!r} mixer")
        if channel == "moe":
            E, ff = cfg.n_experts, cfg.d_ff
            put("ln2", (d,), "full", 1.0)
            put("router", (d, E), "normal", init_range, dtype=f32)
            put("w_gate", (E, d, ff), "normal", init_range)
            put("w_up", (E, d, ff), "normal", init_range)
            put("w_down", (E, ff, d), "normal", init_range)
        elif channel == "mlp":
            put("ln2", (d,), "full", 1.0)
            put("w_gate", (d, cfg.d_ff), "normal", init_range)
            put("w_up", (d, cfg.d_ff), "normal", init_range)
            put("w_down", (cfg.d_ff, d), "normal", init_range)
        elif channel != "none":
            raise ValueError(f"no weights rule for a {channel!r} channel")
    return out


def make_leaf(seed: int, name: str, leaf: Leaf, device) -> torch.Tensor:
    shape, dtype, (kind, a, b) = leaf
    if kind == "full":
        return torch.full(shape, a, dtype=dtype, device=device)
    gen = torch.Generator(device=device).manual_seed(leaf_seed(seed, name))
    if kind == "normal":
        return torch.randn(shape, generator=gen, dtype=dtype, device=device).mul_(a)
    u = torch.rand(shape, generator=gen, dtype=torch.float32, device=device)
    if kind == "uniform":
        v = u * (b - a) + a
    elif kind == "log_uniform":
        v = torch.log(u * (b - a) + a)
    elif kind == "dt_bias":
        dt = torch.exp(u * (math.log(b) - math.log(a)) + math.log(a)).clamp_min(1e-4)
        v = dt + torch.log(-torch.expm1(-dt))
    else:
        raise ValueError(f"unknown init {kind!r}")
    return v.to(dtype)


def make(cfg, seed: int, init_range: float, device) -> Dict:
    """The whole tree for ``cfg`` from ``seed`` on ``device``."""
    spec = layout(cfg, init_range)
    tree: Dict = {"blocks": [{} for _ in cfg.layer_plan()]}
    for name, leaf in spec.items():
        t = make_leaf(seed, name, leaf, device)
        if name.startswith("blocks."):
            _, j, key = name.split(".", 2)
            tree["blocks"][int(j)][key] = t
        else:
            tree[name] = t
    return tree


def iter_leaves(tree: Dict) -> Iterator[Tuple[str, torch.Tensor]]:
    """(path, leaf) in ``layout``'s names."""
    for name, t in tree.items():
        if name == "blocks":
            for j, block in enumerate(t):
                for key, leaf in block.items():
                    yield f"blocks.{j}.{key}", leaf
        else:
            yield name, t


def check_layout(tree: Dict, abstract: Dict) -> None:
    """Raise unless ``tree`` has the port's leaves (``abstract``, from
    ``abstract_params``) with their shapes and dtypes."""
    mine = {k: (tuple(t.shape), t.dtype) for k, t in iter_leaves(tree)}
    theirs = {k: (tuple(t.shape), t.dtype) for k, t in iter_leaves(abstract)}
    if mine != theirs:
        diff = sorted(set(mine.items()) ^ set(theirs.items()), key=str)
        raise ValueError(f"weights differ from the port's parameter layout: {diff[:6]}")


def same_bits(tree: Dict, cfg, seed: int, init_range: float, device,
              load: Callable[[torch.Tensor], torch.Tensor] = lambda t: t) -> List[str]:
    """The leaves of ``tree`` (each brought to ``device`` by ``load``) that
    differ in any bit from the same leaf made again from ``seed``."""
    spec = layout(cfg, init_range)
    bad = []
    for name, t in iter_leaves(tree):
        fresh = make_leaf(seed, name, spec[name], device)
        got = load(t)
        if got.shape != fresh.shape or got.dtype != fresh.dtype or not torch.equal(
                got.view(torch.uint8) if got.dim() else got,
                fresh.view(torch.uint8) if fresh.dim() else fresh):
            bad.append(name)
        del fresh, got
    return bad
