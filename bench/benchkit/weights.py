"""Weights made on the device from the seed, in the port's parameter
layout: ``embedding`` (V, d), ``head`` (d, V), ``ln_f`` (d,), and
``blocks``, one dict per position of the layer plan with every leaf
stacked along a leading n_periods axis.

Every leaf has a generator of its own, seeded from (seed, leaf name), and
is drawn in one call in the dtype it is served in, so the reference can
make any leaf again without making the others. The leaves and their
shapes are the port's (``abstract_params``); the distributions are the
configuration file's ``initializer_range`` rule (see ``assumed.weights``
there) for the keys the table knows, and its ``init`` block for others.
The port's own ``init_params`` is not used.
"""
from __future__ import annotations

import hashlib
import math
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import torch

from benchkit import BenchError

Rule = Tuple[str, float, float]
Leaf = Tuple[Tuple[int, ...], torch.dtype, Rule]
KINDS = ("normal", "uniform", "full", "log_uniform", "dt_bias")


def leaf_seed(seed: int, name: str) -> int:
    digest = hashlib.sha256(f"{seed}/{name}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)


def key_rules(cfg, init_range: float) -> Dict[str, Rule]:
    """The rule of every leaf key the table knows, whatever the mixer or
    channel it sits in. kind: ``normal`` (std a), ``uniform`` [a, b),
    ``full`` a, ``log_uniform`` (log U[a, b]) or ``dt_bias`` (inverse
    softplus of exp U[log a, log b])."""
    normal, one = ("normal", init_range, 0.0), ("full", 1.0, 0.0)
    rules: Dict[str, Rule] = {"embedding": normal, "head": normal, "ln_f": one,
                              "ln1": one, "ln2": one, "router": normal,
                              "dt_bias": ("dt_bias", 1e-3, 1e-1),
                              "A_log": ("log_uniform", 1.0, 16.0), "D": one, "norm": one,
                              "w_out": ("normal", init_range / math.sqrt(cfg.n_layers), 0.0)}
    for key in ("wq", "wo", "wk", "wv", "w_z", "w_x", "w_B", "w_C", "w_dt",
                "w_gate", "w_up", "w_down"):
        rules[key] = normal
    for key in ("bq", "bk", "bv"):
        rules[key] = ("full", 0.0, 0.0)
    for key in ("conv_x_w", "conv_x_b", "conv_B_w", "conv_B_b", "conv_C_w", "conv_C_b"):
        rules[key] = ("uniform", -0.5, 0.5)
    return rules


def table(cfg) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """{leaf path: (shape, dtype)} of the mixer and channel kinds the
    benchmark knows (``attn``, ``ssm``; ``moe``, ``mlp``), worked out from
    the configuration alone; other kinds' leaves are not in it."""
    d, dt, n = cfg.d_model, cfg.dtype, cfg.n_periods
    f32 = torch.float32
    out = {"embedding": ((cfg.vocab, d), dt), "ln_f": ((d,), dt)}
    if not cfg.tie_embeddings:
        out["head"] = ((d, cfg.vocab), dt)
    for j, (mixer, channel) in enumerate(cfg.layer_plan()):
        p = f"blocks.{j}."

        def put(name, shape, dtype=dt):
            out[p + name] = ((n,) + tuple(shape), dtype)

        put("ln1", (d,))
        if mixer == "attn":
            H, G, D = cfg.n_heads, cfg.n_kv_heads, cfg.hd
            put("wq", (d, H * D))
            put("wo", (H * D, d))
            put("wk", (d, G * D))
            put("wv", (d, G * D))
            if cfg.qkv_bias:
                for name, w in (("bq", H * D), ("bk", G * D), ("bv", G * D)):
                    put(name, (w,))
        elif mixer == "ssm":
            di, h, w = cfg.ssm_d_inner, cfg.ssm_heads, cfg.conv_width
            gn = cfg.ssm_groups * cfg.ssm_state
            for name, width in (("w_z", di), ("w_x", di), ("w_B", gn), ("w_C", gn),
                                ("w_dt", h)):
                put(name, (d, width))
            for k, width in (("x", di), ("B", gn), ("C", gn)):
                put(f"conv_{k}_w", (w, width))
                put(f"conv_{k}_b", (width,))
            put("dt_bias", (h,))
            put("A_log", (h,), dtype=f32)
            put("D", (h,))
            put("norm", (di,))
            put("w_out", (di, d))
        if channel == "moe":
            E, ff = cfg.n_experts, cfg.d_ff
            put("ln2", (d,))
            put("router", (d, E), dtype=f32)
            put("w_gate", (E, d, ff))
            put("w_up", (E, d, ff))
            put("w_down", (E, ff, d))
        elif channel == "mlp":
            put("ln2", (d,))
            put("w_gate", (d, cfg.d_ff))
            put("w_up", (d, cfg.d_ff))
            put("w_down", (cfg.d_ff, d))
    return out


def port_leaves(cfg) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """{leaf path: (shape, dtype)} of the port's ``abstract_params(cfg)``,
    in its order."""
    from repro_torch.models import abstract_params

    return {k: (tuple(t.shape), t.dtype) for k, t in iter_leaves(abstract_params(cfg))}


def plan(cfg) -> List[Dict]:
    """One entry per layer, in order (``cfg.layer_plan() * cfg.n_periods``):
    its ``mixer``, its ``channel`` and ``macs``, the multiply-adds one
    token makes through the layer's weight matrices. Those are the leaves
    of two or more dimensions of its position, per period, in the port's
    shapes (which ``layout`` holds the table to); an expert leaf, one
    whose leading axis is ``n_experts``, counts at top_k / n_experts."""
    E, K = cfg.n_experts, cfg.top_k
    positions = cfg.layer_plan()
    macs = [0] * len(positions)
    for name, (shape, _) in port_leaves(cfg).items():
        unit = shape[1:]                         # one period's leaf
        if not name.startswith("blocks.") or len(unit) < 2:
            continue
        size = math.prod(unit)
        macs[int(name.split(".")[1])] += size // E * K if E and unit[0] == E else size
    return [{"mixer": mixer, "channel": channel, "macs": macs[j]}
            for _ in range(cfg.n_periods) for j, (mixer, channel) in enumerate(positions)]


def own_rules(init: Dict, init_range: float) -> Dict[str, Rule]:
    """A configuration file's ``init`` (leaf key -> [kind, a, b]; a or b
    may be ``"initializer_range"``) as rules."""
    out = {}
    for key, rule in init.items():
        if len(rule) != 3 or rule[0] not in KINDS:
            raise BenchError(f"init rule for leaf {key!r} is not [kind, a, b] "
                             f"with a kind of {KINDS}: {rule!r}")
        a, b = (init_range if v == "initializer_range" else float(v) for v in rule[1:])
        out[key] = (rule[0], a, b)
    return out


def layout(cfg, init_range: float, init: Optional[Dict] = None) -> Dict[str, Leaf]:
    """{leaf path: (shape, dtype, rule)} for every leaf of the port's
    parameter tree, in its order. A leaf of the table (``table``) keeps its
    shape and dtype, which must be the port's; every other leaf takes the
    port's. Each takes the rule of its key (the path's last part) from
    ``key_rules``, or else from ``init``, the configuration file's rules.
    A leaf with no rule, a rule no leaf takes, and a table leaf the port
    lacks or shapes otherwise are each a ``BenchError`` naming the leaf."""
    port = port_leaves(cfg)
    known = table(cfg)
    for name, spec in known.items():
        if port.get(name) != spec:
            raise BenchError(f"weights leaf {name!r}: the table has {spec}, "
                             f"the port {port.get(name, 'no such leaf')}")
    rules = key_rules(cfg, init_range)
    own = own_rules(init or {}, init_range)
    out, used = {}, set()
    for name, (shape, dtype) in port.items():
        key = name.rsplit(".", 1)[-1]
        rule = rules.get(key)
        if rule is None:
            if key not in own:
                raise BenchError(f"no weights rule for leaf {name!r}: give its key "
                                 f"{key!r} one under 'init' in the configuration file")
            rule = own[key]
            used.add(key)
        out[name] = (shape, dtype, rule)
    stray = sorted(set(own) - used)
    if stray:
        raise BenchError(f"init rules for leaves the port does not have, or that "
                         f"the table already rules: {stray}")
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


def make(cfg, seed: int, init_range: float, device, init: Optional[Dict] = None) -> Dict:
    """The whole tree for ``cfg`` from ``seed`` on ``device`` (``init``: the
    configuration file's rules, see ``layout``)."""
    spec = layout(cfg, init_range, init)
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


def same_bits(tree: Dict, cfg, seed: int, init_range: float, device,
              load: Callable[[torch.Tensor], torch.Tensor] = lambda t: t,
              init: Optional[Dict] = None) -> List[str]:
    """The leaves of ``tree`` (each brought to ``device`` by ``load``) that
    differ in any bit from the same leaf made again from ``seed``."""
    spec = layout(cfg, init_range, init)
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
