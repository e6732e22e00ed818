"""Sharding rules: parameter / batch / cache partition specs per
architecture for the production meshes, as DTensor placements.

The JAX package's rules (``src/repro/distributed/sharding.py``) line for
line, on a ``torch.distributed.DeviceMesh`` whose ``mesh_dim_names`` are
``("data", "model")`` or ``("pod", "data", "model")``:

  * weights tensor-parallel over ``model`` (attention head projections,
    MLP hidden dim, MoE expert dim, Mamba inner dim), replicated over
    ``data``/``pod``;
  * batch sharded over (``pod``, ``data``);
  * decode KV caches shard batch over (pod, data) when divisible, else the
    sequence axis over ``data`` (long_500k batch=1);
  * optimizer moments follow their parameter (ZeRO-1 over ``data`` is an
    option, ``zero1_shardings``).

Every rule is divisibility-guarded: a dim that doesn't divide the mesh
axis stays replicated (e.g. yi-34b's 56 heads on a 16-way model axis shard
on the flattened head*head_dim projection instead; mamba2's 50280 vocab
embedding stays replicated).

``P`` is JAX's ``PartitionSpec``: one entry per tensor dimension, each
None, a mesh axis name, or a tuple of names (major to minor), so a spec
compares entry for entry with JAX's. ``NamedSharding`` pairs it with a
mesh; its ``placements`` (``to_placements``) give one ``Shard(dim)`` per
mesh dimension that an entry names and ``Replicate()`` for the rest. An
entry naming several axes in mesh order keeps JAX's block order: on a
(2, 4) mesh, ``P(("data", "model"))`` puts block ``data*4 + model`` on
rank (data, model), as ``[Shard(0), Shard(0)]`` does.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

from torch.distributed.tensor import Replicate, Shard, distribute_tensor

from ..tree import tree_leaves, tree_map, tree_map_with_path, tree_unflatten


class P(tuple):
    """JAX's ``PartitionSpec``: a single-name tuple entry becomes the name,
    as JAX normalises it."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                return e[0] if len(e) == 1 else e
            return e
        return super().__new__(cls, tuple(norm(e) for e in entries))

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(self)


def _names(mesh) -> Tuple[str, ...]:
    return tuple(mesh.mesh_dim_names)


def _axis_size(mesh, name) -> int:
    if isinstance(name, tuple):
        s = 1
        for n in name:
            s *= _axis_size(mesh, n)
        return s
    return dict(zip(_names(mesh), mesh.shape)).get(name, 1)


def _guard(mesh, shape: Tuple[int, ...], spec: Tuple) -> P:
    """Drop spec entries whose mesh-axis size doesn't divide the dim."""
    out = []
    for dim, entry in zip(shape, spec):
        if entry is None:
            out.append(None)
            continue
        if dim % _axis_size(mesh, entry) == 0:
            out.append(entry)
        else:
            out.append(None)
    return P(*out)


def to_placements(spec: Tuple, mesh) -> List:
    """The DTensor placements of ``spec`` on ``mesh``: ``Shard(i)`` on each
    mesh dimension that entry i names, ``Replicate()`` elsewhere. A mesh
    dimension of size 1 shards nothing and stays ``Replicate()`` (DTensor
    cannot flatten a dimension of size 1 that it holds sharded, as every
    matrix product over (B, S) would at B = 1). Raises ``ValueError`` for an
    axis the mesh lacks, an axis named twice, or an entry whose names are
    not in mesh order (DTensor cannot express it)."""
    names = _names(mesh)
    sizes = tuple(mesh.shape)
    placements: List = [Replicate()] * len(names)
    named = set()
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        for a in axes:
            if a not in names:
                raise ValueError(f"{spec}: mesh {names} has no axis {a!r}")
        dims = [names.index(a) for a in axes]
        if dims != sorted(dims):
            raise ValueError(f"{spec}: entry {entry} is not in mesh order {names}")
        for d in dims:
            if d in named:
                raise ValueError(f"{spec}: axis {names[d]!r} named twice")
            named.add(d)
            if sizes[d] > 1:
                placements[d] = Shard(i)
    return placements


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """JAX's ``NamedSharding``: a spec on a mesh."""
    mesh: Any
    spec: P

    @property
    def placements(self) -> List:
        return to_placements(self.spec, self.mesh)


def distribute(tree: Any, shardings: Any, src_rank: int = 0) -> Any:
    """``jax.device_put(tree, shardings)``: each leaf of ``tree`` (a plain
    tensor, the same on every rank) as a DTensor laid out by the
    ``NamedSharding`` at the same place in ``shardings``, the data taken
    from rank ``src_rank``."""
    out = [distribute_tensor(t, sh.mesh, sh.placements, src_data_rank=src_rank)
           for t, sh in zip(tree_leaves(tree), tree_leaves(shardings))]
    return tree_unflatten(tree, out)


BATCH_AXES = ("pod", "data")

# Options (the JAX package's perf-pass switches). Baseline = all False.
OPT: Dict[str, bool] = {
    # decode KV layout: when kv_heads don't divide the model axis (GQA on
    # wide TP), shard the cache SEQUENCE axis over `model` instead of
    # replicating the whole cache 16x per chip.
    "kv_seq_shard": False,
    # ZeRO-1: shard optimizer moments over the data axis.
    "zero1": False,
    # donate decode caches (in-place update instead of copy-on-write).
    "donate_caches": False,
    # remat policy that saves matmul outputs (avoids recomputing the TP
    # collectives feeding them in the backward pass).
    "remat_dots": False,
    # expert-parallel MoE with an explicit all-to-all (models/moe_ep.py).
    "moe_ep": False,
}


def batch_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in BATCH_AXES if a in _names(mesh))


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------
# name -> spec for the *unstacked* layer shape; block leaves get a leading
# None for the stacked n_periods axis.
_PARAM_RULES: Dict[str, Tuple] = {
    # top level
    "embedding": ("model", None),
    "head": (None, "model"),
    "ln_f": (None,),
    # attention
    "wq": (None, "model"),
    "wk": (None, "model"),
    "wv": (None, "model"),
    "wk_cross": (None, "model"),
    "wv_cross": (None, "model"),
    "wo": ("model", None),
    "bq": ("model",),
    "bk": ("model",),
    "bv": ("model",),
    # mlp
    "w_gate": (None, "model"),       # moe variant handled by ndim below
    "w_up": (None, "model"),
    "w_down": ("model", None),
    "router": (None, None),
    # mamba
    "w_z": (None, "model"),
    "w_x": (None, "model"),
    "w_B": (None, None),
    "w_C": (None, None),
    "w_dt": (None, "model"),
    "conv_x_w": (None, "model"),
    "conv_x_b": ("model",),
    "conv_B_w": (None, None),
    "conv_B_b": (None,),
    "conv_C_w": (None, None),
    "conv_C_b": (None,),
    "dt_bias": ("model",),
    "A_log": ("model",),
    "D": ("model",),
    "norm": ("model",),
    "w_out": ("model", None),
    # norms
    "ln1": (None,),
    "ln2": (None,),
}

# MoE expert tensors: (E, d, f) / (E, f, d) -> expert parallel over model
_MOE_RULES: Dict[str, Tuple] = {
    "w_gate": ("model", None, None),
    "w_up": ("model", None, None),
    "w_down": ("model", None, None),
}


def _leaf_name(path) -> str:
    for p in reversed(path):
        if hasattr(p, "key"):
            return str(p.key)
    return ""


def param_pspec(path, leaf, mesh) -> P:
    name = _leaf_name(path)
    shape = tuple(leaf.shape)
    in_blocks = any(
        getattr(p, "key", None) == "blocks" for p in path
    )
    base_rank = len(shape) - (1 if in_blocks else 0)
    rules = _PARAM_RULES
    if name in _MOE_RULES and base_rank == 3:
        spec = _MOE_RULES[name]
    elif name in rules:
        spec = rules[name]
        if len(spec) != base_rank:
            spec = tuple(
                list(spec) + [None] * (base_rank - len(spec))
            )[:base_rank]
    else:
        spec = (None,) * base_rank
    if in_blocks:
        spec = (None,) + tuple(spec)
    return _guard(mesh, shape, spec)


def params_shardings(abstract_params: Any, mesh):
    return tree_map_with_path(
        lambda path, leaf: NamedSharding(mesh, param_pspec(path, leaf, mesh)),
        abstract_params,
    )


# ---------------------------------------------------------------------------
# Batches / activations
# ---------------------------------------------------------------------------
def data_pspec(shape: Tuple[int, ...], mesh) -> P:
    """Shard the leading (batch) axis over (pod, data) when divisible."""
    if not shape:
        return P()
    ba = batch_axes(mesh)
    spec = [ba if ba else None] + [None] * (len(shape) - 1)
    return _guard(mesh, shape, tuple(spec))


def batch_shardings(batch_tree: Any, mesh):
    return tree_map(
        lambda leaf: NamedSharding(mesh, data_pspec(tuple(leaf.shape), mesh)),
        batch_tree,
    )


# ---------------------------------------------------------------------------
# Decode caches
# ---------------------------------------------------------------------------
def cache_pspec(path, leaf, mesh) -> P:
    """Caches carry a leading n_periods axis.

    KV tensors (np, B, T, G, D): batch over (pod,data) if divisible, else
    sequence T over data (the long-context fallback); KV heads over model
    when divisible.
    SSM states   (np, B, h, p, n) / conv (np, B, w, ch): batch over
    (pod,data), heads/channels over model.
    """
    name = _leaf_name(path)
    shape = tuple(leaf.shape)
    ba = batch_axes(mesh)
    # leaves may or may not carry the leading n_periods axis (full stack vs
    # standalone super-block body)
    if name in ("k", "v") and len(shape) in (4, 5):
        stacked = len(shape) == 5
        B = shape[1] if stacked else shape[0]
        G = shape[3] if stacked else shape[2]
        lead = (None,) if stacked else ()
        heads_shardable = G % _axis_size(mesh, "model") == 0
        if OPT["kv_seq_shard"] and not heads_shardable:
            # GQA KV heads can't split the model axis: put the sequence
            # there instead of replicating the cache across it.
            if ba and B % _axis_size(mesh, ba) == 0:
                return _guard(mesh, shape, lead + (ba, "model", None, None))
            return _guard(
                mesh, shape, lead + (None, ("data", "model"), None, None)
            )
        if ba and B % _axis_size(mesh, ba) == 0:
            return _guard(mesh, shape, lead + (ba, None, "model", None))
        return _guard(mesh, shape, lead + (None, "data", "model", None))
    if name == "ssm" and len(shape) in (4, 5):
        lead = (None,) if len(shape) == 5 else ()
        return _guard(mesh, shape, lead + (ba, "model", None, None))
    if name.startswith("conv") and len(shape) in (3, 4):
        lead = (None,) if len(shape) == 4 else ()
        return _guard(mesh, shape, lead + (ba, None, "model"))
    # fallback: batch on axis 1 (stacked) / axis 0
    spec = [None] * len(shape)
    if len(shape) >= 2:
        spec[1] = ba
    return _guard(mesh, shape, tuple(spec))


def cache_shardings(cache_tree: Any, mesh):
    return tree_map_with_path(
        lambda path, leaf: NamedSharding(mesh, cache_pspec(path, leaf, mesh)),
        cache_tree,
    )


def replicated(mesh):
    return NamedSharding(mesh, P())


def zero1_shardings(tree: Any, mesh):
    """ZeRO-1 optimizer-moment layout: the parameter's own spec plus a
    ``data``-axis split on the first still-replicated divisible dimension
    (moments are only touched at the update, so the extra gather cost is
    one reduce-scatter/all-gather pair per step while memory drops ~16x)."""

    def spec(path, leaf):
        base = param_pspec(path, leaf, mesh)
        entries = list(base) + [None] * (len(leaf.shape) - len(base))
        dsz = _axis_size(mesh, "data")
        for i, (dim, e) in enumerate(zip(leaf.shape, entries)):
            if e is None and dim % dsz == 0 and dim >= dsz:
                entries[i] = "data"
                break
        return NamedSharding(mesh, P(*entries))

    return tree_map_with_path(spec, tree)
