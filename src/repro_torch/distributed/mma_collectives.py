"""MMA on the cluster fabric: multipath weight distribution and KV fetch
as resharding programs over a ``DeviceMesh``.

The paper's relay insight — land chunks on every host's local links in
parallel, then forward over the accelerator interconnect — is a reshard:
weights enter host-chunked (``staging_shardings``: every rank's host link
carries 1/N of the payload onto its card, ``stage_from_host``) and the
collectives that DTensor's ``redistribute`` issues over NCCL/NVLink
(all-gathers, here) assemble the serving layout (``make_wakeup_step``).
``make_kv_fetch_step`` does the same for decode caches. The JAX package
expresses both as jitted identity functions with in/out shardings
(``src/repro/distributed/mma_collectives.py``); here the program is the
redistribution itself.
"""
from __future__ import annotations

import math
from typing import Any

import torch
from torch.distributed.tensor import DTensor

from ..tree import tree_leaves, tree_map, tree_unflatten
from .sharding import NamedSharding, P, cache_shardings, params_shardings


def staging_shardings(abstract_params: Any, mesh):
    """Ingest layout: every parameter chunked over ALL mesh axes on its
    largest dimension — each rank's host link lands an equal slice
    (the multipath ingest), regardless of the serving layout. A leaf none
    of whose dimensions the rank count divides is replicated: every rank
    lands it whole (as the JAX package does)."""
    axes = tuple(mesh.mesh_dim_names)

    def spec(leaf):
        shape = tuple(leaf.shape)
        if not shape:
            return NamedSharding(mesh, P())
        total = mesh.size()
        # chunk the largest divisible dim over all axes
        order = sorted(range(len(shape)), key=lambda i: -shape[i])
        for i in order:
            if shape[i] % total == 0:
                s = [None] * len(shape)
                s[i] = axes
                return NamedSharding(mesh, P(*s))
        # fall back: replicate (tiny tensors below rank count)
        return NamedSharding(mesh, P())

    return tree_map(spec, abstract_params)


def _reshard(tree: Any, shardings: Any) -> Any:
    out = [t.redistribute(sh.mesh, sh.placements)
           for t, sh in zip(tree_leaves(tree), tree_leaves(shardings))]
    return tree_unflatten(tree, out)


def make_wakeup_step(cfg, mesh):
    """The resharding program: host-chunked staging -> serving layout.

    Returns (fn, staging_shardings, serving_shardings): ``fn(params)``
    takes the parameters as DTensors in the staging layout (e.g. from
    ``stage_from_host``) and returns them in ``params_shardings``'s.
    """
    from ..models.init import abstract_params

    aparams = abstract_params(cfg)
    stage_sh = staging_shardings(aparams, mesh)
    serve_sh = params_shardings(aparams, mesh)

    def wakeup(params):
        return _reshard(params, serve_sh)

    return wakeup, stage_sh, serve_sh


def make_kv_fetch_step(cfg, mesh, batch: int, seq: int, window: int = 0):
    """Host-pool KV pages enter chunked over all ranks; the program
    reshards them into the decode cache layout. Returns (fn, caches,
    staging_shardings, serving_shardings); ``caches`` is the cache tree on
    the meta device (shapes and dtypes only)."""
    from ..models.layers import use_mesh
    from ..models.transformer import init_caches

    with use_mesh(None):
        caches = init_caches(cfg, batch, seq, window, device="meta")
    stage_sh = staging_shardings(caches, mesh)
    serve_sh = cache_shardings(caches, mesh)

    def fetch(caches):
        return _reshard(caches, serve_sh)

    return fetch, caches, stage_sh, serve_sh


def _local_block(t: torch.Tensor, sh: NamedSharding) -> torch.Tensor:
    """This rank's block of ``t`` under ``sh``: along each dimension whose
    spec entry names mesh axes, block number sum(coord_a * size of the
    axes after a) of (the product of their sizes), major to minor."""
    names = tuple(sh.mesh.mesh_dim_names)
    coord = dict(zip(names, sh.mesh.get_coordinate()))
    size = dict(zip(names, sh.mesh.shape))
    for dim, entry in enumerate(sh.spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else entry
        n = math.prod(size[a] for a in axes)
        idx = 0
        for a in axes:
            idx = idx * size[a] + coord[a]
        step = t.shape[dim] // n
        t = t.narrow(dim, idx * step, step)
    return t


def stage_from_host(host_tree: Any, stage_sh: Any, engine) -> Any:
    """The multipath ingest: each rank lands only its own staging block of
    every leaf, from host memory (pinned on the way when it is not) onto
    its card through ``multipath_device_put`` over ``engine`` (whose
    target 0 is this rank's device; K1 reassembles the chunks), and wraps
    it as a DTensor of the staging layout. ``host_tree`` holds CPU tensors,
    the same on every rank."""
    from ..core import multipath_device_put

    out = []
    for t, sh in zip(tree_leaves(host_tree), tree_leaves(stage_sh)):
        local = multipath_device_put(_local_block(t, sh), target=0, engine=engine)
        out.append(DTensor.from_local(local, sh.mesh, sh.placements, run_check=False))
    return tree_unflatten(host_tree, out)
