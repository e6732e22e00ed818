"""Common neural-net building blocks on tensors, and the mesh context.

Sharding is expressed through ``shard(x, ...)`` constraints, as in the
JAX package: the identity when no mesh is active or on a plain tensor;
under ``use_mesh(mesh)`` (the port's ``with mesh:``) a DTensor is
redistributed to the placements of the spec, keeping only the axes the
mesh defines and only where the dimension divides their size
(``pspec``). ``shard_map`` runs a function on each rank's local shards,
JAX's ``shard_map``: the kernels and the ops that DTensor has no sharding
rule for (scatter, gather, top-k) run inside one.
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate
from torch.distributed.tensor.experimental import implicit_replication

from ..distributed.sharding import P, to_placements

Axis = Union[None, str, Tuple[str, ...]]

# Logical batch axes: sharded over pod+data when present.
BATCH: Tuple[str, ...] = ("pod", "data")
MODEL = "model"

# The meshes of the open ``use_mesh`` contexts, innermost last. Process-wide,
# not per thread: autograd runs a CUDA backward, and with it remat's
# recompute of the forward, on a device thread of its own, which has to see
# the mesh the forward ran under.
_MESHES: list = []


@contextlib.contextmanager
def use_mesh(mesh):
    """Run the model under ``mesh`` (a ``DeviceMesh`` named like the JAX
    package's meshes; None for none): ``shard`` constraints bind to its
    axes, and a plain tensor met by a DTensor op counts as replicated
    (positions, masks, token ids, the optimizer's scalars: the same on
    every rank). The context is process-wide, as JAX's ``with mesh:``."""
    outer = bool(_MESHES)
    _MESHES.append(mesh)
    try:
        with contextlib.nullcontext() if outer else implicit_replication():
            yield mesh
    finally:
        _MESHES.pop()


def _current_mesh():
    """The mesh of the innermost ``use_mesh``, else None."""
    return _MESHES[-1] if _MESHES else None


def active_mesh_axes() -> frozenset:
    m = _current_mesh()
    return frozenset(m.mesh_dim_names) if m is not None else frozenset()


def mesh_axis_sizes() -> dict:
    m = _current_mesh()
    return dict(zip(m.mesh_dim_names, m.shape)) if m is not None else {}


def pspec(*spec: Axis, dims: Optional[Sequence[int]] = None) -> P:
    """Build a partition spec keeping only axes the active mesh defines and
    (when ``dims`` is given) only where the dimension is divisible by the
    mesh-axis size — e.g. 56 attention heads cannot shard 16 ways, and 8 KV
    heads on a 16-way model axis stay replicated (Megatron GQA rule). An
    axis of size 1 shards nothing and is left out too, so on a one-rank
    mesh every layout is replicated and no collective runs."""
    sizes = mesh_axis_sizes()

    def filt(e: Axis, dim: Optional[int]):
        if e is None:
            return None
        if isinstance(e, str):
            e = (e,)
        t = tuple(a for a in e if sizes.get(a, 1) > 1)
        if not t:
            return None
        total = 1
        for a in t:
            total *= sizes[a]
        if dim is not None and dim % total != 0:
            return None
        return t if len(t) > 1 else t[0]

    if dims is None:
        dims = [None] * len(spec)
    return P(*[filt(e, d) for e, d in zip(spec, dims)])


def shard(x: torch.Tensor, *spec: Axis) -> torch.Tensor:
    """Apply a sharding constraint if a mesh is active; no-op otherwise
    (and on a plain tensor). Drops axes that don't divide the corresponding
    dimension."""
    mesh = _current_mesh()
    if mesh is None or not isinstance(x, DTensor):
        return x
    placements = to_placements(pspec(*spec, dims=x.shape), mesh)
    if tuple(x.placements) == tuple(placements):
        return x
    return x.redistribute(mesh, placements)


def lay_out(t: torch.Tensor, spec: P) -> DTensor:
    """``t`` as a DTensor of ``spec`` on the active mesh, its local block
    contiguous (an in-place kernel write and the kernels' checks need it).
    A plain ``t`` counts as the global value, the same on every rank."""
    mesh = _current_mesh()
    pl = to_placements(spec, mesh)
    if not isinstance(t, DTensor):
        t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)
    if tuple(t.placements) != tuple(pl):
        t = t.redistribute(mesh, pl)
    local = t.to_local()
    if not local.is_contiguous():
        t = DTensor.from_local(local.contiguous(), mesh, pl, run_check=False,
                               shape=t.shape, stride=t.stride())
    return t


def as_global(t: torch.Tensor, *spec: Axis) -> torch.Tensor:
    """Under a mesh, a plain tensor that every rank holds whole (token ids,
    embeddings from outside) as a DTensor laid out by ``spec``, each rank
    keeping its block; otherwise ``t`` as it is."""
    if _current_mesh() is None or isinstance(t, DTensor):
        return t
    return lay_out(t, pspec(*spec, dims=t.shape))


def split_last(x: torch.Tensor, n: int, d: int) -> torch.Tensor:
    """(..., n*d) -> (..., n, d). A DTensor sharded on the last dim over a
    mesh dim whose size does not divide ``n`` is gathered on that mesh dim
    first: DTensor cannot split a shard across heads."""
    if isinstance(x, DTensor):
        last = x.ndim - 1
        pl = [Replicate() if p.is_shard(last) and n % x.device_mesh.size(i) else p
              for i, p in enumerate(x.placements)]
        if pl != list(x.placements):
            x = x.redistribute(x.device_mesh, pl)
    return x.reshape(*x.shape[:-1], n, d)


def model_rank() -> int:
    """This rank's coordinate on the active mesh's ``model`` axis (0 with
    no mesh or no such axis)."""
    mesh = _current_mesh()
    if mesh is None or MODEL not in mesh.mesh_dim_names:
        return 0
    return mesh.get_local_rank(MODEL)


def axis_index(*axes: str) -> int:
    """This rank's block index over the active mesh's ``axes`` taken
    together, the first the major one (JAX's ``axis_index`` of a tuple of
    axes); 0 for no axes."""
    mesh = _current_mesh()
    idx = 0
    for a in axes:
        idx = idx * mesh.size(mesh.mesh_dim_names.index(a)) + mesh.get_local_rank(a)
    return idx


def all_gather(x: torch.Tensor, dim: int, *axes: str) -> torch.Tensor:
    """Inside ``shard_map``: the blocks of ``x`` along ``dim`` from every
    rank over the active mesh's ``axes``, in ``axis_index`` order (JAX's
    tiled ``all_gather``); ``x`` itself for no axes. Gathers over the minor
    axis first, whose blocks are neighbours."""
    mesh = _current_mesh()
    for a in reversed(axes):
        group = mesh.get_group(a)
        rows = x.movedim(dim, 0).contiguous()
        out = rows.new_empty((dist.get_world_size(group) * rows.shape[0],) + rows.shape[1:])
        dist.all_gather_into_tensor(out, rows, group=group)
        x = out.movedim(0, dim).contiguous()
    return x


class _ReplicatedSum(torch.autograd.Function):
    """JAX's ``psum`` whose result every rank then uses alike: the forward
    sums over the process groups; the backward passes the cotangent
    through, JAX's transpose of ``psum`` onto an invariant result."""

    @staticmethod
    def forward(ctx, x, groups):
        out = x.clone()
        for g in groups:
            dist.all_reduce(out, group=g)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def psum(x: torch.Tensor, *axes: str) -> torch.Tensor:
    """Inside ``shard_map``: ``x`` summed over the active mesh's ``axes``
    (a result that is the same on every rank along them)."""
    mesh = _current_mesh()
    return _ReplicatedSum.apply(x, [mesh.get_group(a) for a in axes])


class _VaryingSum(torch.autograd.Function):
    """JAX's ``psum`` whose result each rank then uses for its own block
    (a varying result): the forward sums the ranks' ``x`` over the process
    group in rank order (an all-gather, then a sum over the gathered axis,
    so every rank gets the same bits whatever the backend); the backward
    sums the ranks' cotangents the same way, since each rank's ``x``
    reaches every rank's result."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _rank_order_sum(x, axis)

    @staticmethod
    def backward(ctx, grad):
        return _rank_order_sum(grad, ctx.axis), None


def _rank_order_sum(x: torch.Tensor, axis: str) -> torch.Tensor:
    return all_gather(x.unsqueeze(0), 0, axis).sum(dim=0)


def psum_varying(x: torch.Tensor, axis: str) -> torch.Tensor:
    """Inside ``shard_map``: ``x`` summed over the active mesh's ``axis``
    in rank order, for a result that each rank then combines with its own
    block (the rms of channels split over ``model``); ``x`` itself with no
    mesh or where the axis has one rank."""
    if mesh_axis_sizes().get(axis, 1) == 1:
        return x
    return _VaryingSum.apply(x, axis)


def pmean(x: torch.Tensor, *axes: str) -> torch.Tensor:
    """Inside ``shard_map``: the mean of ``x`` over the active mesh's
    ``axes``."""
    sizes = mesh_axis_sizes()
    return psum(x, *axes) / math.prod(sizes[a] for a in axes)


def shard_map(fn: Callable, in_specs: Sequence, out_specs, *args):
    """JAX's ``shard_map``: ``fn`` on each rank's local blocks of ``args``.

    With no active mesh, or no DTensor among ``args``, it is ``fn(*args)``.
    Otherwise each tensor argument with a spec is laid out by it (a plain
    tensor counts as replicated, the same on every rank, and is cut
    locally) and handed to ``fn`` as its local block; an argument whose
    spec is None goes in as it is. The outputs (a tensor or a tuple, each
    with its spec in ``out_specs``; None leaves one as it is) become
    DTensors of those specs. In the backward pass the gradient of an input
    replicated over a mesh axis that another input is sharded over is a
    sum over that axis (``Partial``): the ranks along it computed on
    different blocks."""
    mesh = _current_mesh()
    if mesh is None or not any(isinstance(a, DTensor) for a in args):
        return fn(*args)
    in_pl = [to_placements(s, mesh) if s is not None else None for s in in_specs]
    split = {i for pl in in_pl if pl is not None
             for i, p in enumerate(pl) if p.is_shard()}
    local = []
    for a, pl in zip(args, in_pl):
        if pl is None or not isinstance(a, torch.Tensor):
            local.append(a)
            continue
        if not isinstance(a, DTensor):
            a = DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim, run_check=False)
        if tuple(a.placements) != tuple(pl):
            a = a.redistribute(mesh, pl)
        grad_pl = [Partial() if i in split and p == Replicate() else p
                   for i, p in enumerate(pl)]
        local.append(a.to_local(grad_placements=grad_pl))
    out = fn(*local)
    single = not isinstance(out, tuple)
    outs, specs = ((out,), (out_specs,)) if single else (out, out_specs)
    wrapped = tuple(
        DTensor.from_local(o, mesh, to_placements(s, mesh), run_check=False)
        if s is not None and isinstance(o, torch.Tensor) else o
        for o, s in zip(outs, specs))
    return wrapped[0] if single else wrapped


# ---------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def rope(
    x: torch.Tensor, positions: torch.Tensor, theta: float = 10_000.0
) -> torch.Tensor:
    """Rotary position embedding, half-split, in fp32 before the cast.
    x: (..., S, H, D); positions: (..., S)."""
    d = x.shape[-1]
    half = d // 2
    freqs = 1.0 / (
        theta ** (torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    )
    angles = positions[..., :, None].float() * freqs     # (..., S, half)
    cos = torch.cos(angles)[..., :, None, :]              # broadcast over heads
    sin = torch.sin(angles)[..., :, None, :]
    x32 = x.float()
    x1, x2 = x32[..., :half], x32[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def mlp_forward(params: dict, x: torch.Tensor, kind: str = "swiglu") -> torch.Tensor:
    """Gated MLP: SwiGLU (llama-family) or GeGLU (gemma; tanh-approximate
    GELU, jax.nn.gelu's default)."""
    h_gate = x @ params["w_gate"]
    h_up = x @ params["w_up"]
    act = F.gelu(h_gate, approximate="tanh") if kind == "geglu" else F.silu(h_gate)
    h = shard(act * h_up, BATCH, None, MODEL)
    return h @ params["w_down"]


def embed(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    """The rows of the (V, d) table. Under a mesh with the vocabulary over
    ``model``, each rank looks up the tokens in its own rows (zeros for
    the others) and the ranks' lookups are summed."""
    w = params["embedding"]
    rows = pspec(MODEL, None, dims=w.shape)

    def lookup(t, wl):
        if rows[0] is None:
            return wl[t]
        idx = t - model_rank() * wl.shape[0]
        hit = (idx >= 0) & (idx < wl.shape[0])
        part = wl[idx.clamp(0, wl.shape[0] - 1)] * hit[..., None].to(wl.dtype)
        return psum(part, MODEL)

    tok = pspec(BATCH, None, dims=tokens.shape)
    out = pspec(BATCH, None, None, dims=tuple(tokens.shape) + (w.shape[1],))
    return shard_map(lookup, (tok, rows), out, tokens, w)


def unembed(params: dict, x: torch.Tensor) -> torch.Tensor:
    """A separate head is (d, V); the tied embedding is (V, d)."""
    w = params.get("head", params["embedding"])
    if w.shape[0] != x.shape[-1]:
        return x @ w.t()
    return x @ w


def cross_entropy_loss(
    logits: torch.Tensor, labels: torch.Tensor, mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Mean next-token negative log-likelihood in fp32 (logsumexp minus
    the gold logit), over the positions where ``mask`` is set when given;
    under a mesh the mean over every rank's tokens."""
    def token_nll(lg, lb):
        lg = lg.float()
        logz = torch.logsumexp(lg, dim=-1)
        gold = torch.gather(lg, -1, lb[..., None].long())[..., 0]
        return logz - gold

    # under a mesh: each rank's tokens over the whole vocabulary
    tok = pspec(BATCH, None, dims=labels.shape)
    nll = shard_map(token_nll, (pspec(BATCH, None, None, dims=logits.shape), tok), tok,
                    logits, labels)
    if mask is not None:
        mask = mask.float()
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)
