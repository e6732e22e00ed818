"""Multi-pod dry-run: run every (architecture x input shape) step on the
meta device over a fake 256- or 512-rank world on the production meshes,
and count per device what one step does.

Nothing is allocated and no card is needed: the parameters, optimizer
state, batch and caches are empty meta tensors, each put in place as a
DTensor by the sharding rules (``params_shardings``, ``batch_shardings``,
``cache_shardings``, ``zero1_shardings`` under ``--opt zero1``) with
``DTensor.from_local`` on its rank's local shard. The step runs under
``use_mesh`` as it would on the ranks, the kernel ops taking their meta
route (the plain version, shapes only). The world is PyTorch's fake
process group (``torch.testing._internal.distributed.fake_pg``), started
inside ``dryrun_one`` only when no process group exists; importing this
module starts nothing.

What ``StepRecorder`` counts, per device (rank 0's view of the program
every rank runs):

  * FLOPs: ``torch.utils.flop_counter``'s formulas on each local op (the
    products; elementwise ops count 0, where XLA's cost analysis counts
    them).
  * bytes: each local op's operand and result bytes, views excluded: an
    eager step's traffic, op by op. It is not XLA's ``bytes accessed`` of
    a fused program.
  * collectives: kind, local operand and result bytes and group size of
    each collective a rank calls, read off the ``_c10d_functional`` ops
    (DTensor's redistributions) and the ``c10d`` ops (``models.layers.psum``,
    ``moe_ep``'s all-to-all); ``roofline.collective_stats`` reduces them.

A DTensor op is not counted at its global shape: the recorder lets DTensor
run it and counts the local ops and collectives it becomes, so an op whose
output is ``Shard`` or ``Partial`` over a mesh dimension counts 1/size of
the global work there and a ``Replicate`` one all of it, and
redistributions DTensor makes inside an op are seen too. The global-shape
ops that DTensor's sharding propagation runs on fake tensors are skipped.

``memory_analysis`` holds ``argument_size_in_bytes`` (the local shards of
the step's inputs; a decode step's ``cache_len`` as the JAX package's
4-byte scalar) and ``output_size_in_bytes`` (the local shards of its
outputs). There is no temporary-memory count: eager execution on meta
tensors frees nothing that could be measured, so the key is absent.

The JAX package scans the periods and corrects XLA's count of the loop
body; the port's ``run_blocks`` runs every period in a Python loop, so each
is counted directly.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch tinyllama-1.1b \
      --shape decode_32k [--multi-pod | --both-meshes] [--all] [--out r.jsonl]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time
import traceback
from typing import Any, Dict, List

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as _flat
from torch.utils.flop_counter import flop_registry

from ..configs import ARCHS, INPUT_SHAPES, get_config
from ..distributed.sharding import (
    OPT,
    NamedSharding,
    batch_shardings,
    cache_shardings,
    data_pspec,
    params_shardings,
    replicated,
    zero1_shardings,
)
from ..models import use_mesh
from ..models.layers import lay_out
from ..models.init import abstract_params
from ..tree import tree_leaves, tree_map
from ..training.optimizer import AdamWState, init_adamw
from .mesh import make_production_mesh
from .roofline import (
    CollectiveRecord,
    collective_stats,
    model_flops_estimate,
    roofline_terms,
)
from .specs import input_specs, make_step


def _nbytes(x) -> int:
    return sum(t.numel() * t.element_size()
               for t in _flat(x) if isinstance(t, torch.Tensor))


def _named_group(name: str) -> int:
    return dist.distributed_c10d._resolve_process_group(name).size()


def _boxed_group(obj) -> int:
    return dist.ProcessGroup.unbox(obj).size()


# op -> (kind, (args, out) -> (operand, result, group size))
_COLLECTIVES = {
    "_c10d_functional.all_gather_into_tensor":
        ("all-gather", lambda a, o: (a[0], o, a[1])),
    "_c10d_functional.all_reduce":
        ("all-reduce", lambda a, o: (a[0], o, _named_group(a[2]))),
    "_c10d_functional.reduce_scatter_tensor":
        ("reduce-scatter", lambda a, o: (a[0], o, a[2])),
    "_c10d_functional.all_to_all_single":
        ("all-to-all", lambda a, o: (a[0], o, _named_group(a[3]))),
    "c10d.allreduce_": ("all-reduce", lambda a, o: (a[0], a[0], _boxed_group(a[1]))),
    "c10d._allgather_base_": ("all-gather", lambda a, o: (a[1], a[0], _boxed_group(a[2]))),
    "c10d._reduce_scatter_base_":
        ("reduce-scatter", lambda a, o: (a[1], a[0], _boxed_group(a[2]))),
    "c10d.alltoall_base_": ("all-to-all", lambda a, o: (a[1], a[0], _boxed_group(a[2]))),
}
# functional-collective bookkeeping that moves nothing
_NOT_COUNTED = {"_c10d_functional.wait_tensor", "_c10d_functional._wrap_tensor_autograd"}


class StepRecorder(TorchDispatchMode):
    """Per-device FLOPs, bytes and collectives of the ops run under it (the
    module docstring says what each counts)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.collectives: List[CollectiveRecord] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented        # DTensor runs it; its local ops come back here
        out = func(*args, **kwargs)
        if any(isinstance(t, FakeTensor) for t in _flat((args, kwargs, out))):
            return out                   # sharding propagation at the global shape
        name = str(func).rsplit(".", 1)[0]
        if name in _COLLECTIVES:
            kind, read = _COLLECTIVES[name]
            operand, result, group = read(args, out)
            self.collectives.append(
                CollectiveRecord(kind, _nbytes(operand), _nbytes(result), int(group)))
        elif func.namespace in ("c10d", "_c10d_functional"):
            if name not in _NOT_COUNTED:
                raise NotImplementedError(f"the dry-run does not count {func}")
        elif not func.is_view:
            count = flop_registry.get(func._overloadpacket)
            if count is not None:
                self.flops += count(*args, **kwargs, out_val=out)
            self.bytes += _nbytes((args, kwargs)) + _nbytes(out)
        return out


def _placed(leaf: torch.Tensor, sharding: NamedSharding) -> DTensor:
    """``leaf``'s local shard under ``sharding``, an empty meta tensor, as a
    DTensor of ``leaf``'s global shape."""
    mesh, placements = sharding.mesh, sharding.placements
    local = list(leaf.shape)
    for i, p in enumerate(placements):
        if p.is_shard():
            local[p.dim] //= mesh.size(i)
    return DTensor.from_local(torch.empty(local, dtype=leaf.dtype, device="meta"),
                              mesh, placements, run_check=False,
                              shape=leaf.shape, stride=leaf.stride())


def _place(tree: Any, shardings: Any) -> Any:
    it = iter(tree_leaves(shardings))
    return tree_map(lambda leaf: _placed(leaf, next(it)), tree)


def _local_bytes(tree: Any) -> int:
    return sum(t.to_local().numel() * t.element_size() if isinstance(t, DTensor)
               else t.numel() * t.element_size()
               for t in tree_leaves(tree) if isinstance(t, torch.Tensor))


@contextlib.contextmanager
def fake_world(n_ranks: int):
    """A fake process group of ``n_ranks`` for the block, unless a group
    exists already (``make_production_mesh`` then checks its size)."""
    if dist.is_initialized():
        yield
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n_ranks)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _inputs(cfg, shape, kind, specs, mesh):
    """(call arguments, the same with ``cache_len`` as the spec's scalar)
    of the step, each leaf placed on ``mesh``."""
    params = abstract_params(cfg)
    placed = _place(params, params_shardings(params, mesh))
    if kind == "train":
        opt = init_adamw(params)
        shard_fn = zero1_shardings if OPT["zero1"] else params_shardings
        moments = {"mu": opt.mu, "nu": opt.nu}
        moments = _place(moments, shard_fn(moments, mesh))
        opt = AdamWState(step=_placed(opt.step, replicated(mesh)), **moments)
        args = [placed, opt, _place(specs["batch"], batch_shardings(specs["batch"], mesh))]
        return args, args
    if kind == "prefill":
        args = [placed] + [_place(specs[k], batch_shardings(specs[k], mesh))
                           for k in ("tokens", "frontend", "inputs_embeds") if k in specs]
        return args, args
    args = [placed, _place(specs["token"], batch_shardings(specs["token"], mesh)),
            _place(specs["caches"], cache_shardings(specs["caches"], mesh)),
            _placed(specs["cache_len"], replicated(mesh))]
    if "frontend" in specs:
        args.append(_place(specs["frontend"], batch_shardings(specs["frontend"], mesh)))
    # the cache full but for the new token; the port reads cache_len on the host
    call = args[:3] + [shape.seq_len - 1] + args[4:]
    return call, args


def dryrun_one(
    arch: str,
    shape_name: str,
    multi_pod: bool = False,
    verbose: bool = True,
) -> Dict[str, Any]:
    """Run one combo's step on the meta device over the production mesh
    (a fake world of 256 or 512 ranks unless one exists) and return the
    JAX package's result fields from the port's own counts."""
    cfg = get_config(arch, shape=shape_name)
    repl = dict(remat_policy="dots" if OPT["remat_dots"] else "full", moe_ep=OPT["moe_ep"])
    if OPT.get("ssm_chunk"):
        repl["ssm_chunk"] = int(OPT["ssm_chunk"])
    cfg = dataclasses.replace(cfg, **repl)
    shape = INPUT_SHAPES[shape_name]
    step_fn, kind = make_step(cfg, shape)
    specs = input_specs(cfg, shape)
    with fake_world(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        n_chips = mesh.size()
        t0 = time.monotonic()
        call, args = _inputs(cfg, shape, kind, specs, mesh)
        t_place = time.monotonic() - t0
        rec = StepRecorder()
        with use_mesh(mesh), rec:
            out = step_fn(*call)
            if kind == "decode":     # JAX's out_shardings: logits over the batch axes
                out = (lay_out(out[0], data_pspec(tuple(out[0].shape), mesh)),) + out[1:]
        t_run = time.monotonic() - t0 - t_place
        mem_fields = {"argument_size_in_bytes": _local_bytes(args),
                      "output_size_in_bytes": _local_bytes(out)}

    flops, hbm_bytes = float(rec.flops), float(rec.bytes)
    coll = collective_stats(rec.collectives)
    mf = model_flops_estimate(cfg, shape)
    rf = roofline_terms(flops, hbm_bytes, coll, model_flops=mf, n_chips=n_chips)
    result = {
        "arch": arch,
        "shape": shape_name,
        "kind": kind,
        "opt": ",".join(sorted(k for k, v in OPT.items() if v)),
        "mesh": "2x16x16" if multi_pod else "16x16",
        "n_chips": n_chips,
        "ok": True,
        "lower_s": round(t_place, 2),     # placing the inputs
        "compile_s": round(t_run, 2),     # running the step on meta (no compile)
        "flops_per_device": flops,
        "hbm_bytes_per_device": hbm_bytes,
        "collective_bytes_per_device": coll.total_bytes,
        "collective_counts": coll.count_by_kind,
        "compute_s": rf.compute_s,
        "memory_s": rf.memory_s,
        "collective_s": rf.collective_s,
        "dominant": rf.dominant,
        "model_flops": mf,
        "flops_ratio": rf.flops_ratio,
        "memory_analysis": mem_fields,
    }
    if verbose:
        print(
            f"[{result['mesh']}] {arch} x {shape_name} ({kind}): "
            f"run {t_run:.1f}s  "
            f"flops/dev {flops:.3g}  bytes/dev {hbm_bytes:.3g}B  "
            f"coll/dev {coll.total_bytes:.3g}B  dominant={rf.dominant}  "
            f"useful-flops-ratio {rf.flops_ratio:.2f}"
        )
        print(f"  memory_analysis: {mem_fields}")
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="all 10 archs x 4 shapes")
    ap.add_argument("--out", default=None, help="append JSONL here")
    ap.add_argument("--opt", default="",
                    help="comma-separated perf options (kv_seq_shard, "
                         "zero1, donate_caches, remat_dots, moe_ep)")
    ap.add_argument("--ssm-chunk", type=int, default=0,
                    help="override cfg.ssm_chunk")
    args = ap.parse_args(argv)

    for o in filter(None, args.opt.split(",")):
        if o not in OPT:
            ap.error(f"unknown opt {o}")
        OPT[o] = True
    if args.ssm_chunk:
        OPT["ssm_chunk"] = args.ssm_chunk

    archs = list(ARCHS) if (args.all or args.arch is None) else [args.arch]
    shapes = (
        list(INPUT_SHAPES) if (args.all or args.shape is None)
        else [args.shape]
    )
    meshes = [args.multi_pod] if not args.both_meshes else [False, True]
    combos = [(a, s, mp) for a in archs for s in shapes for mp in meshes]

    results = []
    failures = 0
    for a, s, mp in combos:
        try:
            r = dryrun_one(a, s, multi_pod=mp)
        except Exception as e:
            failures += 1
            r = {
                "arch": a, "shape": s,
                "mesh": "2x16x16" if mp else "16x16",
                "ok": False, "error": f"{type(e).__name__}: {e}",
            }
            print(f"FAIL {a} x {s} ({r['mesh']}): {r['error']}")
            traceback.print_exc()
        results.append(r)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(r) + "\n")
    print(f"\n{len(results) - failures}/{len(results)} combos ran OK")
    if failures:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
