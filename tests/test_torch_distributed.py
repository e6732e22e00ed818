"""The port's distribution layer (repro_torch.distributed, models/moe_ep.py,
launch/mesh.py and the model under a device mesh) against the JAX
package's, on the CPU.

* The sharding rules, in process: ``param_pspec`` for every leaf of every
  catalog config, ``cache_pspec`` (``kv_seq_shard`` off and on) and
  ``data_pspec``, on the production mesh shapes (16, 16) and (2, 16, 16),
  equal to JAX's entry for entry. Neither side needs ranks: both read only
  the axis names and sizes (JAX's through the ``FakeMesh`` object of
  tests/test_distributed.py, the port's through one with a
  ``DeviceMesh``'s ``mesh_dim_names`` and ``shape``). The meshes
  themselves are built over a fake process group of 256 and 512 ranks in a
  subprocess.
* Everything that moves data, in two subprocesses on the same numpy
  inputs (seed 0): the JAX package on an 8-device CPU mesh (2, 4) with
  Auto axes (under jax 0.9 the default Explicit axes make
  ``with_sharding_constraint`` raise), and the port on 8 ``gloo`` ranks
  with JAX and ``repro`` blocked. The JAX side writes its inputs, weights
  and results to an npz that the port side reads (the weights through the
  leaf order both packages share).

Tolerances: 1e-5 relative to the largest magnitude for ``moe_ffn_ep`` in
fp32 (outputs, aux loss, gradients; another summation order); 2e-4 for
logits after a whole model (the port's fp32 logits tolerance); a train
step's loss within 1e-5 relative and its updated parameters within 1e-4
of each leaf's largest magnitude; reshards bit-exact.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.distributed.sharding as jsharding
from repro.configs import ARCHS, PAPER_MODELS
from repro.configs import get_config as jax_config
from repro.models.init import abstract_params as jax_abstract_params
from repro.models.transformer import init_caches as jax_init_caches
import repro_torch.distributed.sharding as tsharding
from repro_torch.configs import get_config
from repro_torch.models import abstract_params
from repro_torch.models.transformer import init_caches
from repro_torch.tree import tree_leaves_with_path

ROOT = Path(__file__).resolve().parents[1]
CATALOG = sorted({**ARCHS, **PAPER_MODELS})
MESHES = {"pod": ((16, 16), ("data", "model")),
          "multi_pod": ((2, 16, 16), ("pod", "data", "model"))}


class JaxFakeMesh:
    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = type("D", (), {"shape": shape})()


class TorchFakeMesh:
    def __init__(self, shape, names):
        self.mesh_dim_names = names
        self.shape = shape


def _key(path) -> str:
    """A leaf's path as one string, the same for both packages' trees."""
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)


def _jax_specs(tree, rule, mesh):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {_key(p): tuple(rule(p, leaf, mesh)) for p, leaf in flat}


def _torch_specs(tree, rule, mesh):
    return {_key(p): tuple(rule(p, leaf, mesh)) for p, leaf in tree_leaves_with_path(tree)}


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("name", CATALOG)
def test_param_pspec_equals_jax(name, mesh):
    shape, names = MESHES[mesh]
    want = _jax_specs(jax_abstract_params(jax_config(name)), jsharding.param_pspec,
                      JaxFakeMesh(shape, names))
    got = _torch_specs(abstract_params(get_config(name)), tsharding.param_pspec,
                       TorchFakeMesh(shape, names))
    assert got == want
    if name == "yi-34b":         # 56 heads: the flat H*D = 7168 projection shards
        assert got["blocks/0/wq"] == (None, None, "model")
        assert got["embedding"] == ("model", None)
    if name == "mamba2-370m":    # 50280 % 16 != 0: the embedding stays replicated
        assert got["embedding"] == (None, None)


@pytest.mark.parametrize("kv_seq_shard", [False, True])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("name", CATALOG)
def test_cache_pspec_equals_jax(name, mesh, kv_seq_shard):
    """Caches of a batch that the data axes divide (32) and of one that
    they don't (1: the sequence goes over ``data``), both packages' option
    set alike."""
    shape, names = MESHES[mesh]
    saved = (jsharding.OPT["kv_seq_shard"], tsharding.OPT["kv_seq_shard"])
    jsharding.OPT["kv_seq_shard"] = tsharding.OPT["kv_seq_shard"] = kv_seq_shard
    try:
        for B, T in ((32, 1024), (1, 4096)):
            jc = jax.eval_shape(lambda: jax_init_caches(jax_config(name), B, T))
            want = _jax_specs(jc, jsharding.cache_pspec, JaxFakeMesh(shape, names))
            tc = init_caches(get_config(name), B, T, device="meta")
            got = _torch_specs(tc, tsharding.cache_pspec, TorchFakeMesh(shape, names))
            assert got == want, (B, T)
    finally:
        jsharding.OPT["kv_seq_shard"], tsharding.OPT["kv_seq_shard"] = saved


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("B", [32, 1])
def test_sequence_sharded_kv_cache_spec_is_cache_pspec(B, mesh):
    """With kv_seq_shard on and KV heads that do not divide the model axis
    (TinyLlama's 4 on 16), the layout the attention layers keep a cache in
    (``kv_cache_spec``) is the one ``cache_pspec`` gives it: the positions
    over ``model`` (the batch over the batch axes), or over ("data",
    "model") where the batch axes do not divide B, so no layer reshards
    the cache it is handed."""
    from repro_torch.models.attention import kv_cache_spec
    from repro_torch.models.layers import use_mesh

    fake = TorchFakeMesh(*MESHES[mesh])
    saved = tsharding.OPT["kv_seq_shard"]
    tsharding.OPT["kv_seq_shard"] = True
    try:
        caches = init_caches(get_config("tinyllama-1.1b"), B, 4096, device="meta")
        want = _torch_specs(caches, tsharding.cache_pspec, fake)
        with use_mesh(fake):
            got = {_key(p): tuple(kv_cache_spec(leaf.shape))
                   for p, leaf in tree_leaves_with_path(caches)}
    finally:
        tsharding.OPT["kv_seq_shard"] = saved
    assert got == want
    assert {v[2] for v in got.values()} == {"model" if B == 32 else ("data", "model")}


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("B", [32, 1])
@pytest.mark.parametrize("name", ["mamba2-370m", "jamba-1.5-large-398b"])
def test_model_cache_layout_is_cache_pspec(name, B, mesh):
    """The layout the model keeps every cache leaf in (``_cache_spec``:
    KV, the SSM state by heads and the conv tails by channels over
    ``model``) is the one ``cache_pspec`` gives it, so caches laid out by
    ``cache_shardings`` pass through ``run_blocks`` as they are. Not the KV
    leaves at a batch the data axes do not divide (B = 1): there
    ``cache_pspec`` puts the positions over ``data``, while the attention
    layers keep JAX's ``shard_kv_cache`` layout (heads only), as JAX's own
    model does."""
    from repro_torch.models.layers import use_mesh
    from repro_torch.models.transformer import _cache_spec

    fake = TorchFakeMesh(*MESHES[mesh])
    caches = init_caches(get_config(name), B, 4096, device="meta")
    want = _torch_specs(caches, tsharding.cache_pspec, fake)
    with use_mesh(fake):
        got = {_key(p): tuple(_cache_spec(str(p[-1].key), leaf.shape, stacked=True))
               for p, leaf in tree_leaves_with_path(caches)}
    if B == 1:
        want = {k: v for k, v in want.items() if not k.endswith(("/k", "/v"))}
        got = {k: v for k, v in got.items() if k in want}
    assert got == want
    ssm = [v for k, v in got.items() if k.endswith("/ssm")]
    assert ssm and all(v[2] == "model" for v in ssm)       # heads over model


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_data_pspec_equals_jax(mesh):
    shape, names = MESHES[mesh]
    for s in [(), (32,), (32, 4096), (1, 4096), (64, 8, 3), (48, 2)]:
        assert tuple(tsharding.data_pspec(s, TorchFakeMesh(shape, names))) == tuple(
            jsharding.data_pspec(s, JaxFakeMesh(shape, names))), s


def test_placements_keep_jax_block_order_and_refuse_what_dtensor_cannot_say():
    from torch.distributed.tensor import Replicate, Shard

    mesh = TorchFakeMesh((2, 4), ("data", "model"))
    P = tsharding.P
    assert P(("data",), None) == ("data", None)        # JAX's normalisation
    assert tsharding.to_placements(P(("data", "model")), mesh) == [Shard(0), Shard(0)]
    assert tsharding.to_placements(P(None, "model"), mesh) == [Replicate(), Shard(1)]
    assert tsharding.to_placements(P(), mesh) == [Replicate(), Replicate()]
    # JAX takes a minor-to-major tuple; DTensor cannot lay it out
    for bad in (P(("model", "data")), P("model", "model"), P("pod")):
        with pytest.raises(ValueError):
            tsharding.to_placements(bad, mesh)


def test_the_mesh_context_reaches_other_threads():
    """A CUDA backward, and remat's recompute in it, runs on autograd's
    device thread: it must see the mesh the forward ran under (a
    thread-local context let the recompute hand DTensors to K3 on the
    card)."""
    import threading

    from repro_torch.models.layers import _current_mesh, use_mesh

    mesh = TorchFakeMesh((2, 4), ("data", "model"))
    seen = []
    with use_mesh(mesh):
        t = threading.Thread(target=lambda: seen.append(_current_mesh()))
        t.start()
        t.join(timeout=10)
    assert not t.is_alive() and seen == [mesh]
    assert _current_mesh() is None


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env["JAX_PLATFORMS"] = "cpu"
    env.update(extra)
    return env


PRODUCTION_MESH = r"""
import sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.configs import get_config
from repro_torch.distributed import param_pspec
from repro_torch.launch import make_production_mesh
from repro_torch.models import abstract_params
from repro_torch.tree import tree_leaves_with_path

for world, multi in ((256, False), (512, True)):
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    mesh = make_production_mesh(multi_pod=multi, device="cpu")
    specs = {str(p): tuple(param_pspec(p, l, mesh))
             for p, l in tree_leaves_with_path(abstract_params(get_config("yi-34b")))}
    print("MESH", world, tuple(mesh.shape), tuple(mesh.mesh_dim_names),
          specs["(DictKey(key='blocks'), SequenceKey(idx=0), DictKey(key='wq'))"])
    dist.destroy_process_group()
"""


def test_production_meshes_over_a_fake_process_group():
    out = subprocess.run([sys.executable, "-c", PRODUCTION_MESH], env=_env(),
                         capture_output=True, text=True, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [l for l in out.stdout.splitlines() if l.startswith("MESH")]
    assert lines == [
        "MESH 256 (16, 16) ('data', 'model') (None, None, 'model')",
        "MESH 512 (2, 16, 16) ('pod', 'data', 'model') (None, None, 'model')",
    ]


# ---------------------------------------------------------------------------
# JAX on 8 CPU devices, the port on 8 gloo ranks
# ---------------------------------------------------------------------------
JAX_SIDE = r'''
import dataclasses, json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
from repro.configs import get_config
from repro.distributed.sharding import batch_shardings, cache_shardings, params_shardings
from repro.models import decode_step, init_params, prefill
from repro.models.moe import moe_ffn
from repro.models.moe_ep import moe_ffn_ep
from repro.training import AdamWConfig, TrainConfig, init_adamw, make_train_step

out = {}
mesh = jax.make_mesh((2, 4), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
# each mesh position's box of an (8, 8, 4) array
boxes = {}
x = jnp.arange(8 * 8 * 4, dtype=jnp.float32).reshape(8, 8, 4)
for spec in SPECS:
    a = jax.device_put(x, NamedSharding(mesh, P(*spec)))
    by_dev = {s.device.id: s.index for s in a.addressable_shards}
    boxes[repr(spec)] = [
        [[sl.start or 0, x.shape[d] if sl.stop is None else sl.stop]
         for d, sl in enumerate(by_dev[mesh.devices[pos].id])]
        for pos in np.ndindex(mesh.devices.shape)]
out["boxes"] = np.frombuffer(json.dumps(boxes).encode(), np.uint8)

# one expert-parallel layer, fp32: S = 62 pads to 64, 16 tokens a shard
rng = np.random.default_rng(0)
base = dataclasses.replace(get_config("olmoe-1b-7b").reduced(), n_experts=8, top_k=2,
                           dtype=jnp.float32)
d, f, E = base.d_model, base.d_ff, base.n_experts
layer = {"router": rng.standard_normal((d, E)).astype(np.float32) * 0.02,
         "w_gate": rng.standard_normal((E, d, f)).astype(np.float32) * d ** -0.5,
         "w_up": rng.standard_normal((E, d, f)).astype(np.float32) * d ** -0.5,
         "w_down": rng.standard_normal((E, f, d)).astype(np.float32) * f ** -0.5}
xm = rng.standard_normal((2, 62, d)).astype(np.float32) * 0.5
wy = rng.standard_normal((2, 62, d)).astype(np.float32)
for k, v in layer.items():
    out["ep/" + k] = v
out["ep/x"], out["ep/wy"] = xm, wy
for cf in CAPACITY_FACTORS:
    cfg = dataclasses.replace(base, capacity_factor=cf)

    def loss(p, xx):
        y, aux = moe_ffn_ep(p, xx, cfg, return_aux=True)
        return jnp.sum(y * wy) + aux, (y, aux)

    with mesh:
        (_, (y, aux)), g = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
            layer, xm)
    out[f"ep{cf}/y"], out[f"ep{cf}/aux"] = np.asarray(y), np.asarray(aux)
    for k in layer:
        out[f"ep{cf}/g_{k}"] = np.asarray(g[0][k])
    out[f"ep{cf}/g_x"] = np.asarray(g[1])
    out[f"ep{cf}/moe_ffn"] = np.asarray(moe_ffn(layer, xm, cfg))     # no mesh, m = 1

# the models: prefill + 2 decode steps, and one train step
for name, (arch, over, eps) in MODELS.items():
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype=jnp.float32, **over)
    params = init_params(jax.random.PRNGKey(0), cfg)
    for i, l in enumerate(jax.tree.leaves(params)):
        out[f"{name}/p{i}"] = np.asarray(l)
    toks = rng.integers(0, cfg.vocab, (2, 13)).astype(np.int32)
    nxt = rng.integers(0, cfg.vocab, (2, 2)).astype(np.int32)
    out[f"{name}/toks"], out[f"{name}/next"] = toks, nxt
    with mesh:
        lg, caches, n = jax.jit(lambda p, t: prefill(p, t, cfg, max_len=16))(params, toks)
        steps = [lg]
        dec = jax.jit(lambda p, t, c, n: decode_step(p, t, c, n, cfg))
        for i in range(2):
            lg, caches = dec(params, nxt[:, i], caches, n + i)
            steps.append(lg)
    out[f"{name}/logits"] = np.stack([np.asarray(s) for s in steps])
    # each mesh position's box of every cache leaf in cache_pspec's layout
    cboxes = {}
    for i, c in enumerate(caches):
        for leaf, a in c.items():
            a = jax.device_put(np.asarray(a), cache_shardings({leaf: a}, mesh)[leaf])
            by_dev = {s.device.id: s.index for s in a.addressable_shards}
            cboxes[f"{i}/{leaf}"] = [
                [[sl.start or 0, a.shape[d] if sl.stop is None else sl.stop]
                 for d, sl in enumerate(by_dev[mesh.devices[pos].id])]
                for pos in np.ndindex(mesh.devices.shape)]
    out[f"{name}/cache_boxes"] = np.frombuffer(json.dumps(cboxes).encode(), np.uint8)
    if eps is None:                 # held at prefill and decode only
        continue
    opt = init_adamw(params)
    step = make_train_step(cfg, TrainConfig(remat=True, opt=AdamWConfig(eps=eps)))
    bt = rng.integers(0, cfg.vocab, (4, 32)).astype(np.int32)
    batch = {"tokens": bt, "labels": bt}
    out[f"{name}/batch"] = bt
    with mesh:
        p_sh = params_shardings(params, mesh)
        o_sh = type(opt)(step=None, mu=params_shardings(opt.mu, mesh),
                         nu=params_shardings(opt.nu, mesh))
        jitted = jax.jit(step, in_shardings=(p_sh, o_sh, batch_shardings(batch, mesh)),
                         out_shardings=(p_sh, o_sh, None))
        new_p, _, metrics = jitted(params, opt, batch)
    out[f"{name}/loss"] = np.asarray(metrics["loss"])
    for i, l in enumerate(jax.tree.leaves(new_p)):
        out[f"{name}/new{i}"] = np.asarray(l)
    new_free, _, free = jax.jit(step)(params, opt, batch)      # the same step, no mesh
    out[f"{name}/free_loss"] = np.asarray(free["loss"])
    for i, l in enumerate(jax.tree.leaves(new_free)):
        out[f"{name}/free{i}"] = np.asarray(l)
    names = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(params)[0]]
    out[f"{name}/names"] = np.frombuffer(json.dumps(names).encode(), np.uint8)
# the sequence-sharded KV cache: prefill + 2 decode steps with kv_seq_shard on
from repro.distributed.sharding import OPT
for name, (arch, over, B) in SEQ_MODELS.items():
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype=jnp.float32, **over)
    params = init_params(jax.random.PRNGKey(1), cfg)
    for i, l in enumerate(jax.tree.leaves(params)):
        out[f"{name}/p{i}"] = np.asarray(l)
    toks = rng.integers(0, cfg.vocab, (B, 13)).astype(np.int32)
    nxt = rng.integers(0, cfg.vocab, (B, 3)).astype(np.int32)
    out[f"{name}/toks"], out[f"{name}/next"] = toks, nxt
    OPT["kv_seq_shard"] = True
    with mesh:
        lg, caches, n = jax.jit(lambda p, t: prefill(p, t, cfg, max_len=16))(params, toks)
        steps = [lg]
        dec = jax.jit(lambda p, t, c, n: decode_step(p, t, c, n, cfg))
        for i in range(3):              # the last writes the cache's last slot
            lg, caches = dec(params, nxt[:, i], caches, n + i)
            steps.append(lg)
    OPT["kv_seq_shard"] = False
    out[f"{name}/logits"] = np.stack([np.asarray(s) for s in steps])
    out[f"{name}/cache_k"] = np.asarray(caches[0]["k"])
np.savez(sys.argv[1], **out)
print("JAX_SIDE_OK")
'''

PORT_SIDE = r'''
import dataclasses, json, socket, sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def work(rank, port, ref_path, out_path):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch.configs import get_config
    from repro_torch.core import MMAConfig, make_functional_engine
    from repro_torch.distributed import (
        NamedSharding, P, distribute, make_kv_fetch_step, make_wakeup_step,
        params_shardings, stage_from_host, to_placements)
    from repro_torch.launch import make_host_mesh
    from repro_torch.models import (abstract_params, decode_step, moe_ffn, moe_ffn_ep,
                                    prefill, use_mesh)
    from repro_torch.training import AdamWConfig, TrainConfig, init_adamw, make_train_step
    from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=8)
    mesh = make_host_mesh(model=4, device="cpu")
    ref = np.load(ref_path)
    arr = lambda k: torch.from_numpy(np.array(ref[k]))
    full = lambda t: (t.full_tensor() if isinstance(t, DTensor) else t).detach()
    res = {}

    # each rank's local box, gathered, against JAX's addressable shards
    boxes = json.loads(bytes(ref["boxes"]).decode())
    x = torch.arange(8 * 8 * 4).reshape(8, 8, 4)
    res["boxes"] = {}
    for key, want in boxes.items():
        pl = to_placements(P(*eval(key)), mesh)
        loc = DTensor.from_local(x, mesh, [Replicate()] * 2,
                                 run_check=False).redistribute(mesh, pl).to_local()
        first = np.unravel_index(int(loc.flatten()[0]), x.shape)
        box = [[int(c), int(c) + n] for c, n in zip(first, loc.shape)]
        got = [None] * 8
        dist.all_gather_object(got, box)
        res["boxes"][key] = got == want

    # moe_ffn_ep and its gradient
    base = dataclasses.replace(get_config("olmoe-1b-7b").reduced(), n_experts=8, top_k=2)
    layer = {k: arr("ep/" + k) for k in ("router", "w_gate", "w_up", "w_down")}
    xm, wy = arr("ep/x"), arr("ep/wy")
    sh = {"router": NamedSharding(mesh, P()),
          **{k: NamedSharding(mesh, P("model", None, None))
             for k in ("w_gate", "w_up", "w_down")}}
    for cf in CAPACITY_FACTORS:
        cfg = dataclasses.replace(base, capacity_factor=cf)
        with use_mesh(mesh):
            lay = {k: distribute(layer[k], sh[k]).requires_grad_(True) for k in layer}
            xd = distribute(xm, NamedSharding(mesh, P("data", None, None))).requires_grad_(True)
            y, aux = moe_ffn_ep(lay, xd, cfg, return_aux=True)
            grads = torch.autograd.grad((y * wy).sum() + aux, list(lay.values()) + [xd])
        r = {"y": rel(full(y), ref[f"ep{cf}/y"]), "aux": rel(full(aux), ref[f"ep{cf}/aux"]),
             "y_equals_moe_ffn": bool(torch.equal(full(y), moe_ffn(layer, xm, cfg)))}
        for k, g in zip(list(layer) + ["x"], grads):
            r["g_" + k] = rel(full(g), ref[f"ep{cf}/g_{k}"])
        res[f"ep{cf}"] = r
    # a model axis of 1: moe_ffn_ep is moe_ffn, as JAX's falls back
    flat = init_device_mesh("cpu", (8, 1), mesh_dim_names=("data", "model"))
    cfg = dataclasses.replace(base, capacity_factor=CAPACITY_FACTORS[-1])
    with use_mesh(flat):
        y1 = moe_ffn_ep(distribute(layer, {k: NamedSharding(flat, P()) for k in layer}),
                        distribute(xm, NamedSharding(flat, P())), cfg)
    res["m1"] = {"equals_moe_ffn": bool(torch.equal(full(y1), moe_ffn(layer, xm, cfg))),
                 "vs_jax": rel(full(y1), ref[f"ep{cfg.capacity_factor}/moe_ffn"])}

    # the models under the mesh
    import repro_torch.models.ssm as ssm
    from unittest import mock

    def box(t):
        """This rank's box of DTensor ``t``, gathered from every rank."""
        x = torch.arange(t.numel()).reshape(t.shape)
        loc = DTensor.from_local(x, mesh, [Replicate()] * 2,
                                 run_check=False).redistribute(mesh, t.placements).to_local()
        first = np.unravel_index(int(loc.flatten()[0]), x.shape)
        got = [None] * 8
        dist.all_gather_object(got, [[int(c), int(c) + n] for c, n in zip(first, loc.shape)])
        return got

    for name, (arch, over, eps) in MODELS.items():
        cfg = dataclasses.replace(get_config(arch).reduced(), **over)
        tmpl = abstract_params(cfg)
        host = tree_unflatten(tmpl, [arr(f"{name}/p{i}") for i in range(len(tree_leaves(tmpl)))])
        heads, ssd = set(), ssm.ssd_op
        with use_mesh(mesh), mock.patch.object(
                ssm, "ssd_op", lambda x, *a: heads.add(x.shape[2]) or ssd(x, *a)):
            params = distribute(host, params_shardings(host, mesh))
            nxt = torch.from_numpy(ref[f"{name}/next"]).long()
            lg, caches, n = prefill(params, torch.from_numpy(ref[f"{name}/toks"]).long(),
                                    cfg, max_len=16)
            steps = [full(lg)]
            for i in range(2):
                lg, caches = decode_step(params, nxt[:, i], caches, n + i, cfg)
                steps.append(full(lg))
        want = json.loads(bytes(ref[f"{name}/cache_boxes"]).decode())
        res[name] = {
            "logits": max(rel(s, j) for s, j in zip(steps, ref[f"{name}/logits"])),
            "k4_local_heads": sorted(heads),
            "cache_boxes": {f"{i}/{k}": box(a) == want[f"{i}/{k}"]
                            for i, c in enumerate(caches) for k, a in c.items()},
        }
        if eps is None:             # held at prefill and decode only
            continue
        with use_mesh(mesh):
            step = make_train_step(cfg, TrainConfig(remat=True, opt=AdamWConfig(eps=eps)))
            bt = torch.from_numpy(ref[f"{name}/batch"]).long()
            new_p, _, metrics = step(params, init_adamw(params), {"tokens": bt, "labels": bt})
        names = json.loads(bytes(ref[f"{name}/names"]).decode())
        res[name].update({
            "loss": rel(metrics["loss"], ref[f"{name}/loss"]),
            "free_loss": rel(metrics["loss"], ref[f"{name}/free_loss"]),
            "params": {n: rel(full(p), ref[f"{name}/new{i}"])
                       for i, (n, p) in enumerate(zip(names, tree_leaves(new_p)))},
            "free_params": {n: rel(full(p), ref[f"{name}/free{i}"])
                            for i, (n, p) in enumerate(zip(names, tree_leaves(new_p)))},
            "jax_mesh_vs_free": {n: rel(ref[f"{name}/new{i}"], ref[f"{name}/free{i}"])
                                 for i, n in enumerate(names)},
            "placed": all(tuple(p.placements) == tuple(s.placements) for p, s in zip(
                tree_leaves(new_p), tree_leaves(params_shardings(host, mesh)))),
        })

    # the sequence-sharded KV cache
    from repro_torch.distributed.sharding import OPT

    def refuses(call):
        """Whether ``call`` raises ValueError on this rank, from every rank."""
        try:
            call()
            ok = False
        except ValueError:
            ok = True
        got = [None] * 8
        dist.all_gather_object(got, ok)
        return got

    for name, (arch, over, B) in SEQ_MODELS.items():
        cfg = dataclasses.replace(get_config(arch).reduced(), **over)
        tmpl = abstract_params(cfg)
        host = tree_unflatten(tmpl, [arr(f"{name}/p{i}") for i in range(len(tree_leaves(tmpl)))])
        OPT["kv_seq_shard"] = True
        try:
            with use_mesh(mesh):
                params = distribute(host, params_shardings(host, mesh))
                nxt = torch.from_numpy(ref[f"{name}/next"]).long()
                lg, caches, n = prefill(params, torch.from_numpy(ref[f"{name}/toks"]).long(),
                                        cfg, max_len=16)
                placed = str(list(caches[0]["k"].placements))
                steps = [full(lg)]
                for i in range(3):      # the last writes the cache's last slot
                    lg, caches = decode_step(params, nxt[:, i], caches, n + i, cfg)
                    steps.append(full(lg))
                ck = caches[0]["k"]
                local_t = ck.to_local().shape[2]
                ck = full(ck)
                # the full cache: a decode past it and a longer prefill raise on every rank
                over_seq = [refuses(lambda: decode_step(params, nxt[:, 0], caches, n + 3, cfg)),
                            refuses(lambda: prefill(params, torch.zeros((B, 17), dtype=torch.long),
                                                    cfg, max_len=16))]
        finally:
            OPT["kv_seq_shard"] = False
        with use_mesh(mesh):            # the same bounds with the option off
            toks = torch.zeros((B, 16), dtype=torch.long)
            _, full_caches, _ = prefill(params, toks, cfg, max_len=16)
            over_heads = [refuses(lambda: decode_step(params, nxt[:, 0], full_caches, 16, cfg)),
                          refuses(lambda: prefill(params, torch.zeros((B, 17), dtype=torch.long),
                                                  cfg, max_len=16))]
        res[name] = {"logits": max(rel(s, j) for s, j in zip(steps, ref[f"{name}/logits"])),
                     "cache_k": rel(ck, ref[f"{name}/cache_k"]),
                     "placements": placed, "local_positions": local_t,
                     "refused_kv_seq_shard": over_seq, "refused": over_heads}

    # the wake-up and KV-fetch reshards
    eng = make_functional_engine(devices=[torch.device("cpu")],
                                 config=MMAConfig(chunk_bytes=4096, fallback_bytes=0))
    gen = torch.Generator().manual_seed(0)
    rand = lambda tree: tree_map(lambda a: torch.randn(a.shape, generator=gen).to(a.dtype), tree)

    def gathers(comm):
        return sum(c for op, c in comm.get_comm_counts().items() if "all_gather" in str(op))

    for arch in ("tinyllama-1.1b", "olmoe-1b-7b"):
        cfg = get_config(arch).reduced()
        fn, stage_sh, serve_sh = make_wakeup_step(cfg, mesh)
        host = rand(abstract_params(cfg))
        staged = stage_from_host(host, stage_sh, eng)
        with CommDebugMode() as comm:
            served = fn(staged)
        fetch, caches, cstage, cserve = make_kv_fetch_step(cfg, mesh, 2, 16)
        hc = rand(caches)
        with CommDebugMode() as comm2:
            fetched = fetch(stage_from_host(hc, cstage, eng))
        res["reshard/" + arch] = {
            "staged_local": all(s.to_local().numel() * (8 if any(p.is_shard() for p in sh.placements) else 1)
                                == h.numel() for s, h, sh in zip(
                                    tree_leaves(staged), tree_leaves(host), tree_leaves(stage_sh))),
            "wake_exact": all(torch.equal(full(s), h) for s, h in zip(tree_leaves(served),
                                                                      tree_leaves(host))),
            "wake_placed": all(tuple(s.placements) == tuple(sh.placements) for s, sh in zip(
                tree_leaves(served), tree_leaves(serve_sh))),
            "wake_all_gathers": gathers(comm),
            "kv_exact": all(torch.equal(full(s), h) for s, h in zip(tree_leaves(fetched),
                                                                    tree_leaves(hc))),
            "kv_placed": all(tuple(s.placements) == tuple(sh.placements) for s, sh in zip(
                tree_leaves(fetched), tree_leaves(cserve))),
            "kv_all_gathers": gathers(comm2),
        }
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    mp.start_processes(work, args=(port, sys.argv[1], sys.argv[2]), nprocs=8,
                       start_method="spawn")
    print("PORT_SIDE_OK")
'''

SPECS = [("data", "model"), (("data", "model"),), (None, "model"), ("model", "data"),
         (None, ("data", "model")), ()]
CAPACITY_FACTORS = (64.0, 1.25)     # no drops; the config's own, which drops
# name: (config, overrides, AdamW eps). Adam's first step is g / (|g| + eps):
# with eps 1e-8 an entry of |g| near 1e-8 turns its last fp32 bits (another
# summation order) into a visible share of lr. Mamba2's A_log and biases
# have such entries, so its step is held with eps = 1, where the update is
# smooth in g (as tests/test_torch_training.py holds the train step).
# An eps of None holds a model at prefill and decode only (no train step).
MODELS = {"olmoe": ("olmoe-1b-7b", {"moe_ep": True}, 1e-8),
          "tinyllama_g2": ("tinyllama-1.1b", {"n_kv_heads": 2}, 1e-8),   # H 4 on m 4, G 2
          "mamba2": ("mamba2-370m", {}, 1.0),           # K4 on 16 / 4 local heads a rank
          # two B/C groups: a rank's 4 heads lie inside one group of 8
          "mamba2_g2": ("mamba2-370m", {"ssm_groups": 2}, None),
          # one period of the hybrid plan without MoE: attention's and the
          # SSM's layouts meet in one period (1 attn + 7 ssm layers)
          "jamba_period": ("jamba-1.5-large-398b", {"n_experts": 0, "n_layers": 8}, None)}
TRAINED = sorted(k for k, v in MODELS.items() if v[2] is not None)
# name: (config, overrides, batch) run with OPT["kv_seq_shard"] on in both
# packages: TinyLlama with 2 KV heads on a model axis of 4, so the caches'
# 16 positions go over ``model`` (4 a rank) where the data axis divides the
# batch, and over ("data", "model") (2 a rank) where it does not.
SEQ_MODELS = {"tinyllama_seq_b2": ("tinyllama-1.1b", {"n_kv_heads": 2}, 2),
              "tinyllama_seq_b1": ("tinyllama-1.1b", {"n_kv_heads": 2}, 1)}
SHARED = (f"SPECS = {SPECS!r}\nCAPACITY_FACTORS = {CAPACITY_FACTORS!r}\nMODELS = {MODELS!r}\n"
          f"SEQ_MODELS = {SEQ_MODELS!r}\n")


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """Both sides' results: (the JAX npz, the port's JSON)."""
    tmp = tmp_path_factory.mktemp("mesh")
    ref, res = tmp / "jax.npz", tmp / "port.json"
    (tmp / "jax_side.py").write_text(SHARED + JAX_SIDE)
    (tmp / "port_side.py").write_text(SHARED + PORT_SIDE)
    out = subprocess.run(
        [sys.executable, str(tmp / "jax_side.py"), str(ref)], cwd=ROOT, timeout=300,
        env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=8"),
        capture_output=True, text=True)
    assert out.returncode == 0 and "JAX_SIDE_OK" in out.stdout, out.stderr[-3000:]
    out = subprocess.run(
        [sys.executable, str(tmp / "port_side.py"), str(ref), str(res)], cwd=ROOT,
        timeout=300, env=_env(CUDA_VISIBLE_DEVICES=""), capture_output=True, text=True)
    assert out.returncode == 0 and "PORT_SIDE_OK" in out.stdout, out.stderr[-3000:]
    return np.load(ref), json.loads(res.read_text())


@pytest.mark.parametrize("spec", [repr(s) for s in SPECS])
def test_local_boxes_equal_jax_addressable_shards(mesh_runs, spec):
    """On (2, 4), rank data*4 + model holds the box JAX's device at that
    mesh position holds, for every spec (multi-axis entries included)."""
    assert mesh_runs[1]["boxes"][spec] is True


@pytest.mark.parametrize("cf", CAPACITY_FACTORS)
def test_moe_ffn_ep_matches_jax(mesh_runs, cf):
    ref, res = mesh_runs
    r = res[f"ep{cf}"]
    assert r["y"] <= 1e-5 and r["aux"] <= 1e-5, r
    if cf == 64.0:                  # nothing dropped: the plain channel's output
        assert r["y_equals_moe_ffn"], r
    else:                           # the per-shard capacity drops tokens
        assert np.abs(ref[f"ep{cf}/y"] - ref["ep64.0/y"]).max() > 1e-3


@pytest.mark.parametrize("cf", CAPACITY_FACTORS)
def test_moe_ffn_ep_gradient_matches_jax_grad(mesh_runs, cf):
    """d/d(router, experts, x) of sum(y * w) + aux against ``jax.grad``."""
    r = mesh_runs[1][f"ep{cf}"]
    for k in ("router", "w_gate", "w_up", "w_down", "x"):
        assert r["g_" + k] <= 1e-5, (k, r)


def test_moe_ffn_ep_with_one_model_rank_is_moe_ffn(mesh_runs):
    r = mesh_runs[1]["m1"]
    assert r["equals_moe_ffn"] and r["vs_jax"] <= 1e-5, r


@pytest.mark.parametrize("name", sorted(MODELS))
def test_mesh_prefill_and_decode_match_jax(mesh_runs, name):
    """Prefill logits and two decode steps on (2, 4), the attention on each
    rank's local heads."""
    r = mesh_runs[1][name]
    assert r["logits"] <= 2e-4, r


@pytest.mark.parametrize("name", sorted(MODELS))
def test_mesh_caches_sit_in_cache_pspec_boxes(mesh_runs, name):
    """After prefill and two decode steps every cache leaf (KV, SSM state,
    conv tails) is held by each rank in the box that JAX's device at its
    mesh position holds under ``cache_shardings``."""
    boxes = mesh_runs[1][name]["cache_boxes"]
    assert boxes and all(boxes.values()), boxes


@pytest.mark.parametrize("name", ["mamba2", "mamba2_g2", "jamba_period"])
def test_mesh_ssm_runs_k4_on_local_heads(mesh_runs, name):
    """Mamba2's mixer is head-parallel on (2, 4): each rank's K4 (through
    ``ssd_op``) sees h / 4 of the reduced config's h heads."""
    arch, over, _ = MODELS[name]
    import dataclasses

    h = dataclasses.replace(get_config(arch).reduced(), **over).ssm_heads
    assert h % 4 == 0 and h > 4             # a layout that is really split
    assert mesh_runs[1][name]["k4_local_heads"] == [h // 4]


@pytest.mark.parametrize("name,placements,local_positions", [
    ("tinyllama_seq_b2", "[Shard(dim=1), Shard(dim=2)]", 4),
    ("tinyllama_seq_b1", "[Shard(dim=2), Shard(dim=2)]", 2),
])
def test_sequence_sharded_cache_prefill_and_decode_match_jax(mesh_runs, name, placements,
                                                             local_positions):
    """kv_seq_shard on, G = 2 on a model axis of 4: the prefill's caches
    come out split on the sequence axis as ``cache_pspec`` lays them out
    (batch over ``data`` and positions over ``model``, or positions over
    both), two decode steps write each new position on the rank that holds
    it and attend over the gathered cache, and the logits and the written
    cache match JAX's mesh run with the same option."""
    r = mesh_runs[1][name]
    assert r["placements"] == placements and r["local_positions"] == local_positions, r
    assert r["logits"] <= 2e-4 and r["cache_k"] <= 2e-4, r


@pytest.mark.parametrize("name", sorted(SEQ_MODELS))
def test_linear_cache_bounds_refused_on_every_rank(mesh_runs, name):
    """With the cache full (16 of 16 positions) a decode step raises
    ``ValueError`` on all 8 ranks, and so does a 17-token prefill into 16
    slots, with kv_seq_shard on (positions split over ``model``) and off;
    no rank carries on into a collective the others left."""
    r = mesh_runs[1][name]
    assert r["refused_kv_seq_shard"] == [[True] * 8] * 2, r
    assert r["refused"] == [[True] * 8] * 2, r


# JAX's sharded step gives Mamba2's conv_B_w and conv_C_w (replicated
# (w, g*n) leaves feeding a model-sharded computation) 4x, the model axis'
# size, their mesh-free gradient, which moves every leaf through the global
# norm's clip; the port's mesh step keeps the mesh-free gradient (ROADMAP,
# queue 3). Such a model's step is held to JAX's mesh-free step.
JAX_MESH_GRAD_FAULT = {"mamba2"}


@pytest.mark.parametrize("name", TRAINED)
def test_mesh_train_step_matches_jax(mesh_runs, name):
    """One AdamW step on (2, 4) against JAX's on its Auto mesh: the loss
    within 1e-5 relative, every updated leaf within 1e-4 of its largest
    magnitude."""
    r = mesh_runs[1][name]
    assert r["placed"], r
    if name in JAX_MESH_GRAD_FAULT:
        assert max(r["jax_mesh_vs_free"].values()) > 1e-3, r["jax_mesh_vs_free"]
        loss, params = r["free_loss"], r["free_params"]
    else:
        loss, params = r["loss"], r["params"]
    assert loss <= 1e-5, r
    assert max(params.values()) <= 1e-4, params


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "olmoe-1b-7b"])
def test_wakeup_reshard_bit_exact(mesh_runs, arch):
    """Each rank lands 1/8 of every chunked leaf (whole where no dim
    divides 8: the JAX layout's quirk), and the reshard into the serving
    layout gives the host weights bit for bit, through all-gathers."""
    r = mesh_runs[1]["reshard/" + arch]
    assert r["staged_local"] and r["wake_exact"] and r["wake_placed"], r
    assert r["wake_all_gathers"] >= 1, r


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "olmoe-1b-7b"])
def test_kv_fetch_reshard_bit_exact(mesh_runs, arch):
    r = mesh_runs[1]["reshard/" + arch]
    assert r["kv_exact"] and r["kv_placed"] and r["kv_all_gathers"] >= 1, r


def test_staging_replicates_a_leaf_no_dim_of_which_divides_the_ranks():
    """The JAX layout's quirk, kept: a leaf none of whose dims the rank
    count divides is landed whole on every rank."""
    from repro_torch.distributed import staging_shardings

    mesh = TorchFakeMesh((2, 4), ("data", "model"))
    mesh.size = lambda: 8
    sh = staging_shardings({"a": torch.empty(6, 3, device="meta"),
                            "b": torch.empty(5, 16, device="meta"),
                            "c": torch.empty((), device="meta")}, mesh)
    assert [tuple(sh[k].spec) for k in "abc"] == [(), (None, ("data", "model")), ()]
