"""The port's launchers (repro_torch.launch.{specs,roofline,serve,train,
dryrun}) against the JAX package's, on the CPU, and the kernel ops' meta
route that the dry-run takes.

* ``input_specs`` for every architecture x every ``INPUT_SHAPES`` entry:
  the same leaf paths, shapes and dtypes as JAX's ``ShapeDtypeStruct``s;
  ``model_flops_estimate`` and ``active_param_count`` equal. Exact.
* ``roofline_terms``: the same dominant term and FLOPs ratio as JAX's,
  each term JAX's scaled by the ratio of the two packages' constants
  (1e-12 relative). ``collective_stats``: JAX's HLO parser on one synthetic
  line per kind and group size against the port's reducer on the same
  collective as a record. Equal bytes and counts.
* The dry-run's per-device FLOPs rule on a fake (2, 4) world: a product
  sharded on both mesh dims counts 1/8 of the global FLOPs, a replicated
  one all of them, a ``Partial`` one 1/4; each equals the FLOPs of the
  product of the local shards. Exact.
* ``launch.serve``: JAX's ``main`` and the port's on the same reduced fp32
  weights print the same lines (hits, generated tokens, transfers, the
  paper-scale line).
* ``launch.train`` (in a subprocess): JAX's ``main`` on a one-device mesh
  with Auto axes (its own mesh has Explicit axes, on which jax 0.9's
  sharding constraints raise) and the port's, on the same initial weights:
  losses within 1e-4 relative, gradient norms within 1e-3.
* The dry-run of tinyllama-1.1b x decode_32k on 16x16 and 2x16x16 (each
  side in a subprocess): both combos ok, and the port's
  ``argument_size_in_bytes`` equal to the sum of JAX's per-device shard
  bytes of the same inputs (``NamedSharding.shard_shape``). The two
  packages' FLOPs, bytes and collectives are printed side by side.
"""
import contextlib
import io
import json
import os
import subprocess
import sys
from pathlib import Path
from unittest import mock

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.launch.roofline as jroofline
import repro.launch.serve as jserve
from repro.configs import ARCHS, INPUT_SHAPES
from repro.configs import get_config as jax_config
from repro.launch.specs import abstract_state as jax_abstract_state
from repro.launch.specs import input_specs as jax_input_specs
from repro.models import init_params as jax_init
import repro_torch.launch.roofline as troofline
import repro_torch.launch.serve as tserve
import repro_torch.launch.train as ttrain
from repro_torch.configs import get_config
from repro_torch.kernels import build
from repro_torch.kernels import (
    decode_attention,
    decode_attention_op,
    flash_attention,
    flash_attention_op,
    relay_assemble,
    ssd_chunk,
    ssd_chunk_op,
    ssd_op,
)
from repro_torch.launch import input_specs
from repro_torch.launch.specs import abstract_state
from repro_torch.models import params_from_jax
from repro_torch.tree import tree_leaves, tree_leaves_with_path

ROOT = Path(__file__).resolve().parents[1]
COMBOS = [(a, s) for a in sorted(ARCHS) for s in INPUT_SHAPES]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env["CUDA_VISIBLE_DEVICES"] = ""
    env["JAX_PLATFORMS"] = "cpu"
    return env


def _key(path) -> str:
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)


# ---------------------------------------------------------------------------
# specs and model FLOPs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,shape", COMBOS)
def test_input_specs_equal_jax(arch, shape):
    want = {_key(p): (tuple(l.shape), str(l.dtype)) for p, l in
            jax.tree_util.tree_flatten_with_path(
                jax_input_specs(jax_config(arch, shape=shape), INPUT_SHAPES[shape]))[0]}
    specs = input_specs(get_config(arch, shape=shape), INPUT_SHAPES[shape])
    got = {_key(p): (tuple(l.shape), str(l.dtype).removeprefix("torch."))
           for p, l in tree_leaves_with_path(specs)}
    assert got == want
    assert all(l.device.type == "meta" for _, l in tree_leaves_with_path(specs))


@pytest.mark.parametrize("arch,shape", COMBOS)
def test_model_flops_estimate_equals_jax(arch, shape):
    jcfg, tcfg = jax_config(arch, shape=shape), get_config(arch, shape=shape)
    assert troofline.active_param_count(tcfg) == jroofline.active_param_count(jcfg)
    assert (troofline.model_flops_estimate(tcfg, INPUT_SHAPES[shape])
            == jroofline.model_flops_estimate(jcfg, INPUT_SHAPES[shape]))


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "olmoe-1b-7b", "mamba2-370m"])
def test_abstract_state_equals_jax(arch):
    want = [(tuple(l.shape), str(l.dtype)) for l in
            jax.tree.leaves(jax_abstract_state(jax_config(arch), with_opt=True))]
    state = abstract_state(get_config(arch), with_opt=True)
    leaves = tree_leaves(state)
    assert [(tuple(l.shape), str(l.dtype).removeprefix("torch.")) for l in leaves] == want
    assert all(l.device.type == "meta" for l in leaves)


# ---------------------------------------------------------------------------
# roofline terms and collective bytes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("flops,hbm,coll_bytes", [
    (1e15, 1e9, 1e6),          # compute-bound under both sets of constants
    (1e9, 1e12, 1e6),          # memory-bound
    (1e9, 1e9, 1e11),          # collective-bound
])
def test_roofline_terms_scale_with_the_constants(flops, hbm, coll_bytes):
    jc = jroofline.CollectiveStats({"all-reduce": int(coll_bytes)}, {"all-reduce": 3})
    tc = troofline.CollectiveStats({"all-reduce": int(coll_bytes)}, {"all-reduce": 3})
    j = jroofline.roofline_terms(flops, hbm, jc, model_flops=3e15, n_chips=256)
    t = troofline.roofline_terms(flops, hbm, tc, model_flops=3e15, n_chips=256)
    assert t.dominant == j.dominant
    assert t.flops_ratio == j.flops_ratio
    assert t.collective_counts == j.collective_counts
    for term, jconst, tconst in (
        ("compute_s", jroofline.PEAK_FLOPS_BF16, troofline.PEAK_FLOPS_BF16),
        ("memory_s", jroofline.HBM_GBPS, troofline.HBM_GBPS),
        ("collective_s", jroofline.ICI_LINK_GBPS, troofline.LINK_GBPS),
    ):
        assert getattr(t, term) == pytest.approx(getattr(j, term) * jconst / tconst,
                                                 rel=1e-12)


def _hlo_line(kind: str, g: int):
    """One HLO instruction of ``kind`` over a group of ``g`` ranks, and the
    same collective as the port's record (local operand and result bytes)."""
    rows = 64
    shapes = {"all-gather": (rows, rows * g), "reduce-scatter": (rows * g, rows),
              "all-reduce": (rows, rows), "all-to-all": (rows, rows),
              "collective-permute": (rows, rows)}
    op_rows, res_rows = shapes[kind]
    groups = "{{" + ",".join(map(str, range(g))) + "}}"
    line = (f"  %{kind}.7 = bf16[{res_rows},256]{{1,0}} {kind}(bf16[{op_rows},256]{{1,0}} "
            f"%param.1), replica_groups={groups}, dimensions={{0}}")
    return line, troofline.CollectiveRecord(kind, op_rows * 256 * 2, res_rows * 256 * 2, g)


@pytest.mark.parametrize("g", [2, 4, 16])
@pytest.mark.parametrize("kind", troofline.COLLECTIVE_KINDS)
def test_collective_stats_equal_jax_parser(kind, g):
    line, record = _hlo_line(kind, g)
    want = jroofline.collective_stats(line)
    got = troofline.collective_stats([record])
    assert want.count_by_kind[kind] == 1
    assert got.bytes_by_kind == want.bytes_by_kind
    assert got.count_by_kind == want.count_by_kind


def test_collective_stats_sum_over_kinds_as_jax():
    lines, records = zip(*(_hlo_line(k, g) for k in troofline.COLLECTIVE_KINDS
                           for g in (2, 4, 16)))
    want = jroofline.collective_stats("\n".join(lines))
    got = troofline.collective_stats(records)
    assert (got.bytes_by_kind, got.count_by_kind, got.total_bytes) == \
        (want.bytes_by_kind, want.count_by_kind, want.total_bytes)


# ---------------------------------------------------------------------------
# the dry-run's per-device FLOPs on a fake (2, 4) world
# ---------------------------------------------------------------------------
FLOPS_RULE = r"""
import json, sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import torch, torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.launch.dryrun import StepRecorder

dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
from torch.distributed.device_mesh import init_device_mesh
mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
M, K, N = 64, 32, 128

def place(t, pl):
    local = list(t.shape)
    for i, p in enumerate(pl):
        if p.is_shard():
            local[p.dim] //= mesh.size(i)
    return DTensor.from_local(torch.empty(local, device="meta"), mesh, pl,
                              run_check=False, shape=t.shape, stride=t.stride())

cases = {
    "shard_shard": ([Shard(0), Replicate()], [Replicate(), Shard(1)]),
    "replicate": ([Replicate(), Replicate()], [Replicate(), Replicate()]),
    "partial": ([Replicate(), Shard(1)], [Replicate(), Shard(0)]),
}
out = {}
for name, (pa, pb) in cases.items():
    a, b = place(torch.empty(M, K), pa), place(torch.empty(K, N), pb)
    rec = StepRecorder()
    with rec:
        c = a @ b
    local = StepRecorder()
    with local:
        a.to_local() @ b.to_local()
    out[name] = dict(flops=rec.flops, local_flops=local.flops, collectives=len(rec.collectives),
                     placements=[repr(p) for p in c.placements])
# a Partial result made whole: one all-reduce over the 4 model ranks
a, b = place(torch.empty(M, K), cases["partial"][0]), place(torch.empty(K, N), cases["partial"][1])
c = a @ b
rec = StepRecorder()
with rec:
    c.redistribute(mesh, [Replicate(), Replicate()])
out["all_reduce"] = [list(r) for r in rec.collectives]
print("RULE " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def flops_rule():
    out = subprocess.run([sys.executable, "-c", FLOPS_RULE], env=_env(),
                         capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    line = [l for l in out.stdout.splitlines() if l.startswith("RULE ")][0]
    return json.loads(line[5:])


@pytest.mark.parametrize("case,share,placements", [
    ("shard_shard", 1 / 8, ["Shard(dim=0)", "Shard(dim=1)"]),
    ("replicate", 1, ["Replicate()", "Replicate()"]),
    ("partial", 1 / 4, ["Replicate()", "Partial(sum)"]),
])
def test_dryrun_counts_a_sharded_product_per_device(flops_rule, case, share, placements):
    global_flops = 2 * 64 * 32 * 128
    r = flops_rule[case]
    assert r["placements"] == placements
    assert r["flops"] == global_flops * share == r["local_flops"]
    assert r["collectives"] == 0


def test_dryrun_records_the_all_reduce_of_a_partial_result(flops_rule):
    # (64, 128) fp32 on each rank, summed over the 4 ranks of the model axis
    assert flops_rule["all_reduce"] == [["all-reduce", 64 * 128 * 4, 64 * 128 * 4, 4]]


# ---------------------------------------------------------------------------
# launch.serve
# ---------------------------------------------------------------------------
def _serving(server_cls, params):
    """``server_cls`` serving ``params`` whatever its caller passes."""
    def make(cfg, **kw):
        return server_cls(cfg, **{**kw, "params": params})
    return make


def test_serve_prints_the_jax_launchers_lines():
    jcfg = jax_config("tinyllama-1.1b").reduced()
    jparams = jax.tree.map(np.asarray, jax_init(jax.random.PRNGKey(0), jcfg))
    tparams = params_from_jax(jparams, get_config("tinyllama-1.1b").reduced(), "cpu")
    want, got = io.StringIO(), io.StringIO()
    with mock.patch.object(sys, "argv", ["serve", "--requests", "4", "--max-new", "3"]), \
            mock.patch.object(jserve, "FunctionalServer",
                              _serving(jserve.FunctionalServer, jparams)), \
            contextlib.redirect_stdout(want):
        jserve.main()
    with mock.patch.object(tserve, "FunctionalServer",
                           _serving(tserve.FunctionalServer, tparams)), \
            contextlib.redirect_stdout(got):
        tserve.main(["--requests", "4", "--max-new", "3", "--device", "cpu"])
    assert got.getvalue() == want.getvalue()
    assert "1 prefix hits" in got.getvalue() and "paper-scale" in got.getvalue()


def test_serve_run_returns_the_requests_and_the_server():
    done, srv = tserve.run(get_config("tinyllama-1.1b").reduced(), requests=4,
                           max_new=2, prompt_len=16, device="cpu")
    assert [r.hit_tokens for r in done] == [0, 0, 0, 16]
    assert done[3].generated == done[0].generated
    assert srv.device.type == "cpu" and ("fetch", 16) in srv.transfer_log


# ---------------------------------------------------------------------------
# launch.train
# ---------------------------------------------------------------------------
TRAIN = r"""
import json, sys
from unittest import mock
import numpy as np
import jax
from jax.sharding import AxisType
import repro.launch.train as jtrain
import repro_torch.launch.train as ttrain
from repro.configs import get_config as jax_config
from repro_torch.configs import get_config
from repro_torch.models import params_from_jax

jcfg = jax_config("tinyllama-1.1b").reduced()
jparams = jtrain.init_params(jax.random.PRNGKey(0), jcfg)
host = jax.tree.map(np.asarray, jparams)

def auto_host_mesh(model=1):
    n = len(jax.devices())
    return jax.make_mesh((n // model, model), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)

argv = ["--steps", "3", "--batch", "2", "--seq", "16"]
with mock.patch.object(jtrain, "make_host_mesh", auto_host_mesh), \
        mock.patch.object(jtrain, "init_params", lambda key, cfg: jparams), \
        mock.patch.object(sys, "argv", ["train"] + argv):
    jtrain.main()
with mock.patch.object(ttrain, "init_params",
                       lambda cfg, gen, device: params_from_jax(host, cfg, device)):
    history = ttrain.main(argv + ["--device", "cpu"])
print("PORT " + json.dumps(history))
"""


def test_train_launcher_matches_jax():
    out = subprocess.run([sys.executable, "-c", TRAIN], env=_env(),
                         capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    jax_steps = [l.split() for l in lines if l.startswith("step")][:3]
    port = json.loads([l for l in lines if l.startswith("PORT ")][0][5:])
    assert lines.count("done") == 2 and len(jax_steps) == len(port) == 3
    assert lines.count("mesh: {'data': 1, 'model': 1}  arch: tinyllama-1.1b-smoke") == 2
    for j, t in zip(jax_steps, port):
        loss, gnorm = float(j[3]), float(j[5])
        assert abs(t["loss"] - loss) <= 1e-4 * abs(loss), (t, j)
        assert abs(t["grad_norm"] - gnorm) <= 1e-3 * abs(gnorm), (t, j)
    # the port prints the JAX launcher's lines from its own numbers
    assert [l for l in lines if l.startswith("step")][3:] == [
        f"step {t['step']:4d}  loss {t['loss']:.4f}  gnorm {t['grad_norm']:.2f}"
        for t in port]


class _Stop(Exception):
    pass


@pytest.mark.parametrize("flag,d_model,n_layers,name", [
    ([], 256, 2, "tinyllama-1.1b-smoke"),
    (["--no-reduced"], 2048, 22, "tinyllama-1.1b"),
])
def test_train_reduced_flag_parses(flag, d_model, n_layers, name):
    seen = {}

    def stop(cfg, gen, device):
        seen["cfg"] = cfg
        raise _Stop

    with mock.patch.object(ttrain, "init_params", stop), pytest.raises(_Stop):
        ttrain.main(flag + ["--device", "cpu"])
    cfg = seen["cfg"]
    assert (cfg.d_model, cfg.n_layers, cfg.name, cfg.dtype) == \
        (d_model, n_layers, name, torch.float32)
    assert not torch.distributed.is_initialized()      # the launcher ended its world


# ---------------------------------------------------------------------------
# the dry-run, each package in its own subprocess
# ---------------------------------------------------------------------------
PORT_DRYRUN = r"""
import json, sys
sys.modules["jax"] = None
sys.modules["repro"] = None
from repro_torch.distributed.sharding import OPT
from repro_torch.launch.dryrun import dryrun_one
rs = [dryrun_one("tinyllama-1.1b", "decode_32k", multi_pod=mp, verbose=False)
      for mp in (False, True)]
rs += [dryrun_one("gemma-7b", "decode_32k", multi_pod=mp, verbose=False)
       for mp in (False, True)]
OPT["kv_seq_shard"] = True
rs.append(dryrun_one("tinyllama-1.1b", "decode_32k", verbose=False))
OPT["kv_seq_shard"] = False
rs += [dryrun_one("mamba2-370m", s, verbose=False) for s in ("decode_32k", "prefill_32k")]
print("PORT " + json.dumps(rs))
"""

JAX_DRYRUN = r"""
import json
import numpy as np
import repro.launch.dryrun as jd       # sets 512 host devices before jax starts
import jax
from jax.sharding import AxisType
from repro.configs import INPUT_SHAPES, get_config
from repro.distributed.sharding import (OPT, batch_shardings, cache_shardings,
                                        params_shardings, replicated)
from repro.launch.specs import input_specs
from repro.models.init import abstract_params

def auto_production_mesh(*, multi_pod=False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return jax.make_mesh(shape, axes, axis_types=(AxisType.Auto,) * len(shape))

jd.make_production_mesh = auto_production_mesh
r = jd.dryrun_one("tinyllama-1.1b", "decode_32k", verbose=False)
cfg, shape = get_config("tinyllama-1.1b", shape="decode_32k"), INPUT_SHAPES["decode_32k"]
mesh = auto_production_mesh()
specs = input_specs(cfg, shape)
params = abstract_params(cfg)
pairs = [(params, params_shardings(params, mesh)),
         (specs["token"], batch_shardings(specs["token"], mesh)),
         (specs["caches"], cache_shardings(specs["caches"], mesh)),
         (specs["cache_len"], replicated(mesh))]


def shard_bytes(pairs):
    return sum(int(np.prod(sh.shard_shape(leaf.shape))) * leaf.dtype.itemsize
               for tree, shardings in pairs
               for leaf, sh in zip(jax.tree.leaves(tree), jax.tree.leaves(shardings)))


r["shard_bytes"] = shard_bytes(pairs)
OPT["kv_seq_shard"] = True              # the caches' sequence axis over model
r["shard_bytes_kv_seq_shard"] = shard_bytes(
    pairs[:2] + [(specs["caches"], cache_shardings(specs["caches"], mesh))] + pairs[3:])
OPT["kv_seq_shard"] = False
# Mamba2: the SSM state by heads and the conv tails by channels over model
r["mamba2"] = {}
for name in ("decode_32k", "prefill_32k"):
    m = jd.dryrun_one("mamba2-370m", name, verbose=False)
    mcfg = get_config("mamba2-370m", shape=name)
    mspecs = input_specs(mcfg, INPUT_SHAPES[name])
    mparams = abstract_params(mcfg)
    m["shard_bytes"] = shard_bytes(
        [(mparams, params_shardings(mparams, mesh))]
        + [(v, cache_shardings(v, mesh) if k == "caches" else replicated(mesh)
            if k == "cache_len" else batch_shardings(v, mesh)) for k, v in mspecs.items()])
    r["mamba2"][name] = m
print("JAX " + json.dumps(r))
"""


@pytest.fixture(scope="module")
def dryruns():
    runs = {}
    for tag, code in (("PORT", PORT_DRYRUN), ("JAX", JAX_DRYRUN)):
        out = subprocess.run([sys.executable, "-c", code], env=_env(),
                             capture_output=True, text=True, cwd=ROOT, timeout=600)
        assert out.returncode == 0, out.stderr[-3000:]
        line = [l for l in out.stdout.splitlines() if l.startswith(tag + " ")][0]
        runs[tag] = json.loads(line[len(tag) + 1:])
    return runs


def test_dryrun_one_combo_on_both_meshes(dryruns):
    r1, r2 = dryruns["PORT"][:2]
    assert r1["ok"] and r2["ok"]
    assert (r1["n_chips"], r2["n_chips"]) == (256, 512)
    assert (r1["mesh"], r2["mesh"]) == ("16x16", "2x16x16")
    assert r1["flops_per_device"] > 0 and r2["flops_per_device"] > 0
    assert r1["dominant"] in ("compute", "memory", "collective")
    assert "temp_size_in_bytes" not in r1["memory_analysis"]


def test_dryrun_argument_bytes_equal_jax_shards(dryruns):
    port, jx = dryruns["PORT"][0], dryruns["JAX"]
    assert port["memory_analysis"]["argument_size_in_bytes"] == jx["shard_bytes"]
    assert jx["memory_analysis"]["argument_size_in_bytes"] == jx["shard_bytes"]
    # the counts the two packages make of one decode step, side by side
    for key in ("flops_per_device", "hbm_bytes_per_device",
                "collective_bytes_per_device"):
        print(f"{key}: port {port[key]:.6g}, JAX {jx[key]:.6g}, "
              f"ratio {port[key] / jx[key]:.4g}")
    print(f"collectives: port {port['collective_counts']}, JAX {jx['collective_counts']}")
    print(f"output bytes: port {port['memory_analysis']['output_size_in_bytes']}, "
          f"JAX {jx['memory_analysis']['output_size_in_bytes']}")
    assert port["kind"] == jx["kind"] == "decode"
    assert port["model_flops"] == jx["model_flops"]
    # Mamba2's caches and inputs in JAX's layout: the same shard bytes
    for port, (name, jx) in zip(dryruns["PORT"][5:7], sorted(dryruns["JAX"]["mamba2"].items())):
        assert port["shape"] == name and port["ok"] and jx["ok"], (port, jx)
        assert port["memory_analysis"]["argument_size_in_bytes"] == jx["shard_bytes"], name
        for key in ("flops_per_device", "hbm_bytes_per_device",
                    "collective_bytes_per_device"):
            print(f"mamba2-370m x {name} {key}: port {port[key]:.6g}, JAX {jx[key]:.6g}")
        print(f"mamba2-370m x {name} collectives: port {port['collective_counts']}, "
              f"JAX {jx['collective_counts']}; argument bytes: port "
              f"{port['memory_analysis']['argument_size_in_bytes']}, JAX "
              f"{jx['memory_analysis']['argument_size_in_bytes']}")


def test_dryrun_of_gemma_with_256_wide_heads(dryruns):
    """gemma-7b x decode_32k (16 heads of 256) runs on both meshes: the
    kernel ops' meta route takes the head width the JAX package does."""
    r1, r2 = dryruns["PORT"][2:4]
    assert r1["ok"] and r2["ok"] and (r1["arch"], r1["shape"]) == ("gemma-7b", "decode_32k")
    assert (r1["n_chips"], r2["n_chips"]) == (256, 512)
    assert r1["flops_per_device"] > 0 and r2["flops_per_device"] > 0


def test_dryrun_of_mamba2_decode_moves_no_weights(dryruns):
    """mamba2-370m x decode_32k on 16 x 16 with the mixer head-parallel:
    no layer gathers its weights; each reduces ``w_out``'s partial output
    over ``model`` (one all-reduce a layer) and gathers its B/C conv tails
    and the norm's sums, a few MB a device in all."""
    port = dryruns["PORT"][5]
    assert (port["arch"], port["shape"], port["mesh"]) == ("mamba2-370m", "decode_32k",
                                                           "16x16")
    assert port["collective_counts"]["all-reduce"] == 48
    assert port["collective_bytes_per_device"] < 1e7


def test_dryrun_kv_seq_shard_argument_bytes_equal_jax_shards(dryruns):
    """tinyllama x decode_32k with kv_seq_shard on 16 x 16: 4 KV heads do
    not divide the model axis, so the caches' 32k positions go over it;
    the port's argument bytes equal JAX's shards of the same layout, 1/16
    of the caches' bytes without the option."""
    port, plain, jx = dryruns["PORT"][4], dryruns["PORT"][0], dryruns["JAX"]
    assert port["ok"] and port["opt"] == "kv_seq_shard" and port["mesh"] == "16x16"
    got = port["memory_analysis"]["argument_size_in_bytes"]
    assert got == jx["shard_bytes_kv_seq_shard"]
    assert got < plain["memory_analysis"]["argument_size_in_bytes"]
    print(f"argument bytes with kv_seq_shard: {got} (without: "
          f"{plain['memory_analysis']['argument_size_in_bytes']}); collective bytes "
          f"{port['collective_bytes_per_device']:.6g}, {port['collective_counts']}")


# ---------------------------------------------------------------------------
# the kernel ops' meta route
# ---------------------------------------------------------------------------
def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


OPS = {
    "flash_attention": (lambda: flash_attention(_meta(2, 8, 16, 64), _meta(2, 2, 24, 64),
                                                _meta(2, 2, 24, 64)), (2, 8, 16, 64)),
    "flash_attention_op": (lambda: flash_attention_op(_meta(2, 16, 8, 64), _meta(2, 24, 2, 64),
                                                      _meta(2, 24, 2, 64)), (2, 16, 8, 64)),
    "decode_attention": (lambda: decode_attention(_meta(2, 8, 64), _meta(2, 2, 24, 64),
                                                  _meta(2, 2, 24, 64), 10), (2, 8, 64)),
    "decode_attention_op": (lambda: decode_attention_op(
        _meta(2, 1, 8, 64), _meta(2, 24, 2, 64), _meta(2, 24, 2, 64), 10), (2, 1, 8, 64)),
    "ssd_chunk": (lambda: ssd_chunk(_meta(4, 2, 32, 16), _meta(4, 2, 32, dtype=torch.float32),
                                    _meta(4, 2, 32, 8), _meta(4, 2, 32, 8))[0], (4, 2, 32, 16)),
    "ssd_chunk_op": (lambda: ssd_chunk_op(_meta(2, 40, 4, 16), _meta(2, 40, 4, dtype=torch.float32),
                                          _meta(2, 40, 1, 8), _meta(2, 40, 1, 8), 32)[0],
                     (2, 40, 4, 16)),
    "ssd_op": (lambda: ssd_op(_meta(2, 40, 4, 16), _meta(2, 40, 4, dtype=torch.float32),
                              _meta(2, 40, 1, 8), _meta(2, 40, 1, 8), 32)[0], (2, 40, 4, 16)),
    "relay_assemble": (lambda: relay_assemble(_meta(6, 128), _meta(6, dtype=torch.int32)),
                       (6, 128)),
}


def _no_build(*a, **k):
    raise AssertionError("the meta route reached the kernel build")


@pytest.mark.parametrize("name", sorted(OPS))
def test_kernel_ops_take_the_meta_route(name):
    call, shape = OPS[name]
    with mock.patch.object(build, "library", _no_build), \
            mock.patch.object(build, "build", _no_build):
        out = call()
    assert out.device.type == "meta" and tuple(out.shape) == shape


def test_flash_attention_gradient_on_meta():
    q, k, v = (_meta(1, 16, 4, 32).requires_grad_(), _meta(1, 16, 2, 32).requires_grad_(),
               _meta(1, 16, 2, 32).requires_grad_())
    with mock.patch.object(build, "library", _no_build):
        dq, dk, dv = torch.autograd.grad(flash_attention_op(q, k, v).sum(), (q, k, v))
    assert [t.device.type for t in (dq, dk, dv)] == ["meta"] * 3
    assert (dq.shape, dk.shape) == (q.shape, k.shape)


def _elsewhere(*shape, dtype=torch.bfloat16):
    """A tensor on a device that is neither the CPU, a CUDA card nor meta."""
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode

    return FakeTensor(FakeTensorMode(), _meta(*shape, dtype=dtype), torch.device("xpu"))


@pytest.mark.parametrize("call", [
    lambda: flash_attention(_elsewhere(1, 2, 4, 8), _elsewhere(1, 1, 4, 8),
                            _elsewhere(1, 1, 4, 8)),
    lambda: decode_attention_op(_elsewhere(1, 1, 2, 8), _elsewhere(1, 4, 1, 8),
                                _elsewhere(1, 4, 1, 8), 2),
    lambda: ssd_chunk_op(_elsewhere(1, 8, 2, 4), _elsewhere(1, 8, 2, dtype=torch.float32),
                         _elsewhere(1, 8, 1, 4), _elsewhere(1, 8, 1, 4), 8),
    lambda: relay_assemble(_elsewhere(2, 4), _elsewhere(2, dtype=torch.int32)),
], ids=["flash_attention", "decode_attention_op", "ssd_chunk_op", "relay_assemble"])
def test_kernel_ops_refuse_other_devices(call):
    with pytest.raises(ValueError, match="unsupported device"):
        call()
