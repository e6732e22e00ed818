"""The port's transfer engine (repro_torch.core) against the JAX package's:
the word-for-word copies, the simulator's timings, and the functional
data plane (TorchBackend) on CPU devices — bit-exact, with the same chunk
and route sequence as the JAX data plane."""
import dataclasses
import inspect
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

import repro.core as jcore
import repro.serving.engine as jserving_engine
import repro_torch.core as tcore
import repro_torch.serving.engine as tserving_engine
from repro_torch.core.torch_backend import ChunkAssembler, HostPayload

SRC = Path(__file__).resolve().parents[1] / "src"
CPU = torch.device("cpu")

# Modules copied word for word from src/repro into src/repro_torch.
VERBATIM = [
    *(f"core/{m}.py" for m in (
        "config", "topology", "transfer_task", "path_selector", "simlink",
        "task_launcher", "sync_engine", "streams", "engine")),
    *(f"obs/{m}.py" for m in ("__init__", "tracer", "metrics", "export",
                              "attribution")),
    *(f"kvstore/{m}.py" for m in ("__init__", "hashing", "radix", "tiers",
                                  "store")),
    *(f"serving/{m}.py" for m in ("kv_cache", "scheduler", "report",
                                  "batching", "orchestrator", "disagg")),
    "workloads/__init__.py", "workloads/generator.py",
    "training/data.py",
    *(f"configs/{p.name}" for p in sorted((SRC / "repro/configs").glob("*.py"))
      if p.name != "base.py"),
]


def _imports_renamed(text: str) -> str:
    """The only change a copy may make: ``repro`` -> ``repro_torch`` in
    absolute imports (the copied modules use relative imports)."""
    out = []
    for line in text.splitlines(keepends=True):
        s = line.lstrip()
        if s.startswith(("from repro.", "import repro.", "from repro ",
                         "import repro ")):
            line = line.replace("repro", "repro_torch", 1)
        out.append(line)
    return "".join(out)


@pytest.mark.parametrize("rel", VERBATIM)
def test_copied_module_equals_its_source(rel):
    src = (SRC / "repro" / rel).read_text()
    dst = (SRC / "repro_torch" / rel).read_text()
    assert dst == _imports_renamed(src)


def test_config_base_differs_only_in_dtypes():
    src = (SRC / "repro/configs/base.py").read_text()
    dst = (SRC / "repro_torch/configs/base.py").read_text()
    want = (src.replace("import jax.numpy as jnp\n", "import torch\n")
            .replace("jnp.bfloat16", "torch.bfloat16")
            .replace("jnp.float32", "torch.float32"))
    assert dst == want


def test_core_exports_match_with_torch_backend():
    want = [n if n != "JaxBackend" else "TorchBackend" for n in jcore.__all__]
    assert tcore.__all__ == want
    for name in tcore.__all__:
        assert hasattr(tcore, name)


def test_latency_model_is_copied_as_it_is():
    for name in ("LatencyModel", "TTFTBreakdown"):
        assert inspect.getsource(getattr(tserving_engine, name)) == \
            inspect.getsource(getattr(jserving_engine, name))
    for name in ("H20_BF16_TFLOPS", "H20_HBM_GBPS", "COMPUTE_EFF", "DECODE_EFF"):
        assert getattr(tserving_engine, name) == getattr(jserving_engine, name)


# ---------------------------------------------------------------------------
# Simulator parity: identical timings and route counts
# ---------------------------------------------------------------------------
def _mixed_scenario(core, qos: bool):
    cfg = core.MMAConfig(qos_enabled=qos)
    eng, world, _ = core.make_sim_engine(config=cfg)
    GB = core.GB
    TC = core.TrafficClass
    tasks = [
        eng.memcpy(2 * GB, device=0, direction=core.Direction.H2D,
                   spec=core.TransferSpec(traffic_class=TC.THROUGHPUT)),
        eng.memcpy(GB, device=3, direction=core.Direction.D2H,
                   spec=core.TransferSpec(traffic_class=TC.BACKGROUND)),
        eng.memcpy(GB // 16, device=0, direction=core.Direction.H2D,
                   spec=core.TransferSpec(traffic_class=TC.LATENCY,
                                          deadline=0.05)),
    ]
    world.run()
    return (
        [t.elapsed for t in tasks],
        [(d, w.chunks_direct, w.chunks_relay)
         for d, w in sorted(eng.workers.items())],
    )


@pytest.mark.parametrize("qos", [True, False])
def test_sim_engine_timings_equal_jax_package(qos):
    j_elapsed, j_workers = _mixed_scenario(jcore, qos)
    t_elapsed, t_workers = _mixed_scenario(tcore, qos)
    assert t_elapsed == j_elapsed
    assert t_workers == j_workers
    assert sum(r for _, _, r in t_workers) > 0   # the mix did use relays


# ---------------------------------------------------------------------------
# TorchBackend: bit-exact data plane on CPU devices
# ---------------------------------------------------------------------------
def _engine(n=1, **cfg):
    return tcore.make_functional_engine(
        devices=[CPU] * n,
        config=tcore.MMAConfig(fallback_bytes=0, **cfg),
    )


@pytest.mark.parametrize("dtype", [np.float32, np.float16, np.int32, np.int8])
@pytest.mark.parametrize("shape", [(64,), (33, 7), (4, 5, 6), (1,)])
def test_h2d_bit_exact(dtype, shape):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(shape) * 10).astype(dtype)
    y = tcore.multipath_device_put(x, target=0, engine=_engine(chunk_bytes=64))
    assert y.dtype == torch.from_numpy(x).dtype and tuple(y.shape) == shape
    assert np.array_equal(y.numpy(), x)


@pytest.mark.parametrize("target", [0, 1])
def test_d2h_bit_exact(target):
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((129, 65)).astype(np.float32))
    back = tcore.multipath_device_get(
        x, target=target, engine=_engine(2, chunk_bytes=1024)
    )
    assert torch.equal(back, x) and back.data_ptr() != x.data_ptr()


def test_bf16_tensor_round_trip_through_relays():
    x = torch.randn(3000, generator=torch.Generator().manual_seed(0)).to(
        torch.bfloat16)
    eng = _engine(4, chunk_bytes=256, direct_priority=False)
    y = tcore.multipath_device_put(x, target=1, engine=eng)
    z = tcore.multipath_device_get(y, target=1, engine=eng)
    assert torch.equal(y.view(torch.int16), x.view(torch.int16))
    assert torch.equal(z.view(torch.int16), x.view(torch.int16))


def test_relay_paths_actually_used_and_exact():
    eng = _engine(4, chunk_bytes=256, direct_priority=False)
    x = np.arange(10_000, dtype=np.float32)
    y = tcore.multipath_device_put(x, target=1, engine=eng)
    assert np.array_equal(y.numpy(), x)
    assert sum(w.chunks_relay for w in eng.workers.values()) > 0


def test_odd_sizes_and_chunk_alignment():
    for n in (1, 7, 1023, 4096, 10_001):
        x = np.random.default_rng(n).standard_normal(n).astype(np.float32)
        y = tcore.multipath_device_put(x, engine=_engine(chunk_bytes=4096))
        assert np.array_equal(y.numpy(), x)


def test_thousands_of_chunks_complete_inline():
    """Each chunk's on_done pulls the next; the backend drains them in a
    loop, so 3000 chunks (a 1 GiB wake at 1 MiB chunks is ~1000) complete
    within Python's default depth, and the interpreter's limit is left
    alone."""
    import sys

    limit = sys.getrecursionlimit()
    x = np.arange(3000 * 16, dtype=np.uint8)
    eng = _engine(2, chunk_bytes=16)
    launch = eng.backend.launch
    seen = []
    eng.backend.launch = lambda *a: (seen.append(sys.getrecursionlimit()),
                                     launch(*a))[1]
    y = tcore.multipath_device_put(x, engine=eng)
    assert np.array_equal(y.numpy(), x)
    z = tcore.multipath_device_get(y, engine=eng)
    assert np.array_equal(z.numpy(), x)
    assert len(seen) == 6000 and set(seen) == {limit}
    assert sys.getrecursionlimit() == limit


def test_chunk_alignment_leaves_engine_config_alone():
    """The port aligns a local copy of the chunk size; the JAX package's
    helper overwrites the caller's engine config."""
    x = np.arange(5000, dtype=np.float32)
    eng = _engine(chunk_bytes=1001)
    y = tcore.multipath_device_put(x, engine=eng)
    assert np.array_equal(y.numpy(), x)
    assert tcore.multipath_device_get(y, engine=eng).numpy().tolist() == x.tolist()
    assert eng.config.chunk_bytes == 1001
    jeng = jcore.make_functional_engine(
        config=jcore.MMAConfig(chunk_bytes=1001, fallback_bytes=0))
    jcore.multipath_device_put(x, engine=jeng)
    assert jeng.config.chunk_bytes == 1000


def test_assembler_restores_logical_order():
    a = ChunkAssembler(3, CPU, chunk_elems=4, dtype=torch.int32)
    for seq in (2, 0, 1):            # landing order
        a.land(seq, 4 if seq < 2 else 2).copy_(
            torch.arange(seq * 4, seq * 4 + (4 if seq < 2 else 2)))
    assert a.perm == [1, 2, 0]
    assert torch.equal(a.result((10,)), torch.arange(10, dtype=torch.int32))


def test_thread_stream_end_to_end_async_copy():
    """memcpy_async through a ThreadStream: downstream reads assembled data."""
    eng = _engine(chunk_bytes=2048)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(5000)
                         .astype(np.float32))
    payload = HostPayload(flat=x, shape=tuple(x.shape), dtype=x.dtype)
    assembler = ChunkAssembler(eng.config.n_chunks(x.numel() * 4), CPU,
                               2048 // 4, torch.float32)
    dummy = eng.memcpy_async(x.numel() * 4, device=0,
                             direction=tcore.Direction.H2D, src=payload,
                             dst=assembler)
    results = {}
    stream = tcore.ThreadStream("io")
    stream.dummy(dummy)
    stream.run(lambda: results.setdefault(
        "y", assembler.result(tuple(x.shape), x.dtype)))
    stream.synchronize()
    assert torch.equal(results["y"], x)
    stream.close()


# ---------------------------------------------------------------------------
# Route cross-check against the JAX data plane
# ---------------------------------------------------------------------------
def _record_routes(eng):
    log = []
    launch = eng.backend.launch

    def recording(mt, route, on_done):
        log.append((mt.direction.name, mt.seq, mt.offset, mt.nbytes,
                    route.link_dev, route.dest))
        return launch(mt, route, on_done)

    eng.backend.launch = recording
    return log


@pytest.mark.parametrize("target,direct_priority", [(0, True), (1, False)])
def test_same_bytes_and_routes_as_jax_data_plane(target, direct_priority):
    x = np.random.default_rng(3).standard_normal(20_000).astype(np.float32)
    kw = dict(chunk_bytes=4096, fallback_bytes=0, direct_priority=direct_priority)
    jeng = jcore.make_functional_engine(
        devices=[jax.devices()[0]] * 4, config=jcore.MMAConfig(**kw))
    teng = tcore.make_functional_engine(
        devices=[CPU] * 4, config=tcore.MMAConfig(**kw))
    jlog, tlog = _record_routes(jeng), _record_routes(teng)
    jy = jcore.multipath_device_put(x, target=target, engine=jeng)
    ty = tcore.multipath_device_put(x, target=target, engine=teng)
    assert np.asarray(jy).tobytes() == ty.numpy().tobytes()
    jz = jcore.multipath_device_get(jy, target=target, engine=jeng)
    tz = tcore.multipath_device_get(ty, target=target, engine=teng)
    assert jz.tobytes() == tz.numpy().tobytes() == x.tobytes()
    assert tlog == jlog
    relays = sum(1 for *_, link, dest in tlog if link != dest)
    assert (relays > 0) == (not direct_priority)
