"""The program's spans in the benchmark: the traced window's reduction
gives the same numbers with the card tracer's ``mma.*`` ranges among its
events, ``spans.reduce_program`` names idle by the innermost program span
with the same total, and each reader of the card tracer's ring (the five
metrics it feeds) on a hand-made run, and against a program without one."""
import importlib.util
from pathlib import Path

import pytest

from benchkit import program
from benchkit.record import Request, Run
from benchkit.spans import innermost, reduce_program
from benchkit.trace import Summary, reduce_events, span_name
from repro_torch.obs import card
from test_bench_trace import Ev

METRICS = Path(__file__).resolve().parents[1] / "metrics"


class CEv(Ev):
    """A kineto event with the correlation id that ties a kernel to its
    launch."""

    def __init__(self, name, start, dur, cpu=False, annotation=False, corr=0):
        super().__init__(name, start, dur, cpu=cpu, annotation=annotation)
        self._c = corr

    def correlation_id(self):
        return self._c


NEW = ("admit_wait_ms", "kv_host_ms", "moe.route_ns_per_token",
       "d2h_copy_share.sleep", "xfer.host_us_per_chunk")
# test_bench_trace's window, each kernel with its launch on the host
BASE = [
    CEv("bench.window", 0, 1000, cpu=True),
    CEv("bench.wake", 100, 400, cpu=True),
    CEv("bench.prefill", 600, 300, cpu=True),
    CEv(span_name("m.f"), 650, 100, cpu=True),
    CEv(span_name("m.f"), 700, 200, annotation=True),
    CEv("cudaMemcpyAsync", 130, 5, cpu=True, corr=1),
    CEv("Memcpy HtoD (Pinned -> Device)", 150, 200, corr=1),
    CEv("cudaLaunchKernel", 660, 5, cpu=True, corr=2),
    CEv("k_a", 700, 50, corr=2),
    CEv("cudaLaunchKernel", 720, 5, cpu=True, corr=3),
    CEv("k_b", 800, 100, corr=3),
    CEv("cudaLaunchKernel", 930, 5, cpu=True, corr=4),
    CEv("k_c", 950, 30, corr=4),
    CEv("bench.prefill", 600, 380, annotation=True),
]
# the program's host ranges; device-side mma.* annotations (as a
# record_function opened by hand would leave) are not work
PROGRAM = [
    CEv("mma.weights.wake", 110, 380, cpu=True),
    CEv("mma.xfer.h2d", 120, 180, cpu=True),
    CEv("mma.xfer.h2d", 150, 200, annotation=True),
    CEv("mma.serve.prefill", 605, 290, cpu=True),
    CEv("mma.moe", 640, 120, cpu=True),
    CEv("mma.moe.route", 650, 50, cpu=True),
    CEv("mma.moe.route", 700, 50, annotation=True),
    CEv("mma.moe", 700, 100, annotation=True),
]
FIELDS = ("window_s", "busy_s", "device_ops", "span_device_s", "span_s", "span_h2d_s",
          "idle_by_host", "n_device_events")


def test_program_spans_leave_the_reduction_as_it_was():
    base, both = reduce_events(BASE), reduce_events(BASE + PROGRAM)
    for f in FIELDS:
        assert getattr(both, f) == getattr(base, f), f
    assert not any(k.startswith("mma.") for k in both.device_ops)


def test_idle_is_named_by_the_innermost_program_span():
    base, prog = reduce_events(BASE), reduce_program(BASE + PROGRAM)
    ns = 1e-9
    # the harness's idle: wake 200, prefill 150, outside every span 270 (of 620)
    assert sum(prog.idle.values()) == pytest.approx(sum(base.idle_by_host.values()))
    assert prog.idle["mma.xfer.h2d"] == pytest.approx(30 * ns)          # 120..150
    assert prog.idle["mma.weights.wake"] == pytest.approx(150 * ns)     # 110..120, 350..490
    assert prog.idle["bench.wake"] == pytest.approx(20 * ns)            # 100..110, 490..500
    assert prog.idle["mma.moe.route"] == pytest.approx(50 * ns)         # 650..700
    assert prog.idle["mma.moe"] == pytest.approx(20 * ns)               # 640..650, 750..760
    assert prog.idle["mma.serve.prefill"] == pytest.approx(75 * ns)     # 605..640, 760..800
    assert prog.idle["bench.prefill"] == pytest.approx(5 * ns)          # 600..605
    assert prog.idle["bench.host"] == pytest.approx(base.idle_by_host["bench.host"])
    assert prog.host_s["mma.weights.wake"] == pytest.approx(380 * ns)
    assert prog.self_s["mma.weights.wake"] == pytest.approx(200 * ns)
    assert prog.h2d_s["mma.xfer.h2d"] == pytest.approx(150 * ns)        # 150..300
    assert prog.h2d_s["mma.weights.wake"] == pytest.approx(200 * ns)
    # kernels by their launch: k_a at 660 in the route, k_b at 720 in mma.moe
    assert prog.device_s["mma.moe.route"] == pytest.approx(50 * ns)
    assert prog.device_s["mma.moe"] == pytest.approx(150 * ns)
    assert prog.device_s["mma.serve.prefill"] == pytest.approx(150 * ns)
    assert prog.device_s["mma.weights.wake"] == 0.0                     # a copy, no kernel
    assert prog.d2h_s["mma.moe"] == 0.0


def test_innermost_pieces_of_nested_spans():
    assert innermost([(0, 10, "a"), (2, 4, "b"), (6, 8, "c"), (12, 13, "d")]) == [
        (0, 2, "a"), (2, 4, "b"), (4, 6, "a"), (6, 8, "c"), (8, 10, "a"), (12, 13, "d")]


@pytest.fixture
def ring():
    """A card tracer in place while the metric files load and read."""
    tr = card.install()
    yield tr
    card.uninstall()


def metric(name):
    spec = importlib.util.spec_from_file_location(name, METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def window_run():
    return Run(sizes={}, seconds=10.0, t0=100.0, t1=110.0)


def test_loading_a_reader_puts_the_card_tracer_in_place():
    card.uninstall()
    try:
        metric("admit_wait_ms")
        assert card.current() is not None
    finally:
        card.uninstall()


def test_admit_wait_and_kv_host_time(ring):
    run = window_run()
    ring.complete("mma.req.queue", "request", "req:0", 90.0, 91.0, req_id=0)   # warm-up
    ring.complete("mma.req.queue", "request", "req:1", 101.0, 101.2, req_id=1)
    ring.complete("mma.req.queue", "request", "req:2", 105.0, 105.4, req_id=2)
    assert metric("admit_wait_ms").read(run) == pytest.approx(300.0)
    ring.complete("mma.kv.fetch", "card", "card:host", 101.5, 101.51)
    ring.complete("mma.kv.fetch", "card", "card:host", 105.5, 105.53)
    ring.complete("mma.kv.offload", "card", "card:host", 106.0, 106.02)
    ring.complete("mma.kv.offload", "card", "card:host", 95.0, 95.5)          # before
    run.requests = [Request(index=i, tokens=[1, 2], issue=100.0 + i, first_token=t,
                            served=s) for i, (t, s) in
                    enumerate([(102.0, 1), (106.0, 1), (107.0, None), (111.0, 1)])]
    assert metric("kv_host_ms").read(run) == pytest.approx(30.0)            # 60 ms, 2


def test_route_ns_per_token(ring):
    run = window_run()
    # (start, card seconds, tokens); the first is before the window
    for t, dev, n in ((99.0, 0.9, 5000), (101.0, 0.1, 1000), (104.0, 0.4, 3000)):
        ring.complete("mma.moe.tokens", "counter", "card:count", t, t, value=n)
        ring.complete("mma.moe.route", "card", "card:host", t, t + 0.01, device_s=dev)
    ring.complete("mma.moe.experts", "card", "card:host", 105.0, 106.0, device_s=1.0)
    assert metric("moe.route_ns_per_token").read(run) == pytest.approx(0.5e9 / 4000)


def test_sleep_d2h_share(ring):
    run = window_run()
    run.summary = Summary()
    run.summary.n_device_events = 3
    run.summary.device_ops.update({"Memcpy DtoH (Device -> Pinned)": 0.8,
                                   "Memcpy DtoH (Device -> Pageable)": 0.1,
                                   "Memcpy HtoD (Pinned -> Device)": 5.0})
    ring.complete("mma.weights.sleep", "card", "card:host", 101.0, 101.5, chunks=9)
    ring.complete("mma.weights.sleep", "card", "card:host", 103.0, 103.5, chunks=9)
    assert metric("d2h_copy_share.sleep").read(run) == pytest.approx(80.0)


def test_host_us_per_chunk(ring):
    run = window_run()
    ring.complete("task1", "transfer", "engine:engine", 101.0, 101.1, direction="D2H")
    ring.complete("mma.xfer.pin", "card", "card:host", 101.0, 101.05)
    ring.complete("task2", "transfer", "engine:engine", 102.0, 102.2, direction="H2D")
    ring.complete("mma.xfer.wait", "card", "card:host", 103.0, 103.5)       # outside tasks
    ring.complete("chunk", "chunk", "worker:0", 101.0, 101.01)
    ring.complete("mma.weights.sleep", "card", "card:host", 100.5, 101.6, chunks=100)
    ring.complete("mma.weights.wake", "card", "card:host", 101.9, 103.6, chunks=150)
    assert metric("xfer.host_us_per_chunk").read(run) == pytest.approx(1e6 * 0.25 / 250)


def test_a_program_without_the_card_tracer_reads_nothing(ring, monkeypatch):
    run = window_run()
    run.summary = Summary()
    run.summary.n_device_events = 1
    run.summary.device_ops["Memcpy DtoH (Device -> Pinned)"] = 1.0
    ring.complete("mma.weights.sleep", "card", "card:host", 101.0, 102.0, chunks=1)
    mods = [metric(n) for n in NEW]
    monkeypatch.setattr(program, "_card", lambda: None)
    assert program.tracer() is None
    assert [m.read(run) for m in mods] == [None] * len(NEW)
