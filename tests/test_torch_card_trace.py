"""The card path's tracer (``repro_torch.obs.card``) on the CPU: off it
costs no range, row or wait; on, its host-nested spans agree with
kineto's host events, a request's spans form one tree, the MoE channel
gives three stage spans a layer, a sleep and a wake carry the chunks the
engine's ledgers counted, and the simulator's spans stay out of its ring."""
import time
from collections import Counter, defaultdict

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.configs import get_config
from repro_torch.core import MMAConfig, make_functional_engine
from repro_torch.core.torch_backend import multipath_device_get
from repro_torch.models import init_params
from repro_torch.obs import card
from repro_torch.serving import FunctionalServer, WeightManager
from repro_torch.tree import tree_leaves, tree_map

CPU = torch.device("cpu")
CFG = get_config("olmoe-1b-7b").reduced()            # 2 layers, every one MoE
MOE_LAYERS = sum(i % CFG.moe_every == CFG.moe_offset for i in range(CFG.n_layers))
STAGES = ("mma.moe.route", "mma.moe.experts", "mma.moe.combine")


@pytest.fixture
def tracer():
    """A card tracer in place for the test, and none after it."""
    tr = card.install()
    yield tr
    card.uninstall()


@pytest.fixture(scope="module")
def params():
    return init_params(CFG, torch.Generator().manual_seed(0), CPU)


def _serve(params, lengths, seed=0):
    srv = FunctionalServer(CFG, params=params, max_running=2, max_len=128, device=CPU)
    rng = np.random.default_rng(seed)
    reqs = [srv.submit(rng.integers(0, CFG.vocab, size=n), max_new_tokens=2)
            for n in lengths]
    srv.run_until_done()
    return reqs


def _engine():
    return make_functional_engine([CPU], MMAConfig(chunk_bytes=1 << 14, fallback_bytes=0))


def _switch(params, eng=None):
    eng = eng or _engine()
    wm = WeightManager(eng, params=tree_map(torch.clone, params))
    wm.sleep()
    wm.wake()
    return eng, wm


def _ledger(eng) -> int:
    return sum(w.chunks_direct + w.chunks_relay for w in eng.workers.values())


def _kineto_name(row) -> str:
    """The range kineto shows for a ring row: the engine's task spans are
    named by direction."""
    if row.cat == "transfer":
        return f"mma.xfer.{row.args['direction'].lower()}"
    return row.name


def test_off_costs_no_range_no_row_and_no_wait(params, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("called while the card tracer is off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    idle = card.CardTracer()                 # made, never put in place
    card.uninstall()
    _serve(params, [20, 33])
    eng, _ = _switch(params)
    with card.span("mma.xfer.wait") as sp:
        assert sp is None
    card.count("mma.moe.tokens", 5)
    assert eng.backend.tracer is obs.NULL_TRACER
    assert len(idle) == 0 and idle.all_spans() == []


def test_ring_rows_agree_with_kineto_host_events(params, tracer):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracer.span("mma.warm"):
            pass
        _serve(params, [24, 40])
        _switch(params)
    # the ranged rows: host-nested spans and the engine's task spans (not
    # requests, counters, or the link workers' chunk rows)
    rows = [s for s in tracer.all_spans()
            if (s.track == "card:host" or s.cat == "transfer") and s.name != "mma.warm"]
    host = defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("mma.") and e.name() != "mma.warm":
            host[e.name()].append((e.start_ns(), e.start_ns() + e.duration_ns()))
    ring = defaultdict(list)
    for s in rows:
        ring[_kineto_name(s)].append((tracer.kineto_ns(s.t0), tracer.kineto_ns(s.t1)))
    assert {"mma.serve.prefill", "mma.kv.fetch", "mma.kv.offload", "mma.moe",
            *STAGES, "mma.weights.sleep", "mma.weights.wake", "mma.xfer.d2h",
            "mma.xfer.h2d"} <= set(ring)
    assert set(ring) == set(host)
    for name, spans in ring.items():
        assert len(spans) == len(host[name]), name
        for (r0, r1), (k0, k1) in zip(sorted(spans), sorted(host[name])):
            assert abs(r0 - k0) < 1_000_000 and abs(r1 - k1) < 1_000_000, name
    base = host["mma.moe"][0][0]
    first = tracer.all_spans()[0]
    assert tracer.on_kineto_clock(base)[0].t0 == pytest.approx(
        (tracer.kineto_ns(first.t0) - base) / 1e9, abs=1e-9)


def test_each_request_is_one_tree_with_three_moe_stages_a_layer(params, tracer):
    lengths = [17, 30, 45]
    reqs = _serve(params, lengths)
    spans = tracer.all_spans()
    by_id = {s.span_id: s for s in spans}

    def root_of(s):
        while s.parent_id is not None:
            s = by_id[s.parent_id]
        return s

    for req, n in zip(reqs, lengths):
        mine = [s for s in spans if s.args.get("req_id") == req.req_id]
        roots = [s for s in mine if s.name == "mma.req"]
        assert len(roots) == 1 and roots[0].parent_id is None
        root = roots[0]
        tree = [s for s in mine if s.name != "mma.kv.offload"]
        assert all(root_of(s) is root for s in tree)
        names = Counter(s.name for s in tree)
        assert names["mma.req.queue"] == names["mma.serve.prefill"] == 1
        assert names["mma.kv.fetch"] == 1
        assert names["mma.moe"] == MOE_LAYERS
        assert all(names[st] == MOE_LAYERS for st in STAGES)
        queue = next(s for s in tree if s.name == "mma.req.queue")
        prefill = next(s for s in tree if s.name == "mma.serve.prefill")
        assert root.t0 == queue.t0 <= queue.t1 <= prefill.t0 < prefill.t1 <= root.t1
        for st in (s for s in tree if s.name in STAGES):
            assert by_id[st.parent_id].name == "mma.moe"
    tokens = [s for s in spans if s.name == "mma.moe.tokens"]
    assert [s.cat for s in tokens] == ["counter"] * len(tokens)
    # prefills only: each decode step routes one token a layer
    prefill_tokens = sum(s.args["value"] for s in tokens if s.args["value"] > 1)
    assert prefill_tokens == MOE_LAYERS * sum(lengths)


def test_sleep_and_wake_carry_their_tasks_and_the_ledgers_chunks(params, tracer):
    eng = _engine()
    multipath_device_get(torch.zeros(1 << 14), engine=eng)     # the ledgers start at 4
    before = _ledger(eng)
    eng, wm = _switch(params, eng)
    spans = tracer.all_spans()
    leaves = len(tree_leaves(wm.params))
    total = 0
    for name, direction in (("mma.weights.sleep", "D2H"), ("mma.weights.wake", "H2D")):
        (top,) = [s for s in spans if s.name == name]
        tasks = [s for s in spans if s.cat == "transfer" and s.parent_id == top.span_id]
        assert len(tasks) == leaves
        assert {s.args["direction"] for s in tasks} == {direction}
        assert all(top.t0 <= s.t0 <= s.t1 <= top.t1 for s in tasks)
        assert top.args["chunks"] > leaves
        total += top.args["chunks"]
    assert before == 4 and total == _ledger(eng) - before


def test_a_cpu_get_pins_nothing_and_waits_on_nothing(tracer):
    eng = make_functional_engine([CPU])
    out = multipath_device_get(torch.arange(1000, dtype=torch.float32), engine=eng)
    assert torch.equal(out, torch.arange(1000, dtype=torch.float32))
    names = {s.name for s in tracer.all_spans()}
    assert "mma.xfer.pin" not in names and "mma.xfer.wait" not in names


def test_simulator_spans_stay_out_of_the_card_ring(params, tracer):
    sim = obs.install(obs.Tracer())
    try:
        # the same document twice: the second request hits the prefix cache
        srv = FunctionalServer(CFG, params=params, max_running=1, max_len=128,
                               device=CPU)
        doc = np.arange(64) % CFG.vocab
        for _ in range(2):
            srv.submit(doc, max_new_tokens=1)
            srv.run_until_done()
    finally:
        obs.uninstall()
    assert any(s.cat == "transfer" for s in sim.all_spans())
    rows = tracer.all_spans()
    assert rows and all(s.name.startswith("mma.") for s in rows)
    assert not any(s.cat == "transfer" for s in rows)
    now = time.monotonic()
    assert all(now - 60 < s.t0 <= now for s in rows)
