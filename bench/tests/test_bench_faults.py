"""A run driven on the CPU at a tiny size with the timed path broken
underneath must come out not correct, once for each fault the cells can
have: a served token altered where it is produced, a step that returns
its state unchanged (a prefill answering with the previous request's
logits; a wake that does not move the weights), and a chunk altered in
flight. The limits are the committed ones (``bench/workloads``); the
look for a card is skipped (``run_cell``)."""
from unittest import mock

import pytest
import torch

import run as bench_run
import tiny


def cpu_run(cell, seconds=2.0, seed=2**31 + 99):
    return bench_run.run_cell(cell, seed, seconds, False, "cpu",
                              cfg_override=tiny.for_cell(cell), mix_override=tiny.MIX)


def limits_known(cell):
    lim = bench_run.read_json(bench_run.BENCH / "workloads" / f"{cell}.json")["limits"]
    if any(v is None for v in lim.values()):
        pytest.skip(f"{cell}: limits not set yet")


@pytest.mark.parametrize("cell", ["olmoe.prefix-docs", "olmoe.switch"])
def test_sound_run_is_correct(cell):
    limits_known(cell)
    res = cpu_run(cell)
    assert res["correct"], res["checks"]
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[-2] == "checks"


@pytest.mark.parametrize("cell", ["olmoe.prefix-docs", "olmoe.switch"])
def test_token_altered_where_produced(cell):
    limits_known(cell)
    import repro_torch.serving.engine as engine

    real = engine.prefill

    def altered(*a, **kw):
        logits, caches, n = real(*a, **kw)
        return logits.roll(1, dims=-1), caches, n

    with mock.patch.object(engine, "prefill", altered):
        res = cpu_run(cell)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell", ["olmoe.prefix-docs", "olmoe.switch"])
def test_prefill_returns_stale_state(cell):
    limits_known(cell)
    import repro_torch.serving.engine as engine

    real, last = engine.prefill, []

    def stale(*a, **kw):
        out = real(*a, **kw)
        prev = last[0] if last else out[0]
        last[:] = [out[0]]
        return (prev,) + tuple(out[1:])

    with mock.patch.object(engine, "prefill", stale):
        res = cpu_run(cell)
    assert not res["correct"], res["checks"]


def test_wake_leaves_the_weights_unmoved():
    limits_known("olmoe.switch")
    import repro_torch.serving.weight_manager as wm

    def unmoved(arr, *a, **kw):
        return torch.zeros_like(arr)

    with mock.patch.object(wm, "multipath_device_put", unmoved):
        res = cpu_run("olmoe.switch")
    assert not res["correct"], res["checks"]
    assert res["checks"]["weight_leaves_differ"]["value"] > 0


def test_chunk_altered_in_flight():
    limits_known("olmoe.switch")
    import repro_torch.core.torch_backend as tb

    real = tb.relay_assemble

    def altered(slab, perm):
        out = real(slab, perm)
        if out.numel() > 4:
            out.view(-1)[3] += 1
        return out

    with mock.patch.object(tb, "relay_assemble", altered):
        res = cpu_run("olmoe.switch")
    assert not res["correct"], res["checks"]
