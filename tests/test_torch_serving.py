"""The port's serving layer (repro_torch.serving) against the JAX
package's: the functional server on the same weights and prompts, and the
weight manager's sleep/wake through the torch data plane."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

import repro.serving as jserving
from repro.configs import get_config as jax_config
from repro.models import init_params as jax_init
from repro_torch.configs import get_config
from repro_torch.core import MMAConfig, make_functional_engine, make_sim_engine
from repro_torch.models import init_params, params_from_jax
from repro_torch.serving import FunctionalServer, LatencyModel, WeightManager
from repro_torch.tree import tree_leaves

CPU = torch.device("cpu")


def _serve_repeat(srv, vocab):
    """test_functional_server_prefix_hit_on_repeat's scenario."""
    prompt = np.random.default_rng(0).integers(0, vocab, size=64)
    r1 = srv.submit(prompt, max_new_tokens=3)
    srv.run_until_done()
    r2 = srv.submit(prompt, max_new_tokens=3)
    srv.run_until_done()
    return r1, r2


def test_functional_server_matches_jax_server():
    jcfg = jax_config("tinyllama-1.1b").reduced()
    tcfg = get_config("tinyllama-1.1b").reduced()
    jp = jax_init(jax.random.PRNGKey(0), jcfg)
    kw = dict(max_running=1, device_budget_tokens=2048, max_len=128, page_size=16)
    jsrv = jserving.FunctionalServer(jcfg, params=jp, **kw)
    tsrv = FunctionalServer(
        tcfg, params=params_from_jax(jax.tree.map(np.asarray, jp), tcfg, CPU),
        device="cpu", **kw,
    )
    j1, j2 = _serve_repeat(jsrv, jcfg.vocab)
    t1, t2 = _serve_repeat(tsrv, tcfg.vocab)
    assert [t1.generated, t2.generated] == [j1.generated, j2.generated]
    assert [t1.hit_tokens, t2.hit_tokens] == [j1.hit_tokens, j2.hit_tokens]
    assert t2.hit_tokens >= 48 and t1.generated == t2.generated
    assert tsrv.transfer_log == jsrv.transfer_log
    assert t1.ttft > 0 and t2.ttft > 0


def test_functional_server_continuous_batching_on_cpu():
    """More requests than running slots: all finish, in FCFS order."""
    cfg = get_config("tinyllama-1.1b").reduced()
    srv = FunctionalServer(cfg, max_running=2, max_len=64, device="cpu")
    rng = np.random.default_rng(1)
    reqs = [srv.submit(rng.integers(0, cfg.vocab, size=n), max_new_tokens=4)
            for n in (20, 12, 20, 8)]
    done = srv.run_until_done()
    assert [r.req_id for r in done] == [r.req_id for r in reqs]
    assert all(len(r.generated) == 4 for r in reqs)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_weight_manager_round_trip_is_exact(dtype):
    import dataclasses

    cfg = dataclasses.replace(get_config("tinyllama-1.1b").reduced(), dtype=dtype)
    params = init_params(cfg, torch.Generator().manual_seed(0), CPU)
    before = [t.clone() for t in tree_leaves(params)]
    eng = make_functional_engine(
        devices=[CPU], config=MMAConfig(chunk_bytes=1 << 17, fallback_bytes=0)
    )
    wm = WeightManager(eng, params=params)
    assert wm.nbytes == sum(t.numel() * t.element_size() for t in before)
    rep = wm.sleep()
    assert wm.params is None and wm.state == "asleep" and rep.nbytes == wm.nbytes
    with pytest.raises(AssertionError):
        wm.sleep()   # double sleep is a bug
    wm.wake()
    after = tree_leaves(wm.params)
    assert len(after) == len(before)
    for a, b in zip(before, after):
        assert b.dtype == dtype and torch.equal(a.view(torch.int16 if dtype ==
                                                       torch.bfloat16 else a.dtype),
                                                b.view(torch.int16 if dtype ==
                                                       torch.bfloat16 else b.dtype))


def test_weight_manager_sim_latencies_equal_jax():
    cfg = get_config("qwen3-32b")
    jcfg = jax_config("qwen3-32b")
    ours = [WeightManager(make_sim_engine()[0], nbytes=n) for n in (1 << 30, 3 << 30)]
    theirs = [jserving.WeightManager(jserving_sim(), nbytes=n)
              for n in (1 << 30, 3 << 30)]
    for a, b in zip(ours, theirs):
        assert a.sleep().seconds == b.sleep().seconds
        assert a.wake().seconds == b.wake().seconds
    assert LatencyModel(cfg).model_switch() == \
        jserving.LatencyModel(jcfg).model_switch()


def jserving_sim():
    from repro.core import make_sim_engine as jax_sim

    return jax_sim()[0]
