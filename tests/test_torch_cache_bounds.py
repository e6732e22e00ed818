"""The linear KV cache's bounds in the port against the JAX package, on
the same weights (``params_from_jax``), fp32, reduced TinyLlama, W = 16.

Up to the last slot both packages agree (logits and caches at 2e-4).
Past it they part:

* a prefill longer than the cache: JAX's ``dynamic_update_slice`` raises
  ``TypeError``; the port raises ``ValueError`` before any write;
* a decode step at a full cache (``cache_len == W``): JAX clamps the slot
  and overwrites the last position's K/V without a word; the port raises
  ``ValueError`` (the clamp is a fault of the reference, not a behaviour
  to copy);
* a request whose last decode step would write past ``max_len``: JAX's
  server takes it and returns tokens from the clamped cache; the port's
  refuses it at ``submit``.

The ring buffer (``window`` > 0) wraps by design and goes on matching JAX
past W. The same bounds on 8 ``gloo`` ranks (with and without
``kv_seq_shard``) are in tests/test_torch_distributed.py.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

import repro.models as jm
import repro.serving as jserving
from repro.configs import get_config as jax_config
from repro_torch.configs import get_config
from repro_torch.models import decode_step, params_from_jax, prefill
from repro_torch.serving import FunctionalServer

CPU = torch.device("cpu")
W = 16
TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(scope="module")
def pair():
    """(jax cfg, port cfg, jax params, port params) on the same weights."""
    jcfg = dataclasses.replace(jax_config("tinyllama-1.1b").reduced(), dtype=jnp.float32)
    tcfg = get_config("tinyllama-1.1b").reduced()
    jp = jm.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, params_from_jax(jax.tree.map(np.asarray, jp), tcfg, CPU)


def _tokens(cfg, S, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (2, S)).astype(np.int32)


def _assert_caches_close(tc, jc):
    for t, j in zip(tc, jc):
        for name in ("k", "v"):
            np.testing.assert_allclose(t[name].numpy(), np.asarray(j[name]), **TOL)


@pytest.mark.parametrize("S", [W - 1, W])
def test_prefill_up_to_the_cache_matches_jax(pair, S):
    jcfg, tcfg, jp, tp = pair
    toks = _tokens(jcfg, S)
    jl, jc, jn = jm.prefill(jp, jnp.asarray(toks), jcfg, max_len=W)
    tl, tc, tn = prefill(tp, torch.from_numpy(toks).long(), tcfg, max_len=W)
    assert tn == int(jn) == S
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _assert_caches_close(tc, jc)


def test_prefill_past_the_cache_raises_in_both(pair):
    jcfg, tcfg, jp, tp = pair
    toks = _tokens(jcfg, W + 1)
    with pytest.raises(TypeError, match="dynamic_update_slice"):
        jm.prefill(jp, jnp.asarray(toks), jcfg, max_len=W)
    with pytest.raises(ValueError, match=f"prefill of {W + 1} positions .* of {W}"):
        prefill(tp, torch.from_numpy(toks).long(), tcfg, max_len=W)


@pytest.mark.parametrize("cache_len", [W - 2, W - 1])
def test_decode_up_to_the_last_slot_matches_jax(pair, cache_len):
    """Decode steps from ``cache_len`` to the last slot (W - 1): the logits
    and the written caches equal JAX's."""
    jcfg, tcfg, jp, tp = pair
    toks = _tokens(jcfg, W)
    jl, jc, jn = jm.prefill(jp, jnp.asarray(toks[:, :cache_len]), jcfg, max_len=W)
    tl, tc, tn = prefill(tp, torch.from_numpy(toks[:, :cache_len]).long(), tcfg,
                         max_len=W)
    for i in range(cache_len, W):
        jl, jc = jm.decode_step(jp, jnp.asarray(toks[:, i]), jc, jn, jcfg)
        tl, tc = decode_step(tp, torch.from_numpy(toks[:, i]).long(), tc, tn, tcfg)
        jn, tn = jn + 1, tn + 1
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _assert_caches_close(tc, jc)


def test_decode_at_a_full_cache_raises_where_jax_clamps(pair):
    """At ``cache_len == W`` the port raises and leaves the cache as it
    was; JAX's step runs, its clamped write overwriting the last slot."""
    jcfg, tcfg, jp, tp = pair
    toks = _tokens(jcfg, W + 1)
    _, jc, jn = jm.prefill(jp, jnp.asarray(toks[:, :W]), jcfg, max_len=W)
    _, tc, tn = prefill(tp, torch.from_numpy(toks[:, :W]).long(), tcfg, max_len=W)
    before = [c["k"].clone() for c in tc]
    with pytest.raises(ValueError, match=f"cache_len {W} .* of {W}"):
        decode_step(tp, torch.from_numpy(toks[:, W]).long(), tc, tn, tcfg)
    assert all(torch.equal(b, c["k"]) for b, c in zip(before, tc))
    _, jc2 = jm.decode_step(jp, jnp.asarray(toks[:, W]), jc, jn, jcfg)
    last = np.abs(np.asarray(jc2[0]["k"])[:, :, W - 1] - np.asarray(jc[0]["k"])[:, :, W - 1])
    assert last.max() > 1e-3                    # JAX's clamp overwrote the last slot


@pytest.mark.parametrize("steps", [4, 12])
def test_ring_buffer_past_its_size_matches_jax(pair, steps):
    """A sliding window of 8 over a 12-token prompt and ``steps`` more:
    the ring wraps, in both packages alike."""
    jcfg, tcfg, jp, tp = pair
    window, S = 8, 12
    toks = _tokens(jcfg, S + steps)
    jl, jc, jn = jm.prefill(jp, jnp.asarray(toks[:, :S]), jcfg, max_len=W, window=window)
    tl, tc, tn = prefill(tp, torch.from_numpy(toks[:, :S]).long(), tcfg, max_len=W,
                         window=window)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for i in range(S, S + steps):
        jl, jc = jm.decode_step(jp, jnp.asarray(toks[:, i]), jc, jn, jcfg, window=window)
        tl, tc = decode_step(tp, torch.from_numpy(toks[:, i]).long(), tc, tn, tcfg,
                             window=window)
        jn, tn = jn + 1, tn + 1
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _assert_caches_close(tc, jc)


@pytest.mark.parametrize("S,N", [(W, 2), (W - 3, 5), (W + 1, 1)])
def test_server_refuses_a_request_past_max_len(pair, S, N):
    """S + N - 1 > max_len: the last decode step would write past the
    cache, so ``submit`` raises and nothing is queued."""
    _, tcfg, _, tp = pair
    srv = FunctionalServer(tcfg, params=tp, max_len=W, device="cpu")
    with pytest.raises(ValueError, match=f"max_len is {W}"):
        srv.submit(np.arange(S), max_new_tokens=N)
    assert not srv.scheduler.has_work()


@pytest.mark.parametrize("S,N", [(W - 3, 4), (W, 1)])
def test_server_serves_a_request_that_just_fits_as_jax(pair, S, N):
    """S + N - 1 = max_len: the last step writes the last slot; the port's
    tokens equal JAX's server's."""
    jcfg, tcfg, jp, tp = pair
    kw = dict(max_running=1, device_budget_tokens=2048, max_len=W, page_size=4)
    jsrv = jserving.FunctionalServer(jcfg, params=jp, **kw)
    tsrv = FunctionalServer(tcfg, params=tp, device="cpu", **kw)
    prompt = _tokens(jcfg, S)[0]
    jr, tr = jsrv.submit(prompt, max_new_tokens=N), tsrv.submit(prompt, max_new_tokens=N)
    jsrv.run_until_done()
    tsrv.run_until_done()
    assert len(tr.generated) == N and tr.generated == jr.generated
