"""The port's dense transformer (repro_torch.models) against the JAX
package's, on the same weights (converted with ``params_from_jax``), in
fp32 at the reduced (smoke) sizes, plus the port's own prefill/decode vs
forward consistency. On the CPU the attention wrappers run their plain
versions; the K2/K3 kernels themselves are held to those on the card."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

import repro.models as jm
from repro.configs import get_config as jax_config
from repro.configs import ARCHS as JAX_ARCHS, PAPER_MODELS as JAX_PAPER_MODELS
from repro.models.init import abstract_params as jax_abstract_params
from repro.models.init import param_bytes as jax_param_bytes
from repro_torch.configs import ARCHS, PAPER_MODELS, get_config
from repro_torch.models import (
    abstract_params,
    decode_step,
    forward,
    init_params,
    param_bytes,
    params_from_jax,
    prefill,
    tree_bytes,
)
from repro_torch.tree import tree_leaves

CPU = torch.device("cpu")


def _pair(name="tinyllama-1.1b", shape=None, seed=0):
    """(jax cfg, port cfg, jax params, port params) on the same weights."""
    jcfg = dataclasses.replace(jax_config(name, shape).reduced(), dtype=jnp.float32)
    tcfg = get_config(name, shape).reduced()
    assert tcfg.dtype == torch.float32
    jp = jm.init_params(jax.random.PRNGKey(seed), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, CPU)
    return jcfg, tcfg, jp, tp


def _tokens(cfg, B, S, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)).astype(np.int32)


def test_params_from_jax_round_trip_is_exact():
    jcfg = jax_config("tinyllama-1.1b").reduced()       # bf16 at full dtype
    jcfg = dataclasses.replace(jcfg, dtype=jnp.bfloat16)
    jp = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(0), jcfg))
    tcfg = dataclasses.replace(get_config("tinyllama-1.1b").reduced(),
                               dtype=torch.bfloat16)
    tp = params_from_jax(jp, tcfg, CPU)
    jl, tl = jax.tree.leaves(jp), tree_leaves(tp)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert b.dtype == torch.bfloat16 and tuple(b.shape) == a.shape
        assert np.array_equal(a.view(np.uint16), b.view(torch.int16).numpy().view(np.uint16))
    assert tree_bytes(tp) == sum(a.nbytes for a in jl)


@pytest.mark.parametrize("name", ["tinyllama-1.1b", "qwen2-72b", "gemma-7b",
                                  "mamba2-370m", "olmoe-1b-7b",
                                  "llama4-maverick-400b-a17b",
                                  "llama-3.2-vision-90b", "musicgen-large"])
def test_init_params_matches_jax_layout(name):
    """Leaf names, shapes and dtypes in the JAX tree's order, and the JAX
    scales: d^-0.5 for a dense or SSM input projection and the router, and
    E^-0.5 for the stacked expert leaves (JAX takes the first axis of the
    unstacked (E, d_in, d_out) shape)."""
    jcfg = jax_config(name).reduced()
    tcfg = get_config(name).reduced()
    shapes = jax.eval_shape(lambda: jm.init_params(jax.random.PRNGKey(0), jcfg))
    tp = init_params(tcfg, torch.Generator().manual_seed(0), CPU)
    want = [(l.shape, np.dtype(l.dtype).name) for l in jax.tree.leaves(shapes)]
    got = [(tuple(t.shape), str(t.dtype)[6:]) for t in tree_leaves(tp)]
    assert got == want
    for p, (_, channel) in zip(tp["blocks"], tcfg.layer_plan()):
        if channel == "moe":
            E = tcfg.n_experts
            assert p["router"].dtype == torch.float32
            assert p["router"].shape == (tcfg.n_periods, tcfg.d_model, E)
            assert abs(p["router"].std().item() * tcfg.d_model ** 0.5 - 1.0) < 0.05
            for leaf in ("w_gate", "w_up", "w_down"):
                assert p[leaf].dtype == tcfg.dtype
                assert abs(p[leaf].std().item() * E ** 0.5 - 1.0) < 0.05, leaf
        else:
            w = p["w_gate" if tcfg.d_ff else "w_x"]
            assert abs(w.std().item() * tcfg.d_model ** 0.5 - 1.0) < 0.05


@pytest.mark.parametrize("attn_impl", ["xla", "pallas"])
def test_prefill_logits_match_jax(attn_impl):
    jcfg, tcfg, jp, tp = _pair()
    jcfg = dataclasses.replace(jcfg, attn_impl=attn_impl)
    toks = _tokens(jcfg, 2, 32)
    jl, _, jn = jm.prefill(jp, jnp.asarray(toks), jcfg, max_len=48)
    tl, _, tn = prefill(tp, torch.from_numpy(toks).long(), tcfg, max_len=48)
    assert tn == int(jn) == 32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-4, atol=2e-4)


def test_decode_logits_and_greedy_tokens_match_jax():
    jcfg, tcfg, jp, tp = _pair()
    toks = _tokens(jcfg, 2, 24)
    jl, jc, jn = jm.prefill(jp, jnp.asarray(toks), jcfg, max_len=40)
    tl, tc, tn = prefill(tp, torch.from_numpy(toks).long(), tcfg, max_len=40)
    for step in range(8):
        jt = np.argmax(np.asarray(jl), -1).astype(np.int32)
        tt = torch.argmax(tl, -1)
        assert tt.numpy().tolist() == jt.tolist(), f"greedy token differs at {step}"
        jl, jc = jm.decode_step(jp, jnp.asarray(jt), jc, jn, jcfg)
        jn = jn + 1
        tl, tc = decode_step(tp, tt, tc, tn, tcfg)
        tn += 1
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-4,
                                   atol=2e-4, err_msg=f"decode step {step}")
    for jcache, tcache in zip(jc, tc):
        for name in ("k", "v"):
            np.testing.assert_allclose(tcache[name].numpy(),
                                       np.asarray(jcache[name]),
                                       rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("name", ["tinyllama-1.1b", "qwen2-72b", "yi-34b", "gemma-7b",
                                  "mamba2-370m"])
def test_decode_matches_forward(name):
    """Prefill + decode reproduce the full forward pass (teacher forcing)."""
    cfg = get_config(name).reduced()
    S, extra = 32, 3
    toks = torch.from_numpy(_tokens(cfg, 2, S + extra)).long()
    params = init_params(cfg, torch.Generator().manual_seed(0), CPU)
    ref, _, _ = forward(params, toks, cfg, mode="train")
    logits, caches, clen = prefill(params, toks[:, :S], cfg, max_len=S + extra + 1)
    np.testing.assert_allclose(logits.numpy(), ref[:, S - 1].numpy(),
                               rtol=2e-4, atol=2e-4)
    for i in range(extra):
        logits, caches = decode_step(params, toks[:, S + i], caches, clen, cfg)
        clen += 1
        np.testing.assert_allclose(logits.numpy(), ref[:, S + i].numpy(),
                                   rtol=3e-4, atol=3e-4,
                                   err_msg=f"{name}: decode step {i}")


def test_windowed_decode_matches_windowed_forward():
    """Ring-buffer decode == full forward with the same sliding window."""
    cfg = get_config("qwen2-72b", shape="long_500k").reduced()
    W = cfg.attn_window
    assert W > 0
    S = W + 16      # long enough that the ring wraps
    toks = torch.from_numpy(_tokens(cfg, 1, S + 2)).long()
    params = init_params(cfg, torch.Generator().manual_seed(0), CPU)
    ref, _, _ = forward(params, toks, cfg, mode="train", window=W)
    logits, caches, clen = prefill(params, toks[:, :S], cfg, max_len=S, window=W)
    np.testing.assert_allclose(logits.numpy(), ref[:, S - 1].numpy(),
                               rtol=3e-4, atol=3e-4)
    for i in range(2):
        logits, caches = decode_step(params, toks[:, S + i], caches, clen, cfg,
                                     window=W)
        clen += 1
        np.testing.assert_allclose(logits.numpy(), ref[:, S + i].numpy(),
                                   rtol=3e-4, atol=3e-4,
                                   err_msg=f"ring-buffer decode step {i}")


def test_windowed_prefill_matches_jax():
    jcfg, tcfg, jp, tp = _pair("qwen2-72b", "long_500k")
    W = tcfg.attn_window
    toks = _tokens(jcfg, 1, W + 8)
    jl, jc, _ = jm.prefill(jp, jnp.asarray(toks), jcfg, max_len=W + 8, window=W)
    tl, tc, _ = prefill(tp, torch.from_numpy(toks).long(), tcfg, max_len=W + 8,
                        window=W)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(tc[0]["k"].numpy(), np.asarray(jc[0]["k"]),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("name", ["jamba-1.5-large-398b", "olmoe-1b-7b"])
def test_unported_families_raise(name):
    """The expert-parallel form (moe_ep=True), refused until it was ported,
    is accepted: with no mesh ``moe_ffn_ep`` is ``moe_ffn``, so the model
    gives the moe_ep=False model's logits exactly (its mesh runs are held
    to JAX in tests/test_torch_distributed.py)."""
    cfg = get_config(name).reduced()
    ep = dataclasses.replace(cfg, moe_ep=True)
    params = init_params(ep, torch.Generator().manual_seed(0), CPU)
    toks = torch.from_numpy(_tokens(cfg, 2, 8)).long()
    assert torch.equal(forward(params, toks, ep)[0], forward(params, toks, cfg)[0])


CATALOG = sorted({**ARCHS, **PAPER_MODELS})


def _jax_full(name):
    return {**JAX_ARCHS, **JAX_PAPER_MODELS}[name]


@pytest.mark.parametrize("name", CATALOG)
def test_abstract_params_matches_jax(name):
    """At full size, leaf for leaf in the JAX tree's order: the same shapes
    and dtypes, every leaf on the meta device (nothing allocated)."""
    want = [(l.shape, np.dtype(l.dtype).name)
            for l in jax.tree.leaves(jax_abstract_params(_jax_full(name)))]
    leaves = tree_leaves(abstract_params(get_config(name)))
    assert all(t.device.type == "meta" for t in leaves)
    assert [(tuple(t.shape), str(t.dtype)[6:]) for t in leaves] == want


@pytest.mark.parametrize("name", CATALOG)
def test_param_bytes_matches_jax(name):
    """``param_bytes(cfg)`` is the JAX tree's bytes. JAX's own
    ``param_bytes`` takes each leaf's element count as an int32 product,
    which wraps for a leaf of 2^31 elements or more (OLMoE's stacked
    experts, the stacked MLP leaves of the larger models): where no leaf is
    that large the two agree, and everywhere the port gives the exact sum."""
    jcfg = _jax_full(name)
    leaves = jax.tree.leaves(jax_abstract_params(jcfg))
    exact = sum(int(np.prod(l.shape, dtype=np.int64)) * l.dtype.itemsize
                for l in leaves)
    assert param_bytes(get_config(name)) == exact
    if all(np.prod(l.shape, dtype=np.int64) < 2 ** 31 for l in leaves):
        assert param_bytes(get_config(name)) == jax_param_bytes(jcfg)


def test_param_bytes_of_the_served_cuts():
    """The leaves' counts, not ``param_count()``, which counts q/k/v twice
    in a cross-attention layer and leaves out the norms."""
    vlm = get_config("llama-3.2-vision-90b")
    assert param_bytes(vlm) == 175_333_588_992
    cut = dataclasses.replace(vlm, n_layers=10)           # 2 periods
    assert param_bytes(cut) == 21_315_796_992
    assert sum(t.numel() for t in tree_leaves(abstract_params(cut))) == 10_657_898_496
    assert cut.param_count() - 10_657_898_496 == 2 * vlm.d_model * vlm.hd * (
        vlm.n_heads + 2 * vlm.n_kv_heads) - 10 * 2 * vlm.d_model
    assert param_bytes(get_config("musicgen-large")) == 6_459_625_472
