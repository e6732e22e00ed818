"""Head widths past 128 (gemma-7b's 256) through the port, against the JAX
package on the CPU: K3 and K2 (their plain versions here) against JAX's
Pallas kernels in interpret mode and their oracles, K3's gradient, and a
reduced gemma with ``head_dim=256`` (prefill, greedy decode, loss and
gradients). ``reduced()`` caps the head width at 64, so the configs set
256 back with ``dataclasses.replace``. The CUDA kernels' own limits, which
only a launch meets, are checked through the wrappers' launch functions
before any library is loaded.

Tolerances, fp32: 2e-5 for one attention call (summation order), 2e-4 on
logits after a whole model, a loss within 1e-5 relative and each gradient
leaf within 1e-4 of its largest magnitude (as tests/test_torch_training.py
holds them).
"""
import contextlib
import dataclasses
import importlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.models as jm
from repro.configs import get_config as jax_config
from repro.kernels.decode_attention import decode_attention as jax_decode
from repro.kernels.decode_attention import decode_attention_ref as jax_decode_ref
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.flash_attention import flash_attention_ref as jax_flash_ref
from repro_torch.configs import get_config
from repro_torch.kernels import (
    build,
    decode_attention,
    flash_attention,
    flash_attention_op,
)
from repro_torch.models import decode_step, params_from_jax, prefill
from repro_torch.training.train_loop import loss_and_grads
from repro_torch.tree import tree_leaves

# the wrappers' modules (each package exports a function of the same name)
k2_module = importlib.import_module("repro_torch.kernels.decode_attention.decode_attention")
k3_module = importlib.import_module("repro_torch.kernels.flash_attention.flash_attention")
CPU = torch.device("cpu")
ATTN_TOL = dict(rtol=2e-5, atol=2e-5)
LOGITS_TOL = dict(rtol=2e-4, atol=2e-4)


def _both(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


# ---------------------------------------------------------------------------
# K3 and K2 at D in {192, 256}
# ---------------------------------------------------------------------------
# (Sq, T, causal, window, q_offset, block): block_q = block_k for JAX's kernel
K3_CASES = {
    "causal": (64, 64, True, 0, 0, 32),
    "window": (64, 64, True, 24, 0, 16),
    "q_offset": (32, 64, True, 0, 32, 16),
    "not_causal": (32, 48, False, 0, 0, 16),
}


@pytest.mark.parametrize("case", sorted(K3_CASES))
@pytest.mark.parametrize("R", [1, 4])
@pytest.mark.parametrize("D", [192, 256])
def test_flash_plain_matches_jax_kernel_and_oracle(D, R, case):
    S, T, causal, window, q_offset, blk = K3_CASES[case]
    G = 2 if R == 1 else 1
    H = G * R
    rng = np.random.default_rng(D + R)
    (jq, tq), (jk, tk), (jv, tv) = (_both(rng, s) for s in
                                    ((1, H, S, D), (1, G, T, D), (1, G, T, D)))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    out = flash_attention(tq, tk, tv, **kw)
    assert out.shape == (1, H, S, D)
    kernel = jax_flash(jq, jk, jv, block_q=blk, block_k=blk, **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(kernel), **ATTN_TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(jax_flash_ref(jq, jk, jv, **kw)),
                               **ATTN_TOL)


@pytest.mark.parametrize("R", [1, 4])
@pytest.mark.parametrize("D", [192, 256])
def test_decode_plain_matches_jax_kernel_and_oracle(D, R):
    B, G, T = 2, 2, 96
    H = G * R
    rng = np.random.default_rng(D * R)
    (jq, tq), (jk, tk), (jv, tv) = (_both(rng, s) for s in
                                    ((B, H, D), (B, G, T, D), (B, G, T, D)))
    kv_len = np.array([1, 70], np.int32)
    out = decode_attention(tq, tk, tv, torch.from_numpy(kv_len))
    assert out.shape == (B, H, D)
    kernel = jax_decode(jq, jk, jv, jnp.asarray(kv_len), block_k=32)
    np.testing.assert_allclose(out.numpy(), np.asarray(kernel), **ATTN_TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(jax_decode_ref(jq, jk, jv,
                                                                      jnp.asarray(kv_len))),
                               **ATTN_TOL)


@pytest.mark.parametrize("R", [1, 4])
@pytest.mark.parametrize("S,T,causal,window,q_offset", [
    (32, 32, True, 0, 0),
    (32, 32, True, 8, 0),
    (16, 48, True, 0, 32),
    (24, 40, False, 0, 0),
    (40, 64, True, 16, 48),           # rows that see no key
])
def test_flash_attention_backward_at_256_matches_jax(S, T, causal, window, q_offset, R):
    """FlashAttentionFn's backward (``flash_attention_bwd``) at D = 256
    against ``jax.vjp`` of the JAX oracle, in the model's layout."""
    B, G, D = 1, 2, 256
    H = G * R
    rng = np.random.default_rng(11)
    q, do = (rng.standard_normal((B, S, H, D)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((B, T, G, D)).astype(np.float32) for _ in range(2))
    kw = dict(causal=causal, window=window, q_offset=q_offset)

    def jax_out(q, k, v):
        o = jax_flash_ref(q.transpose(0, 2, 1, 3), k.transpose(0, 2, 1, 3),
                          v.transpose(0, 2, 1, 3), **kw)
        return o.transpose(0, 2, 1, 3)

    jo, vjp = jax.vjp(jax_out, *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = flash_attention_op(tq, tk, tv, **kw)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jo), **ATTN_TOL)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **ATTN_TOL)


def _no_library(*a, **k):
    raise AssertionError("the check came after the kernel library was asked for")


@pytest.mark.parametrize("D,R,ok", [
    (256, 1, True), (256, 16, True), (160, 16, True), (256, 32, False), (160, 17, False),
    (128, 32, True), (320, 1, False),
])
def test_cuda_launches_refuse_what_the_kernels_cannot_take(D, R, ok):
    """What K2's and K3's CUDA kernels take (the plain versions take any D):
    K3 D <= 256; K2 D <= 256 and R = H / G <= 32, or <= 16 past D = 128.
    The launch functions check before they reach the library."""
    H, G, T = R, 1, 8
    q, k = torch.zeros(1, H, 4, D), torch.zeros(1, G, T, D)
    k3 = lambda: k3_module.launch(
        q, k, k, torch.empty_like(q), (1, H, G, 4, T, D), (0,) * 12,
        causal=True, window=0, q_offset=0)
    k2 = lambda: k2_module.launch(
        q[:, :, 0], k, k, 3, torch.empty_like(q[:, :, 0]), (1, H, G, T, D), (0,) * 10)
    with mock.patch.object(build, "library", _no_library), \
            mock.patch.object(torch.cuda, "device", lambda d: contextlib.nullcontext()), \
            mock.patch.object(k2_module, "_sm_count", lambda index: 132):
        for call, takes in ((k3, D <= 256), (k2, ok)):
            if takes:
                with pytest.raises(AssertionError, match="library"):
                    call()
            else:
                with pytest.raises(ValueError, match="CUDA kernel takes"):
                    call()


# ---------------------------------------------------------------------------
# gemma with head_dim = 256
# ---------------------------------------------------------------------------
def _gemma(seed=0):
    """(jax cfg, port cfg, jax params, port params): reduced gemma-7b (2
    layers, d 256, 4 heads on 4 KV heads, GeGLU, tied embedding) with its
    published head width of 256, fp32, on the same weights."""
    jcfg = dataclasses.replace(jax_config("gemma-7b").reduced(), head_dim=256,
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(get_config("gemma-7b").reduced(), head_dim=256)
    assert tcfg.hd == jcfg.hd == 256 and tcfg.dtype == torch.float32
    jp = jm.init_params(jax.random.PRNGKey(seed), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, CPU)
    return jcfg, tcfg, jp, tp


def _tokens(cfg, B, S, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)).astype(np.int32)


@pytest.mark.parametrize("attn_impl", ["xla", "pallas"])
def test_gemma_256_prefill_logits_match_jax(attn_impl):
    jcfg, tcfg, jp, tp = _gemma()
    jcfg = dataclasses.replace(jcfg, attn_impl=attn_impl)
    toks = _tokens(jcfg, 2, 32)
    jl, _, jn = jm.prefill(jp, jnp.asarray(toks), jcfg, max_len=48)
    tl, _, tn = prefill(tp, torch.from_numpy(toks).long(), tcfg, max_len=48)
    assert tn == int(jn) == 32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGITS_TOL)


def test_gemma_256_greedy_decode_matches_jax():
    """8 greedy steps: the same tokens, logits within 2e-4, and the caches."""
    jcfg, tcfg, jp, tp = _gemma()
    toks = _tokens(jcfg, 2, 24)
    jl, jc, jn = jm.prefill(jp, jnp.asarray(toks), jcfg, max_len=40)
    tl, tc, tn = prefill(tp, torch.from_numpy(toks).long(), tcfg, max_len=40)
    dec = jax.jit(lambda p, t, c, n: jm.decode_step(p, t, c, n, jcfg))
    for step in range(8):
        jt = np.argmax(np.asarray(jl), -1).astype(np.int32)
        tt = torch.argmax(tl, -1)
        assert tt.numpy().tolist() == jt.tolist(), f"greedy token differs at {step}"
        jl, jc = dec(jp, jnp.asarray(jt), jc, jn)
        jn = jn + 1
        tl, tc = decode_step(tp, tt, tc, tn, tcfg)
        tn += 1
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), err_msg=f"step {step}",
                                   **LOGITS_TOL)
    for jcache, tcache in zip(jc, tc):
        for name in ("k", "v"):
            assert tcache[name].shape[-1] == 256
            np.testing.assert_allclose(tcache[name].numpy(), np.asarray(jcache[name]),
                                       **LOGITS_TOL)


def test_gemma_256_loss_and_grads_match_jax():
    jcfg, tcfg, jp, tp = _gemma()
    rng = np.random.default_rng(3)
    toks = rng.integers(0, tcfg.vocab, (2, 17)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True),
                                 static_argnums=2)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    loss, _, grads = loss_and_grads(tp, {k: torch.from_numpy(v).long()
                                         for k, v in batch.items()}, tcfg)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    jleaves, leaves = jax.tree.leaves(jgrads), tree_leaves(grads)
    assert len(jleaves) == len(leaves)
    for g, jg in zip(leaves, jleaves):
        jg = np.asarray(jg, np.float64)
        err = np.abs(g.detach().numpy() - jg).max() / max(np.abs(jg).max(), 1e-30)
        assert err <= 1e-4, err
