"""Cross-attention and the frontend inputs in the port (repro_torch.models)
against the JAX package, on the same inputs made with numpy from a seed and
the same weights (``params_from_jax``), in fp32 at the reduced sizes: the
cross-attention mixer, K3's plain version without the causal mask against
the Pallas kernel in interpret mode, the reduced llama-3.2-vision (a
cross-attention layer closing each period of 5) fed a frontend, and the
reduced musicgen fed ``inputs_embeds``.

On the CPU the attention wrappers run their plain versions; the card
tests (tests/test_torch_cuda.py) hold K3 and K2 to those at these modes.
Tolerances: 2e-5 for one attention call (summation order in fp32), 2e-4
for logits and caches after a whole model (as tests/test_torch_models.py).
"""
import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.models as jm
from repro.configs import get_config as jax_config
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.models.attention import cross_attention as jax_cross_attention
from repro.models.attention import gqa as jax_gqa
import repro_torch.models.attention as attention
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention_op_ref
from repro_torch.models import (
    cross_attention,
    decode_step,
    forward,
    init_params,
    params_from_jax,
    prefill,
)

CPU = torch.device("cpu")
ATTN_TOL = dict(rtol=2e-5, atol=2e-5)
MODEL_TOL = dict(rtol=2e-4, atol=2e-4)
VLM, AUDIO = "llama-3.2-vision-90b", "musicgen-large"
# JAX runs op by op without jit; compiled once per shape, these are faster
jax_prefill = jax.jit(jm.prefill, static_argnums=(2,), static_argnames=("max_len",))
jax_decode_step = jax.jit(jm.decode_step, static_argnums=(4,))


def _pair(name, seed=0, **replace):
    """(jax cfg, port cfg, jax params, port params) on the same weights."""
    jcfg = dataclasses.replace(jax_config(name).reduced(), dtype=jnp.float32, **replace)
    tcfg = dataclasses.replace(get_config(name).reduced(), **replace)
    jp = jm.init_params(jax.random.PRNGKey(seed), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, CPU)
    return jcfg, tcfg, jp, tp


def _normal(*shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _tokens(cfg, B, S, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)).astype(np.int32)


# ---------------------------------------------------------------------------
# The mixer and K3 without the causal mask
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("R", [1, 2])
@pytest.mark.parametrize("F", [8, 24])
@pytest.mark.parametrize("S", [1, 7, 32])
def test_cross_attention_matches_jax(S, F, R):
    """One cross-attention layer (K2 over all F keys at S = 1, K3 without
    the causal mask otherwise) against the JAX mixer; R = H / G query heads
    per frontend KV head."""
    jcfg, tcfg, jp, tp = _pair(VLM, n_kv_heads=4 // R)
    j = tcfg.layer_plan().index(("cross_attn", "mlp"))
    jl = {k: a[0] for k, a in jp["blocks"][j].items()}
    tl = {k: a[0] for k, a in tp["blocks"][j].items()}
    x, fe = _normal(2, S, tcfg.d_model, seed=S), _normal(2, F, tcfg.d_model, seed=F)
    want = jax_cross_attention(jl, jnp.asarray(x), jnp.asarray(fe), jcfg)
    got = cross_attention(tl, torch.from_numpy(x), torch.from_numpy(fe), tcfg)
    assert got.shape == (2, S, tcfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATTN_TOL)


@pytest.mark.parametrize("S", [1, 7])
def test_cross_attention_takes_k3_without_the_mask_and_k2_at_decode(S):
    """S > 1 goes to K3 with causal=False over the F frontend keys, S = 1
    to K2 with kv_len = F; no RoPE, so a frontend key's position does not
    matter: reversing the frontend leaves the output as it was."""
    _, cfg, _, tp = _pair(VLM)
    p = {k: a[0] for k, a in tp["blocks"][4].items()}
    x, fe = torch.from_numpy(_normal(1, S, cfg.d_model, seed=2)), \
        torch.from_numpy(_normal(1, 24, cfg.d_model, seed=3))
    calls = []

    def spy(name):
        real = getattr(attention, name)

        def run(*args, **kw):
            calls.append((name, args[1].shape[1], args[3:], kw))
            return real(*args, **kw)
        return mock.patch.object(attention, name, run)

    with spy("flash_attention_op"), spy("decode_attention_op"):
        y = cross_attention(p, x, fe, cfg)
    want = (("decode_attention_op", 24, (24,), {}) if S == 1
            else ("flash_attention_op", 24, (), {"causal": False}))
    assert calls == [want]
    np.testing.assert_allclose(cross_attention(p, x, fe.flip(1), cfg).numpy(),
                               y.numpy(), **ATTN_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,G,Sq,T", [(4, 2, 32, 64), (4, 2, 64, 32), (8, 8, 16, 48)])
def test_flash_plain_without_causal_mask_matches_jax(dtype, H, G, Sq, T):
    """K3's plain version with causal=False and Sq != T (the cross-attention
    shapes) against the JAX Pallas kernel in interpret mode and against
    JAX's gqa with no mask."""
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    tol = ATTN_TOL if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    q, k, v = (_normal(2, Sq, H, 32, seed=1), _normal(2, T, G, 32, seed=2),
               _normal(2, T, G, 32, seed=3))          # the model's layout
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    got = flash_attention_op_ref(tq, tk, tv, causal=False).float().numpy()
    jq, jk, jv = (jnp.asarray(a).astype(jdt) for a in (q, k, v))
    pallas = jax_flash(jq.transpose(0, 2, 1, 3), jk.transpose(0, 2, 1, 3),
                       jv.transpose(0, 2, 1, 3), causal=False, block_q=16, block_k=16,
                       interpret=True).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(got, np.asarray(pallas.astype(jnp.float32)), **tol)
    plain = jax_gqa(jq, jk, jv, mask=None)
    np.testing.assert_allclose(got, np.asarray(plain.astype(jnp.float32)), **tol)


# ---------------------------------------------------------------------------
# The reduced llama-3.2-vision with a frontend
# ---------------------------------------------------------------------------
def test_reduced_vlm_prefill_and_greedy_decode_match_jax():
    """Prefill with a frontend, logits and self-attention caches; then 8
    greedy decode steps with the same frontend: the same tokens and logits."""
    jcfg, tcfg, jp, tp = _pair(VLM)
    assert [m for m, _ in tcfg.layer_plan()] == ["attn"] * 4 + ["cross_attn"]
    assert tcfg.n_layers == 10            # cross layers at positions 4 and 9
    toks = _tokens(tcfg, 2, 24)
    fe = _normal(2, tcfg.n_frontend_tokens, tcfg.d_model, seed=5)
    jfe, tfe = jnp.asarray(fe), torch.from_numpy(fe)
    jl, jc, jn = jax_prefill(jp, jnp.asarray(toks), jcfg, max_len=40, frontend=jfe)
    tl, tc, tn = prefill(tp, torch.from_numpy(toks).long(), tcfg, max_len=40, frontend=tfe)
    assert tn == int(jn) == 24
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL_TOL)
    for step in range(8):
        jt = np.argmax(np.asarray(jl), -1).astype(np.int32)
        tt = torch.argmax(tl, -1)
        assert tt.numpy().tolist() == jt.tolist(), f"greedy token differs at {step}"
        jl, jc = jax_decode_step(jp, jnp.asarray(jt), jc, jn, jcfg, frontend=jfe)
        jn = jn + 1
        tl, tc = decode_step(tp, tt, tc, tn, tcfg, frontend=tfe)
        tn += 1
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL_TOL,
                                   err_msg=f"decode step {step}")
    for (mixer, _), jcache, tcache in zip(tcfg.layer_plan(), jc, tc):
        assert sorted(tcache) == sorted(jcache) == (["k", "v"] if mixer == "attn" else [])
        for name in tcache:
            np.testing.assert_allclose(tcache[name].numpy(), np.asarray(jcache[name]),
                                       **MODEL_TOL)


def test_reduced_vlm_decode_matches_forward():
    """The port's prefill + decode with a frontend reproduce its own forward
    pass over the whole sequence (teacher forcing)."""
    cfg = get_config(VLM).reduced()
    S, extra = 20, 3
    toks = torch.from_numpy(_tokens(cfg, 2, S + extra)).long()
    fe = torch.from_numpy(_normal(2, cfg.n_frontend_tokens, cfg.d_model, seed=6))
    params = init_params(cfg, torch.Generator().manual_seed(0), CPU)
    ref, _, _ = forward(params, toks, cfg, frontend=fe)
    logits, caches, clen = prefill(params, toks[:, :S], cfg, max_len=S + extra,
                                   frontend=fe)
    np.testing.assert_allclose(logits.numpy(), ref[:, S - 1].numpy(), **MODEL_TOL)
    for i in range(extra):
        logits, caches = decode_step(params, toks[:, S + i], caches, clen + i, cfg,
                                     frontend=fe)
        np.testing.assert_allclose(logits.numpy(), ref[:, S + i].numpy(), **MODEL_TOL,
                                   err_msg=f"decode step {i}")


def test_reduced_vlm_logits_follow_the_frontend():
    """Another frontend moves the logits by far more than the tolerance: a
    cross-attention layer that dropped its keys would not."""
    _, cfg, _, tp = _pair(VLM)
    toks = torch.from_numpy(_tokens(cfg, 1, 16)).long()
    a, b = (prefill(tp, toks, cfg, max_len=16, frontend=torch.from_numpy(
        _normal(1, cfg.n_frontend_tokens, cfg.d_model, seed=s)))[0] for s in (7, 8))
    assert (a - b).abs().max().item() > 100 * MODEL_TOL["atol"] * a.abs().max().item()


@pytest.mark.parametrize("entry", ["forward", "prefill", "decode_step"])
def test_cross_attention_model_without_frontend_raises(entry):
    _, cfg, _, tp = _pair(VLM)
    toks = torch.from_numpy(_tokens(cfg, 1, 4)).long()
    with pytest.raises(ValueError, match="frontend"):
        if entry == "forward":
            forward(tp, toks, cfg)
        elif entry == "prefill":
            prefill(tp, toks, cfg, max_len=8)
        else:
            fe = torch.from_numpy(_normal(1, cfg.n_frontend_tokens, cfg.d_model, seed=9))
            _, caches, n = prefill(tp, toks, cfg, max_len=8, frontend=fe)
            decode_step(tp, toks[:, -1], caches, n, cfg)


# ---------------------------------------------------------------------------
# The reduced musicgen through inputs_embeds
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("decode_from", ["tokens", "embeddings"])
def test_reduced_musicgen_inputs_embeds_match_jax(decode_from):
    """Prefill from (B, S, d) frame embeddings, then 4 decode steps fed the
    greedy tokens or (B, 1, d) embeddings with token=None: logits within
    2e-4 of JAX, the same greedy tokens, the same caches."""
    jcfg, tcfg, jp, tp = _pair(AUDIO)
    assert tcfg.cross_attn_every == 0
    emb = _normal(2, 24, tcfg.d_model, seed=10)
    jl, jc, jn = jax_prefill(jp, None, jcfg, max_len=32, inputs_embeds=jnp.asarray(emb))
    tl, tc, tn = prefill(tp, None, tcfg, max_len=32, inputs_embeds=torch.from_numpy(emb))
    assert tn == int(jn) == 24
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL_TOL)
    for step in range(4):
        jt = np.argmax(np.asarray(jl), -1).astype(np.int32)
        tt = torch.argmax(tl, -1)
        assert tt.numpy().tolist() == jt.tolist(), f"greedy token differs at {step}"
        if decode_from == "tokens":
            jl, jc = jax_decode_step(jp, jnp.asarray(jt), jc, jn, jcfg)
            tl, tc = decode_step(tp, tt, tc, tn, tcfg)
        else:
            e = _normal(2, 1, tcfg.d_model, seed=20 + step)
            jl, jc = jax_decode_step(jp, None, jc, jn, jcfg, inputs_embeds=jnp.asarray(e))
            tl, tc = decode_step(tp, None, tc, tn, tcfg, inputs_embeds=torch.from_numpy(e))
        jn, tn = jn + 1, tn + 1
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL_TOL,
                                   err_msg=f"decode step {step}")
    for jcache, tcache in zip(jc, tc):
        for name in ("k", "v"):
            np.testing.assert_allclose(tcache[name].numpy(), np.asarray(jcache[name]),
                                       **MODEL_TOL)


def test_inputs_embeds_of_the_token_embeddings_equal_the_tokens():
    """inputs_embeds = embedding[tokens] gives the token path's logits, and
    embeddings in another dtype are cast to cfg.dtype."""
    cfg = get_config(AUDIO).reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), CPU)
    toks = torch.from_numpy(_tokens(cfg, 2, 12)).long()
    want = forward(params, toks, cfg)[0]
    emb = params["embedding"][toks].double()
    got = forward(params, None, cfg, inputs_embeds=emb)[0]
    assert got.dtype == want.dtype
    assert torch.equal(got, want)
