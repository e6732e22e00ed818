"""The port's Mamba2 path (K4's plain version, ``ssd_chunked``, the SSM
block, the layer stack and the server) against the JAX package's, on the
same inputs made with numpy from a seed, in fp32 at the reduced sizes.

On the CPU the K4 wrappers run their plain version; tests/test_torch_cuda.py
holds the CUDA kernel to it on the card. Tolerances: 2e-5 for the SSD
pieces (summation order in fp32), 2e-4 for logits and states after a
whole model (the same as tests/test_torch_models.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.models as jm
import repro.models.ssm as jssm
import repro.serving as jserving
from repro.configs import get_config as jax_config
from repro.kernels.ssd_chunk import ssd_chunk as jax_ssd_chunk
from repro.kernels.ssd_chunk import ssd_chunk_ref as jax_ssd_chunk_ref
from repro_torch.configs import get_config
from repro_torch.kernels import launch_counts, ssd_chunk, ssd_chunk_op
from repro_torch.models import (
    causal_conv,
    conv_decode_step,
    decode_step,
    forward,
    init_ssm_state,
    mamba_block,
    mamba_block_decode,
    params_from_jax,
    prefill,
    segsum,
    ssd_chunked,
    ssd_decode_step,
)
from repro_torch.serving import FunctionalServer

CPU = torch.device("cpu")
# JAX runs op by op without jit; compiled once per shape, these are faster
jax_prefill = jax.jit(jm.prefill, static_argnums=(2,), static_argnames=("max_len",))
jax_decode_step = jax.jit(jm.decode_step, static_argnums=(4,))
jax_block = jax.jit(jssm.mamba_block, static_argnums=(2,),
                    static_argnames=("return_state",))
jax_block_decode = jax.jit(jssm.mamba_block_decode, static_argnums=(3,))
SSD_TOL = dict(rtol=2e-5, atol=2e-5)
MODEL_TOL = dict(rtol=2e-4, atol=2e-4)
SHAPES = [(2, 64, 4, 8, 16, 16), (1, 128, 2, 16, 32, 32), (1, 32, 8, 4, 8, 8)]


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _ssd_inputs(b, l, h, p, n, g=1, seed=5, decay="fast"):
    """``fast``: a = -softplus(randn), about -0.8 a step, so keys far below
    the diagonal weigh next to nothing. ``slow``: Mamba2's decays, a = -A dt
    with A over U(1, 16) and dt over log-uniform [1e-3, 1e-1] by quantiles
    across the heads (dt jittered per position) and xbar = x dt, so every
    key and every state position adds to the result."""
    rng = np.random.default_rng(seed)
    f = np.float32
    if decay == "fast":
        xbar = (rng.standard_normal((b, l, h, p)) * 0.3).astype(f)
        a = -np.log1p(np.exp(rng.standard_normal((b, l, h)))).astype(f)
    else:
        q = (np.arange(h) + 0.5) / h
        A = 1 + 15 * rng.permutation(q)
        dt = 1e-3 * 100 ** rng.permutation(q) * (0.5 + rng.random((b, l, h)))
        xbar = (rng.standard_normal((b, l, h, p)) * dt[..., None]).astype(f)
        a = (-A * dt).astype(f)
    B = (rng.standard_normal((b, l, g, n)) * 0.3).astype(f)
    C = (rng.standard_normal((b, l, g, n)) * 0.3).astype(f)
    return xbar, a, B, C


# ---------------------------------------------------------------------------
# K4's plain version against the JAX kernel (interpret mode) and its oracle
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("b,l,h,p,n,chunk", SHAPES)
def test_plain_ssd_chunk_matches_jax_kernel_and_oracle(b, l, h, p, n, chunk):
    _check_plain_ssd_chunk(b, l, h, p, n, chunk, "fast")


@pytest.mark.parametrize("b,l,h,p,n,chunk", SHAPES)
def test_plain_ssd_chunk_matches_jax_at_slow_decays(b, l, h, p, n, chunk):
    _check_plain_ssd_chunk(b, l, h, p, n, chunk, "slow")


def _check_plain_ssd_chunk(b, l, h, p, n, chunk, decay):
    xbar, a, B, C = _ssd_inputs(b, l, h, p, n, decay=decay)
    nc = l // chunk
    # the fused (b*h, nc, Q, .) layout of the JAX ops.py, B/C per head
    xc = xbar.reshape(b, nc, chunk, h, p).transpose(0, 3, 1, 2, 4).reshape(
        b * h, nc, chunk, p)
    ac = a.reshape(b, nc, chunk, h).transpose(0, 3, 1, 2).reshape(b * h, nc, chunk)
    Bb = np.broadcast_to(B.reshape(b, 1, nc, chunk, n),
                         (b, h, nc, chunk, n)).reshape(b * h, nc, chunk, n)
    Cb = np.broadcast_to(C.reshape(b, 1, nc, chunk, n),
                         (b, h, nc, chunk, n)).reshape(b * h, nc, chunk, n)
    ins = (xc, ac, Bb, Cb)
    got = ssd_chunk(*(torch.from_numpy(np.ascontiguousarray(t)) for t in ins))
    kern = jax_ssd_chunk(*(jnp.asarray(t) for t in ins), interpret=True)
    oracle = jax.vmap(jax_ssd_chunk_ref)(*(jnp.asarray(t) for t in ins))
    assert [tuple(t.shape) for t in got] == [
        (b * h, nc, chunk, p), (b * h, nc, p, n), (b * h, nc, chunk)]
    assert [t.dtype for t in got] == [torch.float32] * 3
    for g_, k_, o_ in zip(got, kern, oracle):
        np.testing.assert_allclose(_np(g_), _np(k_), **SSD_TOL)
        np.testing.assert_allclose(_np(g_), _np(o_), **SSD_TOL)


@pytest.mark.parametrize("g", [1, 2])
def test_model_layout_op_equals_fused_layout(g):
    """``ssd_chunk_op`` (model layout, groups read per head, ragged last
    chunk) against ``ssd_chunk`` on the padded, fused, broadcast layout."""
    b, l, h, p, n, chunk = 2, 40, 4, 8, 16, 16
    xbar, a, B, C = (torch.from_numpy(t) for t in _ssd_inputs(b, l, h, p, n, g))
    y, states, decay = ssd_chunk_op(xbar, a, B, C, chunk)
    assert y.shape == (b, l, h, p) and states.shape == (b, h, 3, p, n)
    assert decay.shape == (b, h, 3, chunk)
    pad = 48 - l
    fuse = lambda t: t.reshape(b, 3, chunk, h, -1).permute(0, 3, 1, 2, 4).reshape(
        b * h, 3, chunk, -1)
    xp = fuse(torch.nn.functional.pad(xbar, (0, 0, 0, 0, 0, pad)))
    ap = fuse(torch.nn.functional.pad(a, (0, 0, 0, pad))[..., None])[..., 0]
    Bp = fuse(torch.nn.functional.pad(B, (0, 0, 0, 0, 0, pad)).repeat_interleave(
        h // g, dim=2))
    Cp = fuse(torch.nn.functional.pad(C, (0, 0, 0, 0, 0, pad)).repeat_interleave(
        h // g, dim=2))
    yr, sr, dr = ssd_chunk(xp.contiguous(), ap.contiguous(), Bp.contiguous(),
                           Cp.contiguous())
    yr = yr.reshape(b, h, 48, p).transpose(1, 2)[:, :l]
    assert torch.equal(y, yr)
    assert torch.equal(states, sr.reshape(b, h, 3, p, n))
    assert torch.equal(decay, dr.reshape(b, h, 3, chunk))


# ---------------------------------------------------------------------------
# ssd_chunked and the SSM pieces against the JAX model
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("g,l", [(1, 64), (1, 50), (2, 50), (2, 64)])
def test_ssd_chunked_matches_jax(g, l, with_state):
    b, h, p, n, chunk = 2, 4, 8, 16, 16
    xbar, a, B, C = _ssd_inputs(b, l, h, p, n, g, seed=7)
    s0 = (np.random.default_rng(8).standard_normal((b, h, p, n)) * 0.3).astype(
        np.float32) if with_state else None
    jy, js = jssm.ssd_chunked(*(jnp.asarray(t) for t in (xbar, a, B, C)), chunk,
                              None if s0 is None else jnp.asarray(s0))
    ty, ts = ssd_chunked(*(torch.from_numpy(t) for t in (xbar, a, B, C)), chunk,
                         None if s0 is None else torch.from_numpy(s0))
    assert ty.shape == (b, l, h, p) and ts.shape == (b, h, p, n)
    np.testing.assert_allclose(ty.numpy(), _np(jy), **SSD_TOL)
    np.testing.assert_allclose(ts.numpy(), _np(js), **SSD_TOL)


@pytest.mark.parametrize("g", [1, 2])
def test_ssd_chunked_matches_jax_at_slow_decays(g):
    """Ragged length and an initial state, with decays slow enough that
    every chunk's state reaches the end."""
    b, l, h, p, n, chunk = 2, 50, 4, 8, 16, 16
    xbar, a, B, C = _ssd_inputs(b, l, h, p, n, g, seed=9, decay="slow")
    s0 = (np.random.default_rng(10).standard_normal((b, h, p, n)) * 0.3).astype(
        np.float32)
    jy, js = jssm.ssd_chunked(*(jnp.asarray(t) for t in (xbar, a, B, C)), chunk,
                              jnp.asarray(s0))
    ty, ts = ssd_chunked(*(torch.from_numpy(t) for t in (xbar, a, B, C)), chunk,
                         torch.from_numpy(s0))
    np.testing.assert_allclose(ty.numpy(), _np(jy), **SSD_TOL)
    np.testing.assert_allclose(ts.numpy(), _np(js), **SSD_TOL)
    # the initial state still shows at the end, so it was carried, not dropped
    assert np.abs(_np(js) - _np(jssm.ssd_chunked(
        *(jnp.asarray(t) for t in (xbar, a, B, C)), chunk, None)[1])).max() > 1e-2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_op_matches_jax_at_mamba2_370m_width(dtype):
    """``ssd_op`` (on the CPU: K4's plain route) against JAX's
    ``ssd_chunked`` at Mamba2-370m's full width: 32 heads of 64, one B/C
    group of N = 128, chunk 256, a 512-token prefill, Mamba2's slow decays
    (every key tile and state position counts). fp32 to SSD_TOL. bf16 x, B
    and C (the served dtype; a in fp32 on both sides) to 2e-2 of max |y|
    and of max |state|, the port's bf16 tolerance: JAX rounds C B^T to bf16
    before the decays, the port keeps it in fp32."""
    from repro_torch.kernels import ssd_op

    b, l, h, p, n, chunk = 1, 512, 32, 64, 128, 256
    xbar, a, B, C = _ssd_inputs(b, l, h, p, n, seed=11, decay="slow")
    jt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tt = getattr(torch, dtype)
    jy, js = jssm.ssd_chunked(jnp.asarray(xbar, jt), jnp.asarray(a), jnp.asarray(B, jt),
                              jnp.asarray(C, jt), chunk)
    ty, ts = ssd_op(torch.from_numpy(xbar).to(tt), torch.from_numpy(a),
                    torch.from_numpy(B).to(tt), torch.from_numpy(C).to(tt), chunk)
    assert ty.shape == (b, l, h, p) and ts.shape == (b, h, p, n) and ts.dtype == tt
    got = [t_.float().numpy() for t_ in (ty, ts)]
    want = [np.asarray(j_, np.float32) for j_ in (jy, js)]
    for g_, w_ in zip(got, want):
        if dtype == "float32":
            np.testing.assert_allclose(g_, w_, **SSD_TOL)
        else:
            assert np.abs(g_ - w_).max() <= 2e-2 * np.abs(w_).max()


def test_ssd_chunked_keeps_state_in_input_dtype():
    xbar, a, B, C = (torch.from_numpy(t) for t in _ssd_inputs(1, 20, 2, 4, 8))
    y, s = ssd_chunked(xbar.bfloat16(), a, B.bfloat16(), C.bfloat16(), 8)
    assert s.dtype == torch.bfloat16 and y.dtype == torch.float32


def test_segsum_matches_jax():
    a = -np.abs(np.random.default_rng(3).standard_normal((2, 3, 12))).astype(np.float32)
    np.testing.assert_allclose(segsum(torch.from_numpy(a)).numpy(),
                               _np(jssm.segsum(jnp.asarray(a))), **SSD_TOL)


def test_ssd_decode_step_matches_jax():
    rng = np.random.default_rng(4)
    b, h, p, n, g = 2, 4, 8, 16, 2
    f = np.float32
    ins = [(rng.standard_normal((b, h, p, n)) * 0.3).astype(f),
           rng.standard_normal((b, h, p)).astype(f),
           np.abs(rng.standard_normal((b, h))).astype(f),
           -np.abs(rng.standard_normal((b, h))).astype(f),
           rng.standard_normal((b, g, n)).astype(f),
           rng.standard_normal((b, g, n)).astype(f)]
    jy, js = jssm.ssd_decode_step(*(jnp.asarray(t) for t in ins))
    ty, ts = ssd_decode_step(*(torch.from_numpy(t) for t in ins))
    np.testing.assert_allclose(ty.numpy(), _np(jy), **SSD_TOL)
    np.testing.assert_allclose(ts.numpy(), _np(js), **SSD_TOL)


def test_causal_conv_and_decode_step_match_jax():
    rng = np.random.default_rng(6)
    b, l, ch, width = 2, 9, 12, 4
    x = rng.standard_normal((b, l, ch)).astype(np.float32)
    w = rng.standard_normal((width, ch)).astype(np.float32)
    bias = rng.standard_normal((ch,)).astype(np.float32)
    jo = jssm.causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias))
    to = causal_conv(*(torch.from_numpy(t) for t in (x, w, bias)))
    assert to.is_contiguous()
    np.testing.assert_allclose(to.numpy(), _np(jo), **SSD_TOL)
    state = rng.standard_normal((b, width - 1, ch)).astype(np.float32)
    new = rng.standard_normal((b, 1, ch)).astype(np.float32)
    jy, js = jssm.conv_decode_step(*(jnp.asarray(t) for t in (state, new, w, bias)))
    ty, ts = conv_decode_step(*(torch.from_numpy(t) for t in (state, new, w, bias)))
    np.testing.assert_allclose(ty.numpy(), _np(jy), **SSD_TOL)
    np.testing.assert_allclose(ts.numpy(), _np(js), **SSD_TOL)


# ---------------------------------------------------------------------------
# Whole models on the same weights
# ---------------------------------------------------------------------------
def _pair(name, **overrides):
    jcfg = dataclasses.replace(jax_config(name).reduced(), dtype=jnp.float32,
                               **overrides)
    tcfg = dataclasses.replace(get_config(name).reduced(), **overrides)
    assert tcfg.dtype == torch.float32
    jp = jm.init_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, CPU)
    return jcfg, tcfg, jp, tp


def _tokens(cfg, B, S, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)).astype(np.int32)


def test_mamba_block_then_decode_matches_jax():
    jcfg, tcfg, jp, tp = _pair("mamba2-370m")
    jl = jax.tree.map(lambda t: t[0], jp["blocks"][0])
    tl = {k: v[0] for k, v in tp["blocks"][0].items()}
    x = (np.random.default_rng(2).standard_normal((2, 37, tcfg.d_model)) * 0.5
         ).astype(np.float32)
    jo, js = jax_block(jl, jnp.asarray(x[:, :33]), jcfg, return_state=True)
    to, ts = mamba_block(tl, torch.from_numpy(x[:, :33]), tcfg, return_state=True)
    np.testing.assert_allclose(to.numpy(), _np(jo), **MODEL_TOL)
    for t in range(33, 37):
        jo, js = jax_block_decode(jl, jnp.asarray(x[:, t:t + 1]), js, jcfg)
        to, ts = mamba_block_decode(tl, torch.from_numpy(x[:, t:t + 1]), ts, tcfg)
        np.testing.assert_allclose(to.numpy(), _np(jo), **MODEL_TOL,
                                   err_msg=f"decode position {t}")
    for name in ("ssm", "conv_x", "conv_B", "conv_C"):
        np.testing.assert_allclose(ts[name].numpy(), _np(js[name]), **MODEL_TOL)
    assert set(init_ssm_state(tcfg, 2)) == set(ts)


def _prefill_then_decode(name, steps, S=40, **overrides):
    jcfg, tcfg, jp, tp = _pair(name, **overrides)
    toks = _tokens(jcfg, 2, S)
    jl, jc, jn = jax_prefill(jp, jnp.asarray(toks), jcfg, max_len=S + steps + 1)
    tl, tc, tn = prefill(tp, torch.from_numpy(toks).long(), tcfg,
                         max_len=S + steps + 1)
    assert tn == int(jn) == S
    np.testing.assert_allclose(tl.numpy(), _np(jl), **MODEL_TOL)
    for step in range(steps):
        jt = np.argmax(_np(jl), -1).astype(np.int32)
        tt = torch.argmax(tl, -1)
        assert tt.numpy().tolist() == jt.tolist(), f"greedy token differs at {step}"
        jl, jc = jax_decode_step(jp, jnp.asarray(jt), jc, jn, jcfg)
        jn = jn + 1
        tl, tc = decode_step(tp, tt, tc, tn, tcfg)
        tn += 1
        np.testing.assert_allclose(tl.numpy(), _np(jl), **MODEL_TOL,
                                   err_msg=f"decode step {step}")
    for jcache, tcache in zip(jc, tc):
        assert sorted(jcache) == sorted(tcache)
        for key in tcache:
            np.testing.assert_allclose(tcache[key].numpy(), _np(jcache[key]),
                                       **MODEL_TOL, err_msg=key)
    return tcfg


def test_reduced_mamba2_prefill_and_decode_match_jax():
    """Prefill logits, 8 greedy decode steps and the final SSM states and
    conv tails; the 40-token prompt leaves a ragged last chunk of 8."""
    cfg = _prefill_then_decode("mamba2-370m", 8)
    assert cfg.ssm_chunk == 32 and {m for m, _ in cfg.layer_plan()} == {"ssm"}


def test_one_period_hybrid_matches_jax():
    """Reduced jamba without MoE: one attention and seven SSM layers, each
    with an MLP channel, in one period."""
    cfg = _prefill_then_decode("jamba-1.5-large-398b", 3, n_experts=0, n_layers=8)
    assert [m for m, _ in cfg.layer_plan()] == ["attn"] + ["ssm"] * 7
    assert {c for _, c in cfg.layer_plan()} == {"mlp"}


def test_mamba2_decode_matches_forward():
    """Prefill + decode reproduce the full forward pass (teacher forcing)."""
    _, tcfg, _, tp = _pair("mamba2-370m")
    toks = torch.from_numpy(_tokens(tcfg, 2, 47)).long()
    ref, _, _ = forward(tp, toks, tcfg)
    logits, caches, n = prefill(tp, toks[:, :44], tcfg, max_len=48)
    np.testing.assert_allclose(logits.numpy(), ref[:, 43].numpy(), **MODEL_TOL)
    for i in range(3):
        logits, caches = decode_step(tp, toks[:, 44 + i], caches, n + i, tcfg)
        np.testing.assert_allclose(logits.numpy(), ref[:, 44 + i].numpy(),
                                   **MODEL_TOL)


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------
def test_functional_server_on_mamba2_matches_jax_server():
    """Same weights and prompts: the same generated tokens, a prefix hit on
    the repeat, and no launch of a kernel on the CPU."""
    jcfg = jax_config("mamba2-370m").reduced()
    tcfg = get_config("mamba2-370m").reduced()
    jp = jm.init_params(jax.random.PRNGKey(0), jcfg)
    kw = dict(max_running=2, device_budget_tokens=2048, max_len=128, page_size=16)
    jsrv = jserving.FunctionalServer(jcfg, params=jp, **kw)
    tsrv = FunctionalServer(
        tcfg, params=params_from_jax(jax.tree.map(np.asarray, jp), tcfg, CPU),
        device="cpu", **kw,
    )
    before = launch_counts()
    rng = np.random.default_rng(0)
    p1 = rng.integers(0, tcfg.vocab, size=64)
    prompts = [p1, rng.integers(0, tcfg.vocab, size=40), p1]

    def serve(srv):
        reqs = [srv.submit(p, max_new_tokens=4) for p in prompts]
        srv.run_until_done()
        return reqs

    jr, tr = serve(jsrv), serve(tsrv)
    assert [r.generated for r in tr] == [r.generated for r in jr]
    assert [r.hit_tokens for r in tr] == [r.hit_tokens for r in jr]
    assert tr[0].hit_tokens == 0 and tr[2].hit_tokens > 0
    assert tr[2].generated == tr[0].generated
    assert tsrv.transfer_log == jsrv.transfer_log
    assert launch_counts() == before


def test_mamba2_entry_points_need_a_card_unless_asked_for_cpu(monkeypatch):
    from repro_torch.models import init_params

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("mamba2-370m").reduced()
    for call in (lambda: init_params(cfg), lambda: FunctionalServer(cfg)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert params["blocks"][0]["A_log"].dtype == torch.float32
    srv = FunctionalServer(cfg, params=params, device="cpu", max_len=16)
    # a prompt shorter than the conv tail leaves zeros before its start
    reqs = [srv.submit(np.arange(n), max_new_tokens=2) for n in (5, 2)]
    srv.run_until_done()
    assert [len(r.generated) for r in reqs] == [2, 2]
