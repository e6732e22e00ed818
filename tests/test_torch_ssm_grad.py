"""K4's gradient on the CPU: the plain version of K4b (``ssd_chunk_bwd_ref``,
a closed form, not autograd) against ``jax.vjp`` of the JAX package's K4
oracle, ``ssd_op``'s gradients (K4 through ``SSDChunkFn`` plus the
inter-chunk scan) against ``jax.vjp`` of ``repro.models.ssm.ssd_chunked``,
``SSDChunkFn`` against autograd through the plain forward, the SSM block
calling it, and a reduced Mamba2 trained by ``train()``.

Inputs are made with numpy from a seed and handed to both packages, in
fp32. Tolerances: 2e-5 of each gradient's largest magnitude against JAX
(the sums run in another order), 1e-5 against autograd in the same
package. tests/test_torch_cuda.py holds the kernel, K4b, to the plain
version on the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.models.ssm as jssm
from repro.kernels.ssd_chunk.ref import ssd_chunk_ref as jax_ssd_chunk_ref
import repro_torch.models.ssm as tssm
import repro_torch.training as tt
from repro_torch.configs import get_config
from repro_torch.kernels import (
    SSDChunkFn,
    ssd_chunk_bwd,
    ssd_chunk_bwd_ref,
    ssd_chunk_op,
    ssd_chunk_op_bwd_ref,
    ssd_chunk_op_ref,
    ssd_op,
)
from repro_torch.models import init_params
from repro_torch.tree import tree_leaves

JAX_TOL = 2e-5           # of each gradient's largest magnitude
TORCH_TOL = 1e-5


def _decays(rng, shape, decay):
    """(a, dt): ``fast`` a = -softplus(randn), about -0.8 a step; ``slow``
    Mamba2's decays, a = -A dt with A over U(1, 16) and dt over log-uniform
    [1e-3, 1e-1] by quantiles across the heads (the last axis), dt
    jittered per position, so every key and state position counts."""
    if decay == "fast":
        return -np.log1p(np.exp(rng.standard_normal(shape))), None
    h = shape[-1]
    q = (np.arange(h) + 0.5) / h
    A = 1 + 15 * rng.permutation(q)
    dt = 1e-3 * 100 ** rng.permutation(q) * (0.5 + rng.random(shape))
    return -A * dt, dt


def _model_inputs(b, l, h, p, n, g, decay, seed):
    """xbar, a, B, C in the model's layout, fp32 numpy."""
    rng = np.random.default_rng(seed)
    a, dt = _decays(rng, (b, l, h), decay)
    x = rng.standard_normal((b, l, h, p))
    xbar = x * 0.3 if dt is None else x * dt[..., None]
    B, C = (rng.standard_normal((b, l, g, n)) * 0.3 for _ in range(2))
    return [t.astype(np.float32) for t in (xbar, a, B, C)]


def _close_to_scale(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.isfinite(want).all() and got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max() / scale
    assert err <= tol, f"{err:.3e} of max |want| {scale:.3e}"


def _np(t):
    return t.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# The plain backward against jax.vjp of the JAX oracle
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("decay", ["fast", "slow"])
@pytest.mark.parametrize("Q", [32, 64])
@pytest.mark.parametrize("N", [16, 128])
@pytest.mark.parametrize("P", [16, 64])
def test_ssd_chunk_bwd_ref_matches_jax_vjp(decay, Q, N, P):
    """In the fused (BH, nc, Q, .) layout, cotangents on all three
    outputs; the oracle vmapped over BH, as the JAX ops.py runs it."""
    BH, nc = 4, 2
    rng = np.random.default_rng(Q + N + P)
    a, dt = _decays(rng, (BH, nc, Q), decay)
    x = rng.standard_normal((BH, nc, Q, P))
    x = x * 0.3 if dt is None else x * dt[..., None]
    B, C = (rng.standard_normal((BH, nc, Q, N)) * 0.3 for _ in range(2))
    dy = rng.standard_normal((BH, nc, Q, P))
    dstates = rng.standard_normal((BH, nc, P, N))
    ddecay = rng.standard_normal((BH, nc, Q))
    ins = [t.astype(np.float32) for t in (x, a, B, C)]
    cots = [t.astype(np.float32) for t in (dy, dstates, ddecay)]
    _, vjp = jax.vjp(jax.vmap(jax_ssd_chunk_ref), *(jnp.asarray(t) for t in ins))
    want = vjp(tuple(jnp.asarray(t) for t in cots))
    got = ssd_chunk_bwd_ref(*(torch.from_numpy(t) for t in ins + cots))
    assert [t.dtype for t in got] == [torch.float32] * 4
    for g, w in zip(got, want):
        _close_to_scale(_np(g), np.asarray(w), JAX_TOL)


def test_ssd_chunk_bwd_ref_keeps_the_inputs_dtypes():
    """dx, dB and dC in the inputs' dtype, da in fp32; the fused wrapper
    runs the plain version on the CPU."""
    rng = np.random.default_rng(0)
    x, B, C = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).bfloat16()
               for s in ((2, 1, 16, 8), (2, 1, 16, 4), (2, 1, 16, 4)))
    a = -torch.rand(2, 1, 16)
    dy, dst, dd = x.clone(), torch.randn(2, 1, 8, 4), torch.randn(2, 1, 16)
    before = ssd_chunk_bwd.launches
    got = ssd_chunk_bwd(x, a, B, C, dy, dst, dd)
    assert ssd_chunk_bwd.launches == before
    assert [t.dtype for t in got] == [torch.bfloat16, torch.float32] + [torch.bfloat16] * 2
    for g, w in zip(got, ssd_chunk_bwd_ref(x, a, B, C, dy, dst, dd)):
        assert torch.equal(g, w)


# ---------------------------------------------------------------------------
# ssd_op (K4 through SSDChunkFn + the inter-chunk scan) against ssd_chunked
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("decay", ["fast", "slow"])
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("g,l", [(1, 64), (1, 50), (2, 50)])
def test_ssd_op_grads_match_jax_vjp(g, l, with_state, decay):
    """Gradients of y and the final state with respect to xbar, a, B, C
    and the initial state; a ragged l = 50 pads the last chunk of 16."""
    b, h, p, n, chunk = 2, 4, 8, 16, 16
    ins = _model_inputs(b, l, h, p, n, g, decay, seed=3 * l + g)
    rng = np.random.default_rng(11)
    if with_state:
        ins.append((rng.standard_normal((b, h, p, n)) * 0.3).astype(np.float32))
    dy = rng.standard_normal((b, l, h, p)).astype(np.float32)
    ds = rng.standard_normal((b, h, p, n)).astype(np.float32)

    def jax_fn(*args):
        return jssm.ssd_chunked(*args[:4], chunk, args[4] if with_state else None)

    (jy, js), vjp = jax.vjp(jax_fn, *(jnp.asarray(t) for t in ins))
    want = vjp((jnp.asarray(dy), jnp.asarray(ds)))
    leaves = [torch.from_numpy(t).requires_grad_(True) for t in ins]
    y, s = ssd_op(*leaves[:4], chunk, leaves[4] if with_state else None)
    assert y.grad_fn is not None
    got = torch.autograd.grad((y, s), leaves, (torch.from_numpy(dy), torch.from_numpy(ds)))
    np.testing.assert_allclose(_np(y), np.asarray(jy), rtol=JAX_TOL, atol=JAX_TOL)
    np.testing.assert_allclose(_np(s), np.asarray(js), rtol=JAX_TOL, atol=JAX_TOL)
    assert len(got) == len(want)
    for gt, w in zip(got, want):
        _close_to_scale(_np(gt), np.asarray(w), JAX_TOL)


# ---------------------------------------------------------------------------
# SSDChunkFn against autograd through the plain forward
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("g,l,chunk", [(1, 64, 16), (2, 50, 16), (2, 40, 64)])
def test_ssd_chunk_op_grad_matches_autograd_through_the_plain_version(g, l, chunk):
    b, h, p, n = 2, 4, 8, 16
    ins = _model_inputs(b, l, h, p, n, g, "slow", seed=l)
    leaves = [torch.from_numpy(t).requires_grad_(True) for t in ins]
    out = ssd_chunk_op(*leaves, chunk)
    assert type(out[0].grad_fn).__name__ == "SSDChunkFnBackward"
    rng = np.random.default_rng(5)
    cots = [torch.from_numpy(rng.standard_normal(o.shape).astype(np.float32)) for o in out]
    got = torch.autograd.grad(out, leaves, cots)
    plain = [torch.from_numpy(t).requires_grad_(True) for t in ins]
    want = torch.autograd.grad(ssd_chunk_op_ref(*plain, chunk), plain, cots)
    for gt, w in zip(got, want):
        _close_to_scale(_np(gt), _np(w), TORCH_TOL)
    # the backward is the explicit plain version in the model's layout
    for gt, w in zip(got, ssd_chunk_op_bwd_ref(*(torch.from_numpy(t) for t in ins), chunk,
                                               *cots)):
        assert torch.equal(gt, w)


def test_ssd_chunk_op_backward_does_not_differentiate_the_plain_version():
    """Autograd records one node for the whole op, none for the plain
    version's einsums."""
    ins = _model_inputs(1, 16, 2, 4, 8, 1, "fast", seed=0)
    leaves = [torch.from_numpy(t).requires_grad_(True) for t in ins]
    y, _, _ = ssd_chunk_op(*leaves, 8)
    assert {type(f[0]).__name__ for f in y.grad_fn.next_functions} == {"AccumulateGrad"}


@pytest.mark.parametrize("no_grad", [True, False])
def test_ssd_chunk_op_without_grad_leaves_the_autograd_function_out(no_grad):
    """Under no_grad, or with no input that requires grad (a served call),
    ``ssd_chunk_op`` calls the kernel's route straight, with no autograd
    node, and gives the plain version's outputs on the CPU."""
    ins = [torch.from_numpy(t) for t in _model_inputs(1, 24, 2, 4, 8, 1, "slow", seed=3)]
    calls = []
    apply = SSDChunkFn.apply

    def spy(*args):
        calls.append(args[4])
        return apply(*args)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(SSDChunkFn, "apply", spy)
        with torch.set_grad_enabled(not no_grad):
            out = ssd_chunk_op(*ins, 8)
    assert calls == [] and all(o.grad_fn is None for o in out)
    for o, w in zip(out, ssd_chunk_op_ref(*ins, 8)):
        assert torch.equal(o, w)

def test_mamba_block_calls_ssd_chunk_fn():
    """The SSM block's scan reaches K4 through SSDChunkFn (once a block),
    and its gradient flows to every leaf of the block (the layer's norm
    ``ln1`` lies outside it)."""
    cfg = get_config("mamba2-370m").reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    layer = {k: v[0].detach().clone().requires_grad_(True)
             for k, v in params["blocks"][0].items() if k != "ln1"}
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 40, cfg.d_model)).astype(np.float32))
    calls = []
    apply = SSDChunkFn.apply

    def spy(*args):
        calls.append(args[4])
        return apply(*args)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(SSDChunkFn, "apply", spy)
        out = tssm.mamba_block(layer, x, cfg)
    assert calls == [cfg.ssm_chunk]
    grads = torch.autograd.grad(out.square().sum(), list(layer.values()))
    assert all(torch.isfinite(g).all() and g.abs().max() > 0 for g in grads)


# ---------------------------------------------------------------------------
# train() on a reduced Mamba2
# ---------------------------------------------------------------------------
def test_train_reduced_mamba2_loss_falls_on_the_cpu():
    cfg = get_config("mamba2-370m").reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    data = tt.SyntheticTokenStream(tt.DataConfig(vocab=cfg.vocab, seq_len=32,
                                                 global_batch=8))
    tc = tt.TrainConfig(steps=24, log_every=1, remat=True,
                        opt=tt.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=24))
    # small ops: one thread keeps the test fast when test workers share the
    # cores (torch's thread pool oversubscribes them otherwise)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        params, opt, hist = tt.train(cfg, params, iter(data), tc, device="cpu")
    finally:
        torch.set_num_threads(threads)
    losses = [h["loss"] for h in hist]
    assert len(losses) == 24 and all(np.isfinite(losses))
    # each batch is a fresh draw, so compare the first and last three steps
    assert np.mean(losses[-3:]) < np.mean(losses[:3]) - 0.2
    assert int(opt.step) == 24
    assert all(torch.isfinite(t).all() and not t.requires_grad for t in tree_leaves(params))
