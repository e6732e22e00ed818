"""The port's training path (repro_torch.training, ``loss_fn``, remat and
K3's gradient) against the JAX package, on the same inputs made with numpy
from a seed and the same weights (``params_from_jax``), in fp32 at reduced
sizes on the CPU.

On the CPU ``flash_attention_op``'s forward is its plain version and its
backward the explicit ``flash_attention_bwd`` (the same function the card
runs after K3), and ``ssd_chunk_op`` goes through ``SSDChunkFn`` with the
plain version of K4b (``ssd_chunk_op_bwd_ref``) as its backward; the card
tests (tests/test_torch_cuda.py) hold K3's and K4b's gradients there to the
plain path's.

Tolerances, all fp32: a loss within 1e-5 relative; a gradient leaf within
1e-4 of its largest magnitude (the sums of a backward pass run in another
order in the two frameworks, and each leaf's scale differs by orders of
magnitude); K3's gradients within 2e-5 of theirs (one attention call, as
tests/test_torch_vlm.py holds the forward); one AdamW step within 1e-6
(elementwise fp32 arithmetic on the same inputs).
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.models as jm
import repro.training as jt
from repro.configs import get_config as jax_config
from repro.kernels.flash_attention.ref import flash_attention_ref as jax_flash_ref
from repro.models.layers import cross_entropy_loss as jax_cross_entropy
import repro_torch.training as tt
from repro_torch.configs import get_config
from repro_torch.core import MMAConfig, make_functional_engine
from repro_torch.kernels import FlashAttentionFn, flash_attention_op
from repro_torch.models import cross_entropy_loss, params_from_jax
from repro_torch.training.train_loop import loss_and_grads
from repro_torch.tree import tree_leaves, tree_map

CPU = torch.device("cpu")
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4          # of each leaf's largest magnitude
ATTN_TOL = 2e-5
ADAM_TOL = 1e-6


def _np(t):
    return t.detach().cpu().numpy()


def _pair(name, seed=0, **replace):
    """(jax cfg, port cfg, jax params, port params) on the same weights."""
    jcfg = dataclasses.replace(jax_config(name).reduced(), dtype=jnp.float32, **replace)
    tcfg = dataclasses.replace(get_config(name).reduced(), **replace)
    jp = jm.init_params(jax.random.PRNGKey(seed), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, CPU)
    return jcfg, tcfg, jp, tp


def _batch(cfg, B, S, seed=1, frontend=False):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if frontend:
        batch["frontend"] = rng.standard_normal(
            (B, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
    return batch


def _torch_batch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype.kind == "i"
            else torch.from_numpy(v) for k, v in batch.items()}


def _close_to_scale(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max() / scale
    assert err <= tol, f"{err:.3e} of max |want| {scale:.3e}"


def _port_grads(params, batch, cfg, **kw):
    loss, metrics, grads = loss_and_grads(params, _torch_batch(batch), cfg, **kw)
    return loss, metrics, tree_leaves(grads)


# ---------------------------------------------------------------------------
# The loss
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_jax(masked):
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((3, 17, 50)) * 4).astype(np.float32)
    labels = rng.integers(0, 50, (3, 17)).astype(np.int32)
    mask = (rng.random((3, 17)) < 0.6).astype(np.float32) if masked else None
    want = jax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                             None if mask is None else jnp.asarray(mask))
    got = cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                             None if mask is None else torch.from_numpy(mask))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)


def test_cross_entropy_of_an_empty_mask_is_zero():
    logits = torch.zeros(2, 3, 5)
    labels = torch.zeros(2, 3, dtype=torch.long)
    assert float(cross_entropy_loss(logits, labels, torch.zeros(2, 3))) == 0.0


# jamba cut to one period without experts (one attention and seven SSM
# layers), as tests/test_torch_ssm.py serves it: K3's and K4's gradients in
# one model. Its SSM leaves are ill-conditioned in fp32: against a float64
# run of the JAX model, JAX's fp32 gradients lie up to 1.4e-4 of a leaf's
# max away and the port's 1.6e-4 (the port's autograd through K4's plain
# forward alike), so the two fp32 runs are held to each other at 4e-4.
HYBRID_PERIOD = {"jamba-1.5-large-398b": dict(n_experts=0, n_layers=8)}
HYBRID_GRAD_TOL = 4e-4


@pytest.mark.parametrize("name,frontend", [
    ("tinyllama-1.1b", False),        # dense GQA
    ("olmoe-1b-7b", False),           # MoE: the aux term
    ("mamba2-370m", False),           # SSM
    ("llama-3.2-vision-90b", True),   # cross-attention to a frontend
    ("jamba-1.5-large-398b", False),  # hybrid: attention and SSM layers
])
def test_loss_and_grads_match_jax(name, frontend):
    jcfg, tcfg, jp, tp = _pair(name, **HYBRID_PERIOD.get(name, {}))
    batch = _batch(tcfg, 2, 16, frontend=frontend)
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True),
                                    static_argnums=2)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    loss, met, grads = _port_grads(tp, batch, tcfg)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(met["ce"].item(), float(jmet["ce"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(met["aux"].item(), float(jmet["aux"]), rtol=LOSS_RTOL,
                               atol=1e-7)
    if tcfg.n_experts:
        assert met["aux"].item() > 0
    jleaves = jax.tree.leaves(jgrads)
    assert len(jleaves) == len(grads)
    tol = HYBRID_GRAD_TOL if name in HYBRID_PERIOD else GRAD_TOL
    for g, jg in zip(grads, jleaves):
        assert tuple(g.shape) == jg.shape
        _close_to_scale(_np(g), np.asarray(jg), tol)


def test_loss_and_grads_through_inputs_embeds_match_jax():
    """musicgen trained from frame embeddings: the token embedding is not
    used, and its gradient is zero on both sides."""
    jcfg, tcfg, jp, tp = _pair("musicgen-large")
    batch = _batch(tcfg, 2, 16)
    batch["inputs_embeds"] = np.random.default_rng(2).standard_normal(
        (2, 16, tcfg.d_model)).astype(np.float32)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True),
                                 static_argnums=2)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    loss, _, grads = _port_grads(tp, batch, tcfg)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_RTOL)
    assert not np.any(np.asarray(jgrads["embedding"]))
    jleaves = jax.tree.leaves(jgrads)
    assert len(jleaves) == len(grads)
    for g, jg in zip(grads, jleaves):
        assert tuple(g.shape) == jg.shape
        _close_to_scale(_np(g), np.asarray(jg), GRAD_TOL)


def test_remat_gives_the_same_grads():
    _, tcfg, _, tp = _pair("tinyllama-1.1b")
    batch = _batch(tcfg, 2, 16)
    l1, _, g1 = _port_grads(tp, batch, tcfg, remat=True)
    l0, _, g0 = _port_grads(tp, batch, tcfg, remat=False)
    assert float(l1) == float(l0)
    for a, b in zip(g1, g0):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# K3's gradient
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("R", [1, 4])
@pytest.mark.parametrize("S,T,causal,window,q_offset", [
    (32, 32, True, 0, 0),             # causal prefill
    (32, 32, True, 8, 0),             # sliding window
    (16, 48, True, 0, 32),            # a later chunk of a prompt
    (16, 48, True, 12, 32),
    (24, 40, False, 0, 0),            # cross-attention
    (40, 64, True, 16, 48),           # the last 9 rows see no key (past T with a window)
])
def test_flash_attention_backward_matches_jax(S, T, causal, window, q_offset, R):
    B, G, D = 2, 2, 16
    H = G * R
    rng = np.random.default_rng(7)
    q, do = (rng.standard_normal((B, S, H, D)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((B, T, G, D)).astype(np.float32) for _ in range(2))
    kw = dict(causal=causal, window=window, q_offset=q_offset)

    def jax_out(q, k, v):            # the JAX oracle in the model's layout
        o = jax_flash_ref(q.transpose(0, 2, 1, 3), k.transpose(0, 2, 1, 3),
                          v.transpose(0, 2, 1, 3), **kw)
        return o.transpose(0, 2, 1, 3)

    @jax.jit
    def jax_vjp(q, k, v, do):
        o, vjp = jax.vjp(jax_out, q, k, v)
        return o, vjp(do)

    jo, want = jax_vjp(*(jnp.asarray(a) for a in (q, k, v, do)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = flash_attention_op(tq, tk, tv, **kw)
    assert out.grad_fn is not None and type(out.grad_fn).__name__.startswith(
        FlashAttentionFn.__name__)
    np.testing.assert_allclose(_np(out), np.asarray(jo), rtol=ATTN_TOL, atol=ATTN_TOL)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=ATTN_TOL, atol=ATTN_TOL)


def test_flash_attention_backward_does_not_differentiate_the_plain_version():
    """The backward is the explicit function: autograd records one node
    for the whole op, none for the plain version's einsums and softmax."""
    q = torch.randn(1, 8, 2, 16, requires_grad=True)
    k = torch.randn(1, 8, 1, 16, requires_grad=True)
    v = torch.randn(1, 8, 1, 16, requires_grad=True)
    out = flash_attention_op(q, k, v)
    assert type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
    assert {type(f[0]).__name__ for f in out.grad_fn.next_functions} == {"AccumulateGrad"}


def test_a_launch_autograd_would_record_is_refused():
    """The guard every kernel launch passes (K3's inside FlashAttentionFn,
    whose forward runs with grad mode off): it raises only where a
    gradient was asked for."""
    from repro_torch.kernels.build import refuse_grad

    x, y = torch.zeros(2, requires_grad=True), torch.zeros(2)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        refuse_grad("k", y, x, why="test")
    refuse_grad("k", y, why="test")
    with torch.no_grad():
        refuse_grad("k", x, why="test")


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------
def test_lr_schedule_matches_jax():
    cfg = dict(lr=1e-3, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    jcfg, tcfg = jt.AdamWConfig(**cfg), tt.AdamWConfig(**cfg)
    for s in (0, 1, 5, 10, 11, 37, 99, 100, 150):
        want = np.float32(jt.lr_schedule(jcfg, jnp.int32(s)))
        got = tt.lr_schedule(tcfg, torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.item(), want, rtol=ADAM_TOL, err_msg=f"step {s}")


@pytest.mark.parametrize("clip", [1.0, 1e-3])
def test_adamw_step_matches_jax(clip):
    """One AdamW step on identical params, grads and moments (a 1-D leaf
    to skip decay, a clipped and an unclipped case), then a second step."""
    rng = np.random.default_rng(3)
    shapes = {"w": (6, 5), "scale": (5,), "blocks": [{"wq": (2, 5, 4)}]}
    params = jax.tree.map(lambda s: rng.standard_normal(s).astype(np.float32), shapes,
                          is_leaf=lambda s: isinstance(s, tuple))
    grads = [jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32),
                          params) for _ in range(2)]
    cfg = dict(lr=1e-2, warmup_steps=1, total_steps=10, grad_clip=clip)
    jcfg, tcfg = jt.AdamWConfig(**cfg), tt.AdamWConfig(**cfg)
    jax_update = jax.jit(jt.adamw_update, static_argnums=0)
    jp, js = jax.tree.map(jnp.asarray, params), jt.init_adamw(params)
    tp = tree_map(torch.from_numpy, params)
    ts = tt.init_adamw(tp)
    for g in grads:
        jp, js, jmet = jax_update(jcfg, jp, jax.tree.map(jnp.asarray, g), js)
        tp, ts, tmet = tt.adamw_update(tcfg, tp, tree_map(torch.from_numpy, g), ts)
        assert int(ts.step) == int(js.step)
        np.testing.assert_allclose(float(tmet["grad_norm"]), float(jmet["grad_norm"]),
                                   rtol=ADAM_TOL)
        np.testing.assert_allclose(float(tmet["lr"]), float(jmet["lr"]), rtol=ADAM_TOL)
        for tree_t, tree_j in ((tp, jp), (ts.mu, js.mu), (ts.nu, js.nu)):
            for a, b in zip(tree_leaves(tree_t), jax.tree.leaves(tree_j)):
                np.testing.assert_allclose(_np(a), np.asarray(b), rtol=ADAM_TOL,
                                           atol=ADAM_TOL)


def test_adamw_keeps_bf16_params_and_fp32_moments():
    p = {"w": torch.ones(4, 4, dtype=torch.bfloat16), "s": torch.ones(4)}
    g = tree_map(torch.ones_like, p)
    new, st, _ = tt.adamw_update(tt.AdamWConfig(warmup_steps=0), p, g, tt.init_adamw(p))
    assert new["w"].dtype == torch.bfloat16 and new["s"].dtype == torch.float32
    assert all(t.dtype == torch.float32 for t in tree_leaves((st.mu, st.nu)))
    assert st.step.dtype == torch.int32 and int(st.step) == 1


# ---------------------------------------------------------------------------
# The train step and loop
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mb", [1, 2])
def test_train_step_matches_jax(mb):
    """The whole step, gradients through the model + AdamW, from the same
    params and batch: the new params within ADAM_TOL. Adam's first step is
    g / (|g| + eps) elementwise, which turns a gradient entry near zero
    into +-lr whatever its last bits; eps = 1, no decay and no clipping
    make the step continuous in g (updates up to lr / 2 = 5e-3), so its
    error is the gradients' (AdamW alone is held at the defaults above)."""
    jcfg, tcfg, jp, tp = _pair("tinyllama-1.1b")
    batch = _batch(tcfg, 4, 16)
    opt = dict(lr=1e-2, warmup_steps=0, total_steps=10, eps=1.0, weight_decay=0.0,
               grad_clip=1e6)
    jstep = jax.jit(jt.make_train_step(jcfg, jt.TrainConfig(
        microbatches=mb, opt=jt.AdamWConfig(**opt))))
    tstep = tt.make_train_step(tcfg, tt.TrainConfig(microbatches=mb,
                                                    opt=tt.AdamWConfig(**opt)))
    jp2, _, jm_ = jstep(jp, jt.init_adamw(jp), {k: jnp.asarray(v) for k, v in batch.items()})
    tp2, _, tm = tstep(tp, tt.init_adamw(tp), _torch_batch(batch))
    np.testing.assert_allclose(float(tm["loss"]), float(jm_["loss"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm_["grad_norm"]),
                               rtol=GRAD_TOL)
    moved = 0.0
    for a, b, p in zip(tree_leaves(tp2), jax.tree.leaves(jp2), tree_leaves(tp)):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=ADAM_TOL, atol=ADAM_TOL)
        moved = max(moved, float((a - p).abs().max()))
    assert moved > 1e-3


def test_microbatches_match_full_batch():
    """As tests/test_training.py holds the JAX step: 4 microbatches against
    1 give the same loss and update up to accumulation-order rounding."""
    _, tcfg, _, tp = _pair("tinyllama-1.1b")
    batch = _torch_batch(_batch(tcfg, 8, 32))
    full = tt.make_train_step(tcfg, tt.TrainConfig(microbatches=1, remat=False))
    micro = tt.make_train_step(tcfg, tt.TrainConfig(microbatches=4, remat=False))
    p1, _, m1 = full(tp, tt.init_adamw(tp), batch)
    p2, _, m2 = micro(tp, tt.init_adamw(tp), batch)
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=1e-4)
    d = max((a - b).abs().max().item()
            for a, b in zip(tree_leaves(p1), tree_leaves(p2)))
    assert d < 5e-4


def test_train_loss_decreases_on_the_cpu():
    _, tcfg, _, tp = _pair("tinyllama-1.1b")
    data = tt.SyntheticTokenStream(tt.DataConfig(vocab=tcfg.vocab, seq_len=32,
                                                 global_batch=8))
    seen = []
    tc = tt.TrainConfig(steps=12, log_every=4, microbatches=2,
                        opt=tt.AdamWConfig(lr=3e-3, warmup_steps=3, total_steps=12))
    params, opt, hist = tt.train(tcfg, tp, iter(data), tc, device="cpu",
                                 on_step=lambda s, m: seen.append(s))
    assert seen == [0, 4, 8, 11] and [h["step"] for h in hist] == seen
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert hist[-1]["loss"] < hist[0]["loss"] - 0.1
    assert int(opt.step) == 12 and data.step == 12
    assert all(t.device == CPU and not t.requires_grad for t in tree_leaves(params))


def test_train_resumes_from_a_checkpoint(tmp_path):
    """4 steps, a checkpoint round trip through the engine, 4 more steps
    from the restored state and data cursor: the same params and moments
    as 8 steps in one call."""
    _, tcfg, _, tp = _pair("tinyllama-1.1b")
    dcfg = tt.DataConfig(vocab=tcfg.vocab, seq_len=16, global_batch=4)
    tc = lambda steps: tt.TrainConfig(steps=steps, log_every=1, opt=tt.AdamWConfig(
        lr=3e-3, warmup_steps=2, total_steps=8))
    whole = tt.SyntheticTokenStream(dcfg)
    p8, o8, _ = tt.train(tcfg, tp, iter(whole), tc(8), device="cpu")
    part = tt.SyntheticTokenStream(dcfg)
    p4, o4, _ = tt.train(tcfg, tp, iter(part), tc(4), device="cpu")
    path = str(tmp_path / "ckpt.npz")
    tt.save_checkpoint(path, p4, o4, step=int(o4.step), data_step=part.step, engine=_engine())
    p4, o4, step, data_step = tt.restore_checkpoint(path, p4, o4, engine=_engine())
    part.seek(data_step)
    assert (step, data_step) == (4, 4)
    p8r, o8r, hist = tt.train(tcfg, p4, iter(part), tc(4), device="cpu", opt_state=o4)
    assert [h["step"] for h in hist] == [0, 1, 2, 3] and int(o8r.step) == 8
    for a, b in zip(tree_leaves((p8, o8)), tree_leaves((p8r, o8r))):
        assert torch.equal(a, b)


def test_train_needs_a_card_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg, _, tp = _pair("tinyllama-1.1b")
    data = tt.SyntheticTokenStream(tt.DataConfig(vocab=tcfg.vocab, seq_len=8,
                                                 global_batch=2))
    with pytest.raises(RuntimeError, match="CUDA"):
        tt.train(tcfg, tp, iter(data), tt.TrainConfig(steps=1))


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------
def _engine():
    return make_functional_engine(
        devices=[CPU], config=MMAConfig(chunk_bytes=1 << 16, fallback_bytes=1 << 14))


def test_checkpoint_round_trip_through_the_torch_backend(tmp_path):
    """Params (fp32 and bf16 leaves) and AdamW state saved through
    multipath_device_get and restored through multipath_device_put (K1's
    plain version on the CPU), bit-exact, with step and data step."""
    _, tcfg, _, tp = _pair("tinyllama-1.1b")
    tp["embedding"] = tp["embedding"].to(torch.bfloat16)
    opt = tt.init_adamw(tp)
    opt = opt._replace(mu=tree_map(lambda t: torch.randn(t.shape), opt.mu))
    eng = _engine()
    path = str(tmp_path / "ckpt.npz")
    nbytes = tt.save_checkpoint(path, tp, opt, step=5, data_step=17, engine=eng)
    moved = sum(t.numel() * t.element_size() for t in tree_leaves((tp, opt))
                if t.numel() * t.element_size() >= eng.config.fallback_bytes)
    assert moved > 0 and nbytes >= moved
    p2, o2, step, dstep = tt.restore_checkpoint(path, tp, opt, engine=eng)
    assert (step, dstep) == (5, 17)
    assert isinstance(o2, tt.AdamWState)
    for a, b in zip(tree_leaves((tp, opt)), tree_leaves((p2, o2))):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.view(torch.uint8) if a.dim() else a,
                           b.view(torch.uint8) if b.dim() else b)


def test_jax_written_checkpoint_restores_in_the_port(tmp_path):
    """A file written by the JAX package's save_checkpoint (npz keys from
    tree_flatten_with_path; a bf16 leaf stored as raw bytes) restores in
    the port leaf for leaf, bit for bit."""
    jcfg, tcfg, jp, tp = _pair("tinyllama-1.1b")
    jp = dict(jp, embedding=jp["embedding"].astype(jnp.bfloat16))
    tp = dict(tp, embedding=tp["embedding"].to(torch.bfloat16))
    jopt = jt.init_adamw(jp)
    jopt = jopt._replace(step=jnp.int32(3), mu=jax.tree.map(lambda a: a + 0.5, jopt.mu))
    path = os.path.join(tmp_path, "jax.npz")
    jt.save_checkpoint(path, jp, jopt, step=3, data_step=9)
    p2, o2, step, dstep = tt.restore_checkpoint(path, tp, tt.init_adamw(tp),
                                                engine=_engine())
    assert (step, dstep) == (3, 9) and int(o2.step) == 3
    for a, b in zip(tree_leaves((p2, o2)), jax.tree.leaves((jp, jopt))):
        b = np.asarray(b)
        if b.dtype == ml_dtypes.bfloat16:
            assert a.dtype == torch.bfloat16
            assert np.array_equal(a.view(torch.int16).numpy(), b.view(np.int16))
        else:
            assert np.array_equal(_np(a), b)


def test_port_checkpoint_has_the_jax_keys(tmp_path):
    jcfg, tcfg, jp, tp = _pair("tinyllama-1.1b")
    tpath, jpath = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    tt.save_checkpoint(tpath, tp, tt.init_adamw(tp), step=1)
    jt.save_checkpoint(jpath, jp, jt.init_adamw(jp), step=1)
    t, j = np.load(tpath), np.load(jpath)
    assert sorted(t.files) == sorted(j.files)
    for key in j.files:
        assert t[key].dtype == j[key].dtype and np.array_equal(t[key], j[key]), key
