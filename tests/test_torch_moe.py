"""The port's MoE channel (repro_torch.models.moe), the layer stacks that
carry it (OLMoE, llama4's dense/MoE interleave, a jamba period with
experts) and the server, against the JAX package's, on the same inputs
made with numpy from a seed and the same weights (``params_from_jax``), in
fp32 at reduced sizes. No Pallas kernel is on the JAX side of this path.

Tolerances: 2e-5 for ``moe_ffn`` and its aux (summation order in fp32),
for the output relative to its largest magnitude: the JAX init scales
expert weights by E^-0.5, not by their fan-in, so outputs reach several
hundred and an entry near zero carries the rounding of that scale. 2e-4
for logits after a whole model (as tests/test_torch_models.py). Routes,
capacities and drop counts are held equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.models as jm
import repro.models.moe as jmoe
import repro.serving as jserving
from repro.configs import get_config as jax_config
from repro.models.init import init_layer as jax_init_layer
from repro_torch.configs import get_config
from repro_torch.kernels import launch_counts
from repro_torch.models import (
    decode_step,
    forward,
    load_balance_loss,
    moe_ffn,
    params_from_jax,
    prefill,
    router,
)
import repro_torch.models.moe as moe
from repro_torch.kernels.moe_dispatch import slot_positions
from repro_torch.models.moe import capacity
from repro_torch.serving import FunctionalServer

CPU = torch.device("cpu")
MOE_TOL = dict(rtol=2e-5, atol=2e-5)
MODEL_TOL = dict(rtol=2e-4, atol=2e-4)
# JAX runs op by op without jit; compiled once per shape, these are faster
jax_moe = jax.jit(jmoe.moe_ffn, static_argnums=(2,), static_argnames=("return_aux",))
jax_router = jax.jit(jmoe.router, static_argnums=(2,))
jax_forward = jax.jit(jm.forward, static_argnums=(2,))
jax_prefill = jax.jit(jm.prefill, static_argnums=(2,), static_argnames=("max_len",))
jax_decode_step = jax.jit(jm.decode_step, static_argnums=(4,))
# (E, K, capacity_factor) of the configured MoE models
REPO_PAIRS = {"olmoe-1b-7b": (64, 8, 1.25), "llama4-maverick-400b-a17b": (128, 1, 2.0),
              "jamba-1.5-large-398b": (16, 2, 1.25)}


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close_to_scale(got, want, tol=2e-5):
    """Each entry within tol of the largest |want|, and within tol relatively."""
    got, want = _np(got), _np(want)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * np.abs(want).max())


def _moe_cfgs(E, K, cf):
    """Reduced OLMoE with E experts, top-K, capacity factor cf (JAX, port)."""
    over = dict(n_experts=E, top_k=K, capacity_factor=cf)
    jcfg = dataclasses.replace(jax_config("olmoe-1b-7b").reduced(), **over)
    tcfg = dataclasses.replace(get_config("olmoe-1b-7b").reduced(), **over)
    return jcfg, tcfg


def _moe_layer(jcfg, tcfg, seed=0):
    """One MoE layer's leaves from the JAX init, as (JAX, port) dicts."""
    jl = jax_init_layer(jax.random.PRNGKey(seed), jcfg, "attn", "moe")
    jl = {k: jl[k] for k in ("router", "w_gate", "w_up", "w_down")}
    return jl, params_from_jax(jax.tree.map(np.asarray, jl), tcfg, CPU)


def _x(cfg, B, S, seed=3):
    return np.random.default_rng(seed).standard_normal((B, S, cfg.d_model)).astype(np.float32)


def _jax_slots(top_i, E):
    """Slot of each assignment as the JAX module computes it (moe.py:53-56)."""
    B, S, K = top_i.shape
    sel = jax.nn.one_hot(top_i, E, dtype=jnp.int32)
    flat = sel.reshape(B, S * K, E)
    pos_flat = jnp.cumsum(flat, axis=1) - flat
    return np.asarray(jnp.sum(pos_flat.reshape(B, S, K, E) * sel, axis=-1))


MOE_CASES = [(4, 2, 8.0), (4, 2, 1.25), (4, 2, 0.5), (8, 1, 2.0)]


@pytest.mark.parametrize("S", [1, 37, 64])
@pytest.mark.parametrize("E,K,cf", MOE_CASES)
def test_moe_ffn_matches_jax(E, K, cf, S):
    jcfg, tcfg = _moe_cfgs(E, K, cf)
    jl, tl = _moe_layer(jcfg, tcfg)
    x = _x(tcfg, 2, S)
    jy, jaux = jax_moe(jl, jnp.asarray(x), jcfg, return_aux=True)
    ty, taux = moe_ffn(tl, torch.from_numpy(x), tcfg, return_aux=True)
    assert ty.shape == (2, S, tcfg.d_model) and ty.dtype == torch.float32
    _close_to_scale(ty, jy)
    np.testing.assert_allclose(taux.item(), float(jaux), **MOE_TOL)


@pytest.mark.parametrize("E,K,cf", MOE_CASES)
def test_routes_and_drops_match_jax(E, K, cf):
    jcfg, tcfg = _moe_cfgs(E, K, cf)
    jl, tl = _moe_layer(jcfg, tcfg)
    x = _x(tcfg, 2, 64)
    jp, ji, jprobs = jax_router(jl, jnp.asarray(x), jcfg)
    tp, ti, tprobs = router(tl, torch.from_numpy(x), tcfg)
    assert ti.numpy().tolist() == np.asarray(ji).tolist()
    np.testing.assert_allclose(tp.numpy(), _np(jp), **MOE_TOL)
    np.testing.assert_allclose(tprobs.numpy(), _np(jprobs), **MOE_TOL)
    np.testing.assert_allclose(load_balance_loss(tprobs, ti, E).item(),
                               float(jmoe.load_balance_loss(jprobs, ji, E)), **MOE_TOL)
    pos = slot_positions(ti, E)
    assert pos.numpy().tolist() == _jax_slots(ji, E).tolist()
    dropped = int((pos >= capacity(64, tcfg)).sum())
    assert dropped == int((_jax_slots(ji, E) >= capacity(64, jcfg)).sum())
    # the cases reach both sides of the capacity: none dropped at cf 8, some at 0.5
    if cf == 8.0:
        assert dropped == 0
    if cf == 0.5:
        assert dropped > 0


@pytest.mark.parametrize("name", sorted(REPO_PAIRS))
def test_capacity_is_the_jax_expression(name):
    """The JAX module's C (moe.py:48-49) for S in 1..600 at a configured
    model's (E, K, capacity_factor); math.ceil would differ."""
    cfg = get_config(name)
    E, K, cf = REPO_PAIRS[name]
    assert (cfg.n_experts, cfg.top_k, cfg.capacity_factor) == (E, K, cf)
    for S in range(1, 601):
        want = min(max(1, int((S * K / E) * cf + 0.9999)), S * K)
        assert capacity(S, cfg) == want, S


def test_capacity_is_the_jax_buffer_size():
    """C read off the JAX module's own scatter (its (B, E, C, d) buffer) at
    OLMoE's E, K and capacity factor, for the lengths the smoke serves."""
    cfg = dataclasses.replace(get_config("olmoe-1b-7b"), d_model=8, d_ff=8)
    jcfg = dataclasses.replace(jax_config("olmoe-1b-7b"), d_model=8, d_ff=8)
    E = cfg.n_experts
    p = {"router": jnp.zeros((8, E)), "w_gate": jnp.zeros((E, 8, 8)),
         "w_up": jnp.zeros((E, 8, 8)), "w_down": jnp.zeros((E, 8, 8))}
    for S, C in ((1, 1), (200, 32), (384, 60), (512, 80)):
        jaxpr = jax.make_jaxpr(lambda p, x: jmoe.moe_ffn(p, x, jcfg))(
            p, jnp.zeros((1, S, 8)))
        scatters = [e for e in jaxpr.eqns if e.primitive.name == "scatter-add"]
        assert [e.outvars[0].aval.shape for e in scatters] == [(1, E, C, 8)]
        assert capacity(S, cfg) == C


def _loop_moe(p, x, cfg):
    """A per-token loop in fp64: each token's top-k experts in descending
    probability, an expert serving the first C assignments of the row in
    token-major then k order."""
    r = p["router"].double().numpy()
    wg, wu, wd = (p[k].double().numpy() for k in ("w_gate", "w_up", "w_down"))
    y = np.zeros(x.shape)
    for b in range(x.shape[0]):
        served = np.zeros(cfg.n_experts, int)
        C = capacity(x.shape[1], cfg)
        for t, xt in enumerate(x[b].astype(np.float64)):
            logits = xt @ r
            probs = np.exp(logits - logits.max())
            probs /= probs.sum()
            top = np.argsort(-probs, kind="stable")[:cfg.top_k]
            w = probs[top] / probs[top].sum()
            for e, wk in zip(top, w):
                if served[e] < C:
                    g = xt @ wg[e]
                    y[b, t] += wk * ((g / (1 + np.exp(-g))) * (xt @ wu[e])) @ wd[e]
                served[e] += 1
    return y


def test_overflowing_expert_keeps_the_token_at_the_last_slot():
    """Every token routes to experts 0 and 1 with C = 2: tokens 0 and 1
    fill both buffers, tokens 2-7 are dropped onto slot C-1 with zero
    contributions, and slot C-1 still carries token 1 (a scatter that
    overwrote instead of adding could leave one of the zeros there)."""
    jcfg, tcfg = _moe_cfgs(4, 2, 0.5)
    jl, tl = _moe_layer(jcfg, tcfg)
    router_w = np.asarray(jl["router"]).copy() * 0.01
    router_w[0, :2] = (10.0, 5.0)
    jl["router"] = jnp.asarray(router_w)
    tl["router"] = torch.from_numpy(router_w)
    x = _x(tcfg, 1, 8) * 0.1
    x[..., 0] = 10.0
    assert capacity(8, tcfg) == 2
    _, top_i, _ = router(tl, torch.from_numpy(x), tcfg)
    assert top_i[0].tolist() == [[0, 1]] * 8
    ty = moe_ffn(tl, torch.from_numpy(x), tcfg).numpy()
    _close_to_scale(ty, jax_moe(jl, jnp.asarray(x), jcfg))
    _close_to_scale(ty, _loop_moe(tl, x, tcfg))
    assert np.abs(ty[0, 1]).max() > 1e-2 and not ty[0, 2:].any()


# ---------------------------------------------------------------------------
# Layer stacks
# ---------------------------------------------------------------------------
def _pair(name, seed=0, **overrides):
    jcfg = dataclasses.replace(jax_config(name).reduced(), dtype=jnp.float32, **overrides)
    tcfg = dataclasses.replace(get_config(name).reduced(), **overrides)
    assert tcfg.dtype == torch.float32
    jp = jm.init_params(jax.random.PRNGKey(seed), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, CPU)
    return jcfg, tcfg, jp, tp


def _tokens(cfg, B, S, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)).astype(np.int32)


STACKS = {
    "olmoe": ("olmoe-1b-7b", {}),
    "llama4": ("llama4-maverick-400b-a17b", {}),
    "jamba_period": ("jamba-1.5-large-398b", {"n_layers": 8}),
}


def test_stacks_have_the_planned_channels():
    olmoe = get_config("olmoe-1b-7b").reduced()
    assert olmoe.layer_plan() == (("attn", "moe"),) and olmoe.n_layers == 2
    llama4 = get_config("llama4-maverick-400b-a17b").reduced()
    assert llama4.layer_plan() == (("attn", "mlp"), ("attn", "moe"))
    assert (llama4.top_k, llama4.capacity_factor) == (1, 2.0)
    jamba = dataclasses.replace(get_config("jamba-1.5-large-398b").reduced(), n_layers=8)
    assert jamba.n_periods == 1 and [m for m, _ in jamba.layer_plan()] == ["attn"] + ["ssm"] * 7
    assert [c for _, c in jamba.layer_plan()] == ["mlp", "moe"] * 4


@pytest.mark.parametrize("stack", sorted(STACKS))
def test_forward_logits_and_aux_match_jax(stack):
    """forward's logits and its summed load-balance loss over every MoE
    layer of the stack."""
    name, over = STACKS[stack]
    jcfg, tcfg, jp, tp = _pair(name, **over)
    toks = _tokens(jcfg, 2, 40)
    jl, _, jaux = jax_forward(jp, jnp.asarray(toks), jcfg)
    tl, _, taux = forward(tp, torch.from_numpy(toks).long(), tcfg)
    np.testing.assert_allclose(tl.numpy(), _np(jl), **MODEL_TOL)
    n_moe = sum(c == "moe" for _, c in tcfg.layer_plan()) * tcfg.n_periods
    assert taux.dtype == torch.float32 and taux.item() > 0.5 * n_moe
    np.testing.assert_allclose(taux.item(), float(jaux), **MOE_TOL)


@pytest.mark.parametrize("stack,steps", [("olmoe", 8), ("llama4", 3), ("jamba_period", 3)])
def test_prefill_and_greedy_decode_match_jax(stack, steps):
    """Prefill logits (a 40-token prompt: capacity drops in the prefill),
    greedy decode steps with equal tokens, and the final caches."""
    name, over = STACKS[stack]
    jcfg, tcfg, jp, tp = _pair(name, **over)
    S = 40
    toks = _tokens(jcfg, 2, S)
    jl, jc, jn = jax_prefill(jp, jnp.asarray(toks), jcfg, max_len=S + steps + 1)
    tl, tc, tn = prefill(tp, torch.from_numpy(toks).long(), tcfg, max_len=S + steps + 1)
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


def test_olmoe_prefill_drops_assignments(monkeypatch):
    """The reduced OLMoE prefill above runs over capacity in some layer:
    the parity there includes drops."""
    _, tcfg, _, tp = _pair("olmoe-1b-7b")
    toks = torch.from_numpy(_tokens(tcfg, 2, 40)).long()
    seen = []

    def spy(params, x, cfg):
        out = router(params, x, cfg)
        seen.append(out[1])
        return out

    monkeypatch.setattr(moe, "router", spy)
    forward(tp, toks, tcfg)
    C = capacity(40, tcfg)
    assert len(seen) == tcfg.n_layers
    assert sum(int((slot_positions(t, tcfg.n_experts) >= C).sum()) for t in seen) > 0


def test_olmoe_decode_matches_forward():
    """Prefill + decode reproduce the full forward pass (teacher forcing).
    At capacity_factor 8 no group drops anything; a decode group (S = 1)
    never does, so only then does a forward pass compute the same thing."""
    _, tcfg, _, tp = _pair("olmoe-1b-7b", capacity_factor=8.0)
    S, extra = 32, 3
    toks = torch.from_numpy(_tokens(tcfg, 2, S + extra)).long()
    assert capacity(S + extra, tcfg) == (S + extra) * tcfg.top_k
    ref, _, _ = forward(tp, toks, tcfg)
    logits, caches, n = prefill(tp, toks[:, :S], tcfg, max_len=S + extra + 1)
    np.testing.assert_allclose(logits.numpy(), ref[:, S - 1].numpy(), **MODEL_TOL)
    for i in range(extra):
        logits, caches = decode_step(tp, toks[:, S + i], caches, n + i, tcfg)
        np.testing.assert_allclose(logits.numpy(), ref[:, S + i].numpy(),
                                   rtol=3e-4, atol=3e-4, err_msg=f"decode step {i}")


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------
def test_functional_server_on_olmoe_matches_jax_server():
    """Same weights and prompts: the same generated tokens, a prefix hit on
    the repeat, the same transfer log, and no kernel launch on the CPU."""
    jcfg = jax_config("olmoe-1b-7b").reduced()
    tcfg = get_config("olmoe-1b-7b").reduced()
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
