"""A Mamba2 prefill continued from a state equals the one-pass prefill.

``mamba_mix`` reads the conv tails of ``initial_state`` (the raw
projections of the last ``conv_width - 1`` positions) ahead of the new
positions, so prefill(0..5) then prefill(6..9) from the returned state
gives the outputs, SSM state and tails of prefill(0..9). The JAX
package's ``mamba_block`` ignores those tails (a reference fault the port
avoids), so the continuation is held to the port's own one-pass prefill;
with no state the port still matches JAX's ``mamba_block``.

CPU, fp32, ``mamba2-370m`` reduced with seed-0 weights from the JAX
initialiser, inputs from numpy. Tolerance: 1e-5 of the largest magnitude
(summation order only); a zero state gives the same bits as none.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.models as jm
import repro.models.ssm as jssm
from repro.configs import get_config as jax_config
from repro_torch.configs import get_config
from repro_torch.models import init_ssm_state, mamba_block, params_from_jax
from repro_torch.models.ssm import _project, mamba_mix

CPU = torch.device("cpu")
REL = 1e-5


@pytest.fixture(scope="module")
def layer():
    jcfg = dataclasses.replace(jax_config("mamba2-370m").reduced(), dtype=jnp.float32)
    tcfg = get_config("mamba2-370m").reduced()
    assert tcfg.dtype == torch.float32 and tcfg.conv_width - 1 == 3
    jp = jm.init_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, CPU)
    jl = jax.tree.map(lambda t: t[0], jp["blocks"][0])
    tl = {k: v[0] for k, v in tp["blocks"][0].items()}
    x = (np.random.default_rng(1).standard_normal((2, 10, tcfg.d_model))).astype(np.float32)
    return jcfg, tcfg, jl, tl, torch.from_numpy(x)


def _close(got, want, what):
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    assert err <= REL * scale, f"{what}: {err:.3e} > {REL} of max {scale:.3e}"


@pytest.mark.parametrize("split", [6, 9, 8, 1])
def test_prefill_from_the_returned_state_equals_one_prefill(layer, split):
    """Positions [0, split) then [split, 10) from the returned state: a
    continuation of 4 positions, of 1 and 2 (shorter than the tail of 3,
    so the older tail positions must carry over) and a first pass of 1."""
    _, cfg, _, tl, x = layer
    one, s1 = mamba_block(tl, x, cfg, return_state=True)
    first, s = mamba_block(tl, x[:, :split], cfg, return_state=True)
    second, s2 = mamba_block(tl, x[:, split:], cfg, return_state=True, initial_state=s)
    _close(torch.cat([first, second], 1), one, "out")
    for name in ("ssm", "conv_x", "conv_B", "conv_C"):
        _close(s2[name], s1[name], name)


def test_returned_tails_are_the_last_raw_projections(layer):
    """After 8 + 1 positions the tails hold raw projections 6, 7 and 8:
    two from the first prefill's state, one from the second."""
    _, cfg, _, tl, x = layer
    _, s = mamba_block(tl, x[:, :8], cfg, return_state=True)
    _, s2 = mamba_block(tl, x[:, 8:9], cfg, return_state=True, initial_state=s)
    raws = [_project(tl, part, cfg)[1:4] for part in (x[:, :8], x[:, 8:9])]
    for i, name in enumerate(("conv_x", "conv_B", "conv_C")):
        assert torch.equal(s2[name], torch.cat([raws[0][i][:, 6:], raws[1][i]], 1)), name


def test_zero_state_gives_the_same_bits_as_none(layer):
    _, cfg, _, tl, x = layer
    none, s_none = mamba_block(tl, x, cfg, return_state=True)
    zero, s_zero = mamba_block(tl, x, cfg, return_state=True,
                               initial_state=init_ssm_state(cfg, x.shape[0]))
    assert torch.equal(none, zero)
    for name in s_none:
        assert torch.equal(s_none[name], s_zero[name]), name


def test_the_port_still_matches_jax_with_no_state(layer):
    jcfg, cfg, jl, tl, x = layer
    jo, js = jssm.mamba_block(jl, jnp.asarray(x.numpy()), jcfg, return_state=True)
    to, ts = mamba_block(tl, x, cfg, return_state=True)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=2e-4, atol=2e-4)
    for name in ts:
        np.testing.assert_allclose(ts[name].numpy(), np.asarray(js[name]),
                                   rtol=2e-4, atol=2e-4, err_msg=name)


def test_jax_mamba_block_ignores_the_tails(layer):
    """The reference fault: JAX's continuation lies far from its one-pass
    prefill, where the port's is within 1e-5 of max."""
    jcfg, _, jl, _, x = layer
    xj = jnp.asarray(x.numpy())
    one = np.asarray(jssm.mamba_block(jl, xj, jcfg))
    _, s = jssm.mamba_block(jl, xj[:, :6], jcfg, return_state=True)
    second = np.asarray(jssm.mamba_block(jl, xj[:, 6:], jcfg, initial_state=s))
    assert np.abs(second - one[:, 6:]).max() > 100 * REL * np.abs(one).max()


def test_continuation_holds_on_the_rank_heads(layer):
    """The head-parallel mixer hands ``mamba_mix`` a rank's heads, their
    channels of z and x (and of ``conv_x``'s tail), B and C whole. On the
    first half of the heads, two passes equal one there too."""
    _, cfg, _, tl, x = layer
    h, p = cfg.ssm_heads // 2, cfg.ssm_head_dim
    ch = h * p
    local = dict(tl, conv_x_w=tl["conv_x_w"][:, :ch])
    for k in ("conv_x_b", "norm"):
        local[k] = tl[k][:ch]
    for k in ("dt_bias", "A_log", "D"):
        local[k] = tl[k][:h]
    z, xin, Bp, Cp, dt = _project(tl, x, cfg)
    z, xin, dt = z[..., :ch], xin[..., :ch], dt[..., :h]

    def mix(sl, state=None):
        return mamba_mix(local, z[:, sl], xin[:, sl], Bp[:, sl], Cp[:, sl], dt[:, sl], cfg,
                         state)

    one, s1 = mix(slice(0, 10))
    first, s = mix(slice(0, 7))
    assert s["conv_x"].shape[-1] == ch and s["ssm"].shape[1] == h
    second, s2 = mix(slice(7, 10), s)
    _close(torch.cat([first, second], 1), one, "y")
    for name in s1:
        _close(s2[name], s1[name], name)
