"""The last public names of the JAX package in the port, each against its
JAX counterpart on the same numpy inputs:

* ``models.attention.gqa`` / ``causal_mask`` / ``NEG_INF`` /
  ``shard_kv_cache``: JAX's XLA attention with its roundings (scores in the
  inputs' dtype, then fp32; ``p`` in ``v``'s dtype before PV). fp32 at
  2e-5 and bf16 at 2e-2 (tests/test_kernels.py's tolerances), R = 1, 4, 8
  and D = 64, 128, 256, under a causal mask, a window, the decode masks of
  a linear and of a ring cache, and none (cross-attention). The port's
  plain K3/K2 versions in bf16 are held to ``gqa`` in bf16 as well: the
  first bf16 figure for how far the port's attention lies from JAX's.
* ``kernels.relay_assemble_op``: bit-exact against JAX's (the Pallas
  kernel in interpret mode, and ``use_kernel=False``).
* ``launch.roofline.ICI_LINK_GBPS``; ``models.init.init_layer`` /
  ``init_period`` (shapes and dtypes of JAX's and of ``init_params``'s
  leaves).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

import repro.models.attention as jattn
import repro.models.init as jinit
from repro.configs import get_config as jax_config
from repro.kernels import relay_assemble_op as jax_relay_assemble_op
from repro_torch.configs import get_config
from repro_torch.kernels import (
    decode_attention_op_ref,
    flash_attention_op_ref,
    launch_counts,
    relay_assemble_op,
)
from repro_torch.launch.roofline import ICI_LINK_GBPS, LINK_GBPS
from repro_torch.models import causal_mask, gqa, init_layer, init_params, init_period
from repro_torch.models.attention import NEG_INF, shard_kv_cache
from repro_torch.tree import tree_leaves

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _to_torch(a: np.ndarray, dtype: str) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32))
    return t.to(TDT[dtype])


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32)


def _mask(kind: str, Sq: int, T: int):
    """The same mask as JAX builds it (a numpy bool array broadcastable to
    (B, 1, 1, Sq, T)), or None."""
    if kind == "none":
        return None
    if kind in ("causal", "window"):
        pos = jnp.arange(Sq) + (T - Sq)
        m = jattn.causal_mask(pos, jnp.arange(T), 5 if kind == "window" else 0)
    elif kind == "decode_linear":                 # cache_len T - 7: slots <= it valid
        m = (jnp.arange(T) <= T - 7)[None, None, None, None, :]
    else:                                         # a ring of T slots after 2.5 laps
        m = (jattn._ring_kv_positions(jnp.int32(5 * T // 2), T) >= 0)[
            None, None, None, None, :]
    return np.asarray(m)


def _inputs(B, Sq, T, H, G, D, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, D)).astype(np.float32),
            rng.standard_normal((B, T, G, D)).astype(np.float32),
            rng.standard_normal((B, T, G, D)).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mask", ["causal", "window", "decode_linear", "decode_ring", "none"])
@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("R", [1, 4, 8])
def test_gqa_matches_jax(R, D, mask, dtype):
    G = 2
    Sq = 1 if mask.startswith("decode") else 12
    T = 20 if mask != "none" else 9
    q, k, v = _inputs(2, Sq, T, R * G, G, D, seed=R * D)
    m = _mask(mask, Sq, T)
    want = jattn.gqa(*(jnp.asarray(a, JDT[dtype]) for a in (q, k, v)),
                     None if m is None else jnp.asarray(m))
    got = gqa(*(_to_torch(a, dtype) for a in (q, k, v)),
              None if m is None else torch.from_numpy(m.copy()))
    assert got.dtype == TDT[dtype] and tuple(got.shape) == want.shape
    np.testing.assert_allclose(_np(got), _np(want), rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("Sq,T,window,offset", [(7, 7, 0, 0), (5, 12, 0, 7), (9, 9, 4, 0),
                                                (3, 16, 6, 10)])
def test_causal_mask_equals_jax(Sq, T, window, offset):
    q_pos, kv_pos = np.arange(Sq) + offset, np.arange(T)
    want = np.asarray(jattn.causal_mask(jnp.asarray(q_pos), jnp.asarray(kv_pos), window))
    got = causal_mask(torch.from_numpy(q_pos), torch.from_numpy(kv_pos), window)
    assert got.dtype == torch.bool and np.array_equal(got.numpy(), want)


def test_neg_inf_and_shard_kv_cache():
    """JAX's masking constant; with no mesh ``shard_kv_cache`` is the
    identity, as JAX's is outside a mesh."""
    assert NEG_INF == jattn.NEG_INF
    x = torch.zeros(2, 8, 4, 16)
    assert shard_kv_cache(x) is x


# (kind, B, Sq or kv_len, T, H, G, D): two reduced prefill and decode shapes
PLAIN_SHAPES = [("K3", 2, 64, 64, 8, 2, 64), ("K3", 1, 48, 48, 4, 4, 128),
                ("K2", 2, 37, 64, 8, 2, 64), ("K2", 1, 90, 128, 8, 1, 128)]


@pytest.mark.parametrize("kind,B,S,T,H,G,D", PLAIN_SHAPES)
def test_plain_kernels_in_bf16_against_gqa(kind, B, S, T, H, G, D):
    """K3's and K2's plain versions in bf16 (fp32 scores and sums) against
    ``gqa`` in bf16 with JAX's roundings on the same inputs: the gap, below
    2e-2 of max |o|, is printed."""
    q, k, v = (_to_torch(a, "bfloat16") for a in _inputs(B, T if kind == "K3" else 1, T,
                                                          H, G, D, seed=D + H))
    if kind == "K3":
        plain = flash_attention_op_ref(q, k, v, causal=True)
        want = gqa(q, k, v, causal_mask(torch.arange(T), torch.arange(T)))
    else:
        plain = decode_attention_op_ref(q, k, v, S)
        want = gqa(q, k, v, (torch.arange(T) < S)[None, None, None, None, :])
    gap = (plain.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    print(f"{kind} plain vs gqa bf16 {tuple(q.shape)} over {T}: max abs {gap:.4g}, "
          f"{gap / scale:.4g} of max |o|")
    assert gap <= 2e-2 * scale


def _relay_inputs(dtype: str, repeats: bool, n=12, width=40):
    rng = np.random.default_rng(3)
    staged = rng.standard_normal((n, width)).astype(np.float32)
    perm = (rng.integers(0, n, n) if repeats else rng.permutation(n)).astype(np.int32)
    return jnp.asarray(staged, JDT[dtype]), perm


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("repeats", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_relay_assemble_op_bit_exact_against_jax(dtype, repeats, use_kernel):
    """The port's op on the CPU (the plain version: no launch) equals
    JAX's op bit for bit, in interpret mode and through its oracle."""
    staged, perm = _relay_inputs(dtype, repeats)
    want = np.asarray(jax_relay_assemble_op(staged, jnp.asarray(perm), interpret=True,
                                            use_kernel=use_kernel))
    host = np.asarray(staged)
    if dtype == "bfloat16":                      # ml_dtypes: through its bits
        ts = torch.from_numpy(host.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        ts = torch.from_numpy(host.copy())
    before = launch_counts()["relay_assemble"]
    got = relay_assemble_op(ts, torch.from_numpy(perm), use_kernel=use_kernel)
    assert launch_counts()["relay_assemble"] == before
    bits = got.view(torch.int16).numpy() if dtype == "bfloat16" else got.view(
        torch.int32).numpy()
    assert np.array_equal(bits, want.view(np.int16 if dtype == "bfloat16" else np.int32))


def test_ici_link_gbps_is_the_link_rate():
    assert ICI_LINK_GBPS == LINK_GBPS


@pytest.mark.parametrize("name", ["tinyllama-1.1b", "mamba2-370m", "olmoe-1b-7b",
                                  "llama-3.2-vision-90b", "jamba-1.5-large-398b"])
def test_init_period_leaves_are_one_period_of_init_params(name):
    """``init_period``'s leaves have the shapes and dtypes of one period of
    ``init_params``'s blocks (drawn from the same generator state) and of
    JAX's ``init_period``; ``init_layer`` is one position of it."""
    tcfg = get_config(name).reduced()
    jcfg = jax_config(name).reduced()
    period = init_period(tcfg, torch.Generator().manual_seed(0), "cpu")
    params = init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert [{k: (tuple(a.shape), a.dtype) for k, a in p.items()} for p in period] == \
        [{k: (tuple(a.shape[1:]), a.dtype) for k, a in p.items()} for p in params["blocks"]]
    jp = jax.eval_shape(lambda: jinit.init_period(jax.random.PRNGKey(0), jcfg))
    assert [(tuple(a.shape), str(a.dtype)[6:]) for a in tree_leaves(period)] == \
        [(a.shape, np.dtype(a.dtype).name) for a in jax.tree.leaves(jp)]
    mixer, channel = tcfg.layer_plan()[0]
    layer = init_layer(tcfg, mixer, channel, torch.Generator().manual_seed(1), "cpu")
    assert {k: a.shape for k, a in layer.items()} == {k: a.shape for k, a in period[0].items()}

