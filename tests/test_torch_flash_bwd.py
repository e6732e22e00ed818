"""K3b's CPU side: what K3's gradient kernel reads and walks, held here
where no kernel runs.

- ``flash_attention_lse_ref`` (the row log-sum-exp K3's forward writes for
  K3b) against ``jax.nn.logsumexp`` of the scores the JAX oracle masks,
  rows that see no key included;
- the Python mirror of K3b's loop bounds (``bwd_query_tiles`` for the dK/dV
  pass, ``bwd_key_tiles`` for the dQ pass) against the mask: every pair a
  gradient needs is visited, once;
- ``flash_attention_op_bwd`` on the CPU and on meta is
  ``flash_attention_bwd``, bit for bit, and asks for no library;
- ``FlashAttentionFn`` saves lse and refuses a second-order gradient;
- K3b's launch refuses what it cannot take before the library is asked for.
"""
from __future__ import annotations

import importlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.flash_attention.ref import flash_attention_ref as jax_flash_ref
from repro_torch.kernels import (
    FlashAttentionFn,
    build,
    flash_attention_bwd,
    flash_attention_lse_ref,
    flash_attention_op,
    flash_attention_op_bwd,
)
from repro_torch.kernels.flash_attention.ref import no_key_rows, visible

# the wrapper module (the package exports its function under the same name)
k3 = importlib.import_module("repro_torch.kernels.flash_attention.flash_attention")

MASKS = [                             # (Sq, T, causal, window, q_offset)
    (32, 32, True, 0, 0),             # causal prefill
    (32, 32, True, 8, 0),             # sliding window
    (16, 48, True, 12, 32),           # a later chunk of a prompt, with a window
    (24, 40, False, 0, 0),            # cross-attention
    (40, 64, True, 16, 48),           # the last 9 rows see no key (past T with a window)
    (20, 20, True, 0, -5),            # the first 5 rows see no key (before position 0)
    (24, 40, False, 6, 30),           # not causal with a window: rows past its reach
]


@pytest.mark.parametrize("Sq,T,causal,window,q_offset", MASKS)
def test_lse_ref_matches_jax_logsumexp_of_the_masked_scores(Sq, T, causal, window, q_offset):
    B, G, R, D = 2, 2, 2, 16
    rng = np.random.default_rng(3)
    q = rng.standard_normal((B, G * R, Sq, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, G, T, D)).astype(np.float32) for _ in range(2))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    scores = []
    softmax = jax.nn.softmax

    def keep(s, axis=-1):             # the oracle's masked scores, as it hands them on
        scores.append(s)
        return softmax(s, axis=axis)

    with mock.patch.object(jax.nn, "softmax", keep):
        jax_flash_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    want = np.asarray(jax.nn.logsumexp(scores[0], axis=-1)).reshape(B, G * R, Sq)
    got = flash_attention_lse_ref(torch.from_numpy(q), torch.from_numpy(k), **kw)
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, G * R, Sq)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=2e-5)
    n_pre, s_suf = no_key_rows(Sq, T, **kw)
    blind = ~visible(Sq, T, **kw).any(1).numpy()
    assert blind.tolist() == [s < n_pre or s >= s_suf for s in range(Sq)]
    assert np.all(got.numpy()[:, :, blind] == np.float32(-1e30))


BOUNDS = MASKS + [                    # (Sq, T, causal, window, q_offset) at tiles of 32 and 64
    (130, 70, True, 0, 0),            # ragged tiles
    (130, 200, True, 0, 70),
    (200, 200, True, 64, 0),
    (64, 512, True, 48, 504),         # the card's no-key case
    (100, 576, False, 0, 0),
    (100, 300, False, 0, 0),
    (100, 100, True, 0, -30),
    (90, 150, False, 40, 100),
    (512, 512, True, 0, 0),           # TinyLlama's train shape
]


@pytest.mark.parametrize("tile", [32, 64])
@pytest.mark.parametrize("Sq,T,causal,window,q_offset", BOUNDS)
def test_bwd_loop_bounds_visit_every_needed_pair_once(Sq, T, causal, window, q_offset, tile):
    """dK/dV needs every visible (row, key) pair and, for a row that sees no
    key, every (row, key < T) pair (its 1/T reaches every dV); dQ needs the
    visible pairs. Each pass's (query tile, key tile) visits hold all of
    them and none twice; every dK/dV visit holds a pair it needs."""
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    seen = visible(Sq, T, **kw).numpy()
    kv_need = seen | ~seen.any(1, keepdims=True)
    n_qt, n_kt = -(-Sq // tile), -(-T // tile)

    def block(a, qt, kt):
        return a[qt * tile:(qt + 1) * tile, kt * tile:(kt + 1) * tile]

    kv_visits = [(qt, kt) for kt in range(n_kt)
                 for qt in k3.bwd_query_tiles(kt, tile, Sq, T, **kw)]
    q_visits = [(qt, kt) for qt in range(n_qt)
                for kt in k3.bwd_key_tiles(qt, tile, Sq, T, **kw)]
    for visits, need in ((kv_visits, kv_need), (q_visits, seen)):
        assert len(visits) == len(set(visits))
        assert all(0 <= qt < n_qt and 0 <= kt < n_kt for qt, kt in visits)
        covered = np.zeros_like(need)
        for qt, kt in visits:
            block(covered, qt, kt)[...] = True
        assert not (need & ~covered).any()
    assert all(block(kv_need, qt, kt).any() for qt, kt in kv_visits)
    for kt in range(n_kt):            # the dK/dV pass walks its query tiles in order
        tiles = k3.bwd_query_tiles(kt, tile, Sq, T, **kw)
        assert tiles == sorted(tiles)


@pytest.mark.parametrize("walk", [32, 16])
@pytest.mark.parametrize("Sq,T,causal,window,q_offset", BOUNDS)
def test_bwd_loop_bounds_with_walked_tiles_narrower_than_owned(Sq, T, causal, window,
                                                               q_offset, walk):
    """The CUDA-core route's blocks own 64 keys (or rows) and walk tiles of
    32 or 16 rows (or keys) past D = 64: the same needs, held by visits of
    (walked tile, owned tile) rectangles, each once and each needed, the
    dK/dV pass's query tiles in order."""
    own = k3.BWD_OWN
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    seen = visible(Sq, T, **kw).numpy()
    kv_need = seen | ~seen.any(1, keepdims=True)
    kv_visits = [(qt, kt) for kt in range(-(-T // own))
                 for qt in k3.bwd_query_tiles(kt, own, Sq, T, **kw, q_tile=walk)]
    q_visits = [(qt, kt) for qt in range(-(-Sq // own))
                for kt in k3.bwd_key_tiles(qt, own, Sq, T, **kw, k_tile=walk)]
    for visits, need, (rq, rk) in ((kv_visits, kv_need, (walk, own)),
                                   (q_visits, seen, (own, walk))):
        assert len(visits) == len(set(visits))
        assert all(0 <= qt < -(-Sq // rq) and 0 <= kt < -(-T // rk) for qt, kt in visits)
        covered = np.zeros_like(need)
        for qt, kt in visits:
            covered[qt * rq:(qt + 1) * rq, kt * rk:(kt + 1) * rk] = True
            assert need[qt * rq:(qt + 1) * rq, kt * rk:(kt + 1) * rk].any()
        assert not (need & ~covered).any()
    for kt in range(-(-T // own)):
        tiles = k3.bwd_query_tiles(kt, own, Sq, T, **kw, q_tile=walk)
        assert tiles == sorted(tiles)


@pytest.mark.parametrize("dtype,D,want", [
    (torch.bfloat16, 64, (64, 64)), (torch.bfloat16, 80, (64, 64)),
    (torch.bfloat16, 128, (64, 64)), (torch.float32, 64, (64, 32)),
    (torch.float32, 80, (64, 32)), (torch.float32, 128, (64, 32)),
    (torch.bfloat16, 192, (64, 16)), (torch.bfloat16, 256, (64, 16)),
    (torch.float32, 256, (64, 16)),
])
def test_bwd_tiles_by_route_and_head_width(dtype, D, want):
    assert k3.bwd_tiles(dtype, D) == want


# dK/dV blocks K3b's head slices aim at on either route (kSliceBlocks in
# csrc/flash_attention_bwd.cu, whose rule the card test
# test_k3b_head_slices_follow_the_rule holds to the same table)
SLICE_BLOCKS = 256


def _head_slices(B, H, G, T):
    """``head_slices`` of the C source restated: the fewest slices dividing
    R = H / G that give SLICE_BLOCKS blocks of (key tile, KV head, batch,
    slice), else one head a slice."""
    R, blocks = H // G, -(-T // k3.BWD_OWN) * G * B
    return next((s for s in range(1, R) if R % s == 0 and blocks * s >= SLICE_BLOCKS), R)


@pytest.mark.parametrize("B,H,G,T,want", [
    (8, 32, 4, 512, 1),     # TinyLlama's train shape: 256 blocks already
    (4, 32, 4, 512, 2),     # its two-microbatch step: 128 blocks -> 256
    (8, 32, 4, 128, 4),     # launch.train's 8 x 128: 64 blocks -> 256
    (1, 16, 16, 512, 1),    # gemma: R = 1
    (1, 8, 4, 200, 2),      # R = 2: one head a slice
    (2, 64, 8, 512, 2),     # the VLM's 8 heads a group: 128 blocks
    (1, 32, 4, 512, 8),     # one sequence: 32 blocks, a head each
    (2, 24, 4, 512, 6),     # R = 6: 4 slices would do, 6 divide it
])
def test_bwd_head_slices(B, H, G, T, want):
    """The fewest slices dividing R that give the block target."""
    got = _head_slices(B, H, G, T)
    assert got == want and (H // G) % got == 0


@pytest.mark.parametrize("slices", [1, 2, 4])
def test_slice_sums_in_slice_order_equal_the_unsliced_gradient(slices):
    """The CPU mirror of the sliced dK/dV pass: each slice's heads (as its
    block walks them) give a partial dK and dV; summed in slice order they
    are the unsliced plain gradient (fp32 rounding), and dq is each head's
    own. The slices of a group partition its heads."""
    B, S, T, H, G, D = 2, 40, 64, 8, 2, 16
    q, k, v, o, do = _inputs(B, S, T, H, G, D, seed=4)
    kw = dict(causal=True, window=16, q_offset=48)       # rows that see no key too
    dq, dk, dv = flash_attention_bwd(q, k, v, o, do, **kw)
    heads = [[h for g in range(G) for h in k3.bwd_slice_heads(H, G, slices, g, sl)]
             for sl in range(slices)]
    assert sorted(sum(heads, [])) == list(range(H))
    sk, sv = torch.zeros_like(dk), torch.zeros_like(dv)
    for hs in heads:                                      # slice order
        pq, pk, pv = flash_attention_bwd(q[:, :, hs], k, v, o[:, :, hs], do[:, :, hs], **kw)
        sk, sv = sk + pk, sv + pv
        torch.testing.assert_close(pq, dq[:, :, hs], rtol=0, atol=1e-5 * dq.abs().max())
    for got, want in ((sk, dk), (sv, dv)):
        assert (got - want).abs().max() <= 1e-5 * want.abs().max()


def _inputs(B=2, S=40, T=64, H=8, G=2, D=16, seed=0, dtype=torch.float32, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    q, o, do = (torch.randn(B, S, H, D, generator=g).to(dtype).to(device) for _ in range(3))
    k, v = (torch.randn(B, T, G, D, generator=g).to(dtype).to(device) for _ in range(2))
    return q, k, v, o, do


def _no_library(*a, **k):
    raise AssertionError("the kernel library was asked for")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Sq,T,causal,window,q_offset", MASKS)
def test_op_bwd_on_the_cpu_is_the_plain_version(dtype, Sq, T, causal, window, q_offset):
    q, k, v, o, do = _inputs(S=Sq, T=T, dtype=dtype)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    with mock.patch.object(build, "library", _no_library):
        got = flash_attention_op_bwd(q, k, v, o, do, None, **kw)
    want = flash_attention_bwd(q, k, v, o, do, **kw)
    for a, b in zip(got, want):
        assert a.dtype == dtype and torch.equal(a, b)


def test_op_bwd_on_meta_is_the_plain_version():
    q, k, v, o, do = _inputs(device="meta")
    with mock.patch.object(build, "library", _no_library), \
            mock.patch.object(build, "build", _no_library):
        dq, dk, dv = flash_attention_op_bwd(q, k, v, o, do, None, window=8)
    assert [t.device.type for t in (dq, dk, dv)] == ["meta"] * 3
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, v.shape)


def test_flash_attention_fn_saves_lse():
    q, k, v, _, do = _inputs()
    kw = dict(causal=True, window=16, q_offset=48)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = flash_attention_op(*leaves, **kw)
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 5
    for a, b in zip(saved[:3], leaves):
        assert torch.equal(a, b)
    assert torch.equal(saved[3], out.detach())
    want = flash_attention_lse_ref(q.transpose(1, 2), k.transpose(1, 2), **kw)
    assert torch.equal(saved[4], want)
    got = torch.autograd.grad(out, leaves, do)
    for a, b in zip(got, flash_attention_bwd(q, k, v, out.detach(), do, **kw)):
        assert torch.equal(a, b)


def test_flash_attention_fn_refuses_a_second_order_gradient():
    q, k, v, _, do = _inputs()
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    do = do.clone().requires_grad_(True)          # a cotangent that is itself differentiated
    out = flash_attention_op(*leaves)
    dq, = torch.autograd.grad(out, leaves[0], do, create_graph=True)
    with pytest.raises(RuntimeError, match="twice"):
        dq.sum().backward()


def test_off_autograd_the_op_goes_straight_to_the_forward():
    """Without a gradient to record (every served call), the op is the
    forward alone: no FlashAttentionFn node, no lse."""
    q, k, v, _, _ = _inputs()
    out = flash_attention_op(q, k, v)
    assert out.grad_fn is None
    with torch.no_grad():
        leaf = q.clone().requires_grad_(True)
        assert flash_attention_op(leaf, k, v).grad_fn is None


def _launch_bwd(tensors, lse, changes):
    q, k, v, o, do = tensors
    args = dict(q=q, k=k, v=v, o=o, do=do, lse=lse, dq=torch.empty_like(q),
                dk=torch.empty_like(k), dv=torch.empty_like(v))
    args.update(changes)
    with mock.patch.object(build, "library", _no_library):
        k3.launch_bwd(**args, causal=True, window=0, q_offset=0)


@pytest.mark.parametrize("what,error", [
    ("head width past 256", ValueError),
    ("dtypes that differ", TypeError),
    ("fp16", TypeError),
    ("lse of another shape", ValueError),
    ("lse in bf16", ValueError),
    ("dO of another shape", ValueError),
    ("a last dim that is not contiguous", ValueError),
    ("heads that do not divide", ValueError),
])
def test_k3b_launch_refuses_what_it_cannot_take(what, error):
    q, k, v, o, do = _inputs(D=16)
    lse = torch.zeros(2, 8, 40)
    if what == "head width past 256":
        q, k, v, o, do = _inputs(D=264)
        changes = {}
    elif what == "dtypes that differ":
        changes = dict(v=v.bfloat16())
    elif what == "fp16":
        q, k, v, o, do = (t.half() for t in (q, k, v, o, do))
        changes = {}
    elif what == "lse of another shape":
        changes = dict(lse=torch.zeros(2, 40, 8))
    elif what == "lse in bf16":
        changes = dict(lse=lse.bfloat16())
    elif what == "dO of another shape":
        changes = dict(do=do[:, :20])
    elif what == "a last dim that is not contiguous":
        changes = dict(do=do.transpose(1, 3).contiguous().transpose(1, 3))
    else:
        q, k, v, o, do = _inputs(H=6, G=4)
        lse = torch.zeros(2, 6, 40)
        changes = {}
    with pytest.raises(error):
        _launch_bwd((q, k, v, o, do), lse, changes)


def test_k3_forward_refuses_an_lse_it_cannot_write():
    q = torch.zeros(1, 4, 16, 32)
    kv = torch.zeros(1, 2, 16, 32)
    with mock.patch.object(build, "library", _no_library), pytest.raises(ValueError):
        k3.launch(q, kv, kv, torch.empty_like(q), (1, 4, 2, 16, 16, 32), (0,) * 12,
                  causal=True, window=0, q_offset=0, lse=torch.zeros(1, 16, 4))


@pytest.mark.parametrize("dtype,D,route", [
    (torch.bfloat16, 64, "tensor_cores"), (torch.bfloat16, 128, "tensor_cores"),
    (torch.bfloat16, 80, "tensor_cores"), (torch.bfloat16, 160, "cuda_cores"),
    (torch.bfloat16, 256, "cuda_cores"), (torch.float32, 64, "cuda_cores"),
])
def test_k3b_route_by_dtype_and_head_width(dtype, D, route):
    assert k3.bwd_route(dtype, D) == route
