"""The port's kernels (repro_torch.kernels) against the JAX package's
Pallas kernels, run in interpret mode, over the sweeps of test_kernels.py.

On the CPU each wrapper runs its plain PyTorch version, so these cases
hold the plain versions to the JAX kernels; tests/test_torch_cuda.py
holds the CUDA kernels to the plain versions on the card.
Inputs are made with numpy from a seed and handed to both packages.
Tolerances: 2e-5 in fp32 (summation order), 2e-2 in bf16 (one bf16 ulp
of the output), bit-exact for the relay copy.
"""
import ctypes
import re
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.decode_attention import decode_attention as jax_decode
from repro.kernels.decode_attention import decode_attention_ref as jax_decode_ref
from repro.kernels.flash_attention import flash_attention_ref as jax_flash_ref
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.relay_copy import relay_assemble as jax_relay
from repro_torch.kernels.decode_attention.decode_attention import (
    MAX_CLUSTER,
    TILE_K,
    cluster_plan,
    split_range,
)
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.flash_attention import block_order
from repro_torch.kernels.moe_dispatch.moe_dispatch import MAX_TILES, THREADS
from repro_torch.kernels.moe_dispatch.moe_dispatch import tiles as dispatch_tiles
from repro_torch.kernels.ssd_chunk.ssd_chunk import (
    launch as ssd_launch,
    route as ssd_route,
    tensor_cores_take as ssd_tensor_cores_take,
)
from repro_torch.kernels import (
    decode_attention,
    decode_attention_op,
    decode_attention_ref,
    flash_attention,
    flash_attention_op,
    flash_attention_ref,
    launch_counts,
    MoEDispatchFn,
    moe_dispatch,
    moe_dispatch_bwd,
    moe_dispatch_ref,
    relay_assemble,
    relay_assemble_ref,
    ssd_chunk,
    ssd_chunk_bwd,
    ssd_chunk_op,
)
from repro_torch.models.moe import capacity, top_k

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def tol(name):
    return dict(rtol=2e-2, atol=2e-2) if name == "bfloat16" else dict(
        rtol=2e-5, atol=2e-5
    )


def both(x: np.ndarray, name: str):
    """The same values as a JAX array and a torch CPU tensor of dtype
    ``name`` (both round float32 -> bf16 to nearest even)."""
    jdt, tdt = DTYPES[name]
    return jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)


def as_np(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else
                      jnp.asarray(a, jnp.float32))


# ---------------------------------------------------------------------------
# K3 flash attention
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "B,H,G,S,D,bq,bk",
    [
        (1, 4, 4, 64, 32, 16, 16),     # MHA
        (2, 8, 2, 64, 32, 32, 16),     # GQA 4:1
        (1, 2, 1, 128, 64, 64, 32),    # MQA, bigger blocks
        (1, 4, 2, 96, 16, 32, 32),     # ragged-ish seq
    ],
)
def test_flash_plain_matches_jax_kernel(dtype, B, H, G, S, D, bq, bk):
    rng = np.random.default_rng(0)
    jq, tq = both(rng.standard_normal((B, H, S, D), np.float32), dtype)
    jk, tk = both(rng.standard_normal((B, G, S, D), np.float32), dtype)
    jv, tv = both(rng.standard_normal((B, G, S, D), np.float32), dtype)
    ref = jax_flash(jq, jk, jv, block_q=bq, block_k=bk)
    out = flash_attention(tq, tk, tv)
    assert out.dtype == DTYPES[dtype][1] and out.shape == (B, H, S, D)
    np.testing.assert_allclose(as_np(out), as_np(ref), **tol(dtype))


@pytest.mark.parametrize("window", [16, 48])
def test_flash_plain_sliding_window_matches_jax_kernel(window):
    rng = np.random.default_rng(1)
    jq, tq = both(rng.standard_normal((1, 4, 64, 32), np.float32), "float32")
    jk, tk = both(rng.standard_normal((1, 2, 64, 32), np.float32), "float32")
    jv, tv = both(rng.standard_normal((1, 2, 64, 32), np.float32), "float32")
    ref = jax_flash(jq, jk, jv, window=window, block_q=16, block_k=16)
    out = flash_attention(tq, tk, tv, window=window)
    np.testing.assert_allclose(as_np(out), as_np(ref), **tol("float32"))


def test_flash_q_offset_matches_jax_kernel():
    """A query block that starts later in the sequence (chunked prefill)."""
    rng = np.random.default_rng(2)
    jq, tq = both(rng.standard_normal((1, 4, 32, 16), np.float32), "float32")
    jk, tk = both(rng.standard_normal((1, 2, 64, 16), np.float32), "float32")
    jv, tv = both(rng.standard_normal((1, 2, 64, 16), np.float32), "float32")
    ref = jax_flash(jq, jk, jv, q_offset=32, block_q=16, block_k=16)
    out = flash_attention(tq, tk, tv, q_offset=32)
    np.testing.assert_allclose(as_np(out), as_np(ref), **tol("float32"))


def test_flash_plain_rows_with_no_visible_key_match_jax_oracle():
    """Query positions past T with a window see no key: the oracle (and so
    the plain version and the CUDA kernel) gives them the mean of V over
    [0, T)."""
    rng = np.random.default_rng(9)
    jq, tq = both(rng.standard_normal((1, 4, 24, 16), np.float32), "float32")
    jk, tk = both(rng.standard_normal((1, 2, 32, 16), np.float32), "float32")
    jv, tv = both(rng.standard_normal((1, 2, 32, 16), np.float32), "float32")
    ref = jax_flash_ref(jq, jk, jv, window=8, q_offset=24)
    out = flash_attention(tq, tk, tv, window=8, q_offset=24)
    np.testing.assert_allclose(as_np(out), as_np(ref), **tol("float32"))
    mean_v = tv.mean(dim=2).repeat_interleave(2, dim=1)     # (1, 4, 16)
    np.testing.assert_allclose(as_np(out[:, :, -1]), as_np(mean_v), **tol("float32"))


def test_flash_op_model_layout_matches_kernel_layout():
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((2, 40, 4, 32), np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 40, 2, 32), np.float32))
    v = torch.from_numpy(rng.standard_normal((2, 40, 2, 32), np.float32))
    out = flash_attention_op(q, k, v, window=8)
    ref = flash_attention(q.transpose(1, 2).contiguous(),
                          k.transpose(1, 2).contiguous(),
                          v.transpose(1, 2).contiguous(), window=8)
    assert torch.equal(out, ref.transpose(1, 2))


# ---------------------------------------------------------------------------
# K2 decode attention
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "B,H,G,T,D,bk",
    [
        (2, 8, 2, 128, 32, 32),
        (1, 4, 4, 256, 64, 64),
        (4, 2, 1, 64, 16, 16),
    ],
)
def test_decode_plain_matches_jax_kernel(dtype, B, H, G, T, D, bk):
    rng = np.random.default_rng(4)
    jq, tq = both(rng.standard_normal((B, H, D), np.float32), dtype)
    jk, tk = both(rng.standard_normal((B, G, T, D), np.float32), dtype)
    jv, tv = both(rng.standard_normal((B, G, T, D), np.float32), dtype)
    kv_len = rng.integers(1, T + 1, size=B).astype(np.int32)
    ref = jax_decode(jq, jk, jv, jnp.asarray(kv_len), block_k=bk)
    out = decode_attention(tq, tk, tv, torch.from_numpy(kv_len))
    assert out.dtype == DTYPES[dtype][1] and out.shape == (B, H, D)
    np.testing.assert_allclose(as_np(out), as_np(ref), **tol(dtype))


@pytest.mark.parametrize("kv", [1, 64])
def test_decode_plain_edge_lengths_match_jax_kernel(kv):
    """kv_len = 1 (just-written token) and kv_len = T."""
    rng = np.random.default_rng(5)
    B, H, G, T, D = 2, 4, 2, 64, 32
    jq, tq = both(rng.standard_normal((B, H, D), np.float32), "float32")
    jk, tk = both(rng.standard_normal((B, G, T, D), np.float32), "float32")
    jv, tv = both(rng.standard_normal((B, G, T, D), np.float32), "float32")
    ref = jax_decode(jq, jk, jv, jnp.full((B,), kv), block_k=16)
    out = decode_attention(tq, tk, tv, kv)
    np.testing.assert_allclose(as_np(out), as_np(ref), **tol("float32"))


def test_decode_plain_row_with_no_key_matches_jax_oracle():
    """kv_len = 0 for one sequence: softmax over uniform -1e30 scores gives
    the mean of V over the whole cache, through both wrappers."""
    rng = np.random.default_rng(10)
    B, H, G, T, D = 2, 4, 2, 48, 16
    jq, tq = both(rng.standard_normal((B, H, D), np.float32), "float32")
    jk, tk = both(rng.standard_normal((B, G, T, D), np.float32), "float32")
    jv, tv = both(rng.standard_normal((B, G, T, D), np.float32), "float32")
    kv_len = np.array([0, 20], np.int32)
    ref = jax_decode_ref(jq, jk, jv, jnp.asarray(kv_len))
    out = decode_attention(tq, tk, tv, torch.from_numpy(kv_len))
    np.testing.assert_allclose(as_np(out), as_np(ref), **tol("float32"))
    mean_v = tv[0].mean(dim=1).repeat_interleave(H // G, dim=0)
    np.testing.assert_allclose(as_np(out[0]), as_np(mean_v), **tol("float32"))
    op = decode_attention_op(tq[:, None], tk.transpose(1, 2).contiguous(),
                             tv.transpose(1, 2).contiguous(), torch.from_numpy(kv_len))
    assert torch.equal(op[:, 0], out)


def test_decode_op_model_layout_matches_kernel_layout():
    rng = np.random.default_rng(6)
    q = torch.from_numpy(rng.standard_normal((2, 1, 8, 16), np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 50, 2, 16), np.float32))
    v = torch.from_numpy(rng.standard_normal((2, 50, 2, 16), np.float32))
    kv_len = torch.tensor([7, 50], dtype=torch.int32)
    out = decode_attention_op(q, k, v, kv_len)
    ref = decode_attention(q[:, 0], k.transpose(1, 2).contiguous(),
                           v.transpose(1, 2).contiguous(), kv_len)
    assert torch.equal(out[:, 0], ref)


# ---------------------------------------------------------------------------
# K1 relay copy
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "int32", "bfloat16"])
@pytest.mark.parametrize("n_chunks,elems", [(8, 64), (16, 256), (3, 128)])
def test_relay_plain_matches_jax_kernel(dtype, n_chunks, elems):
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((n_chunks, elems)) * 100).astype(np.float32)
    perm = rng.permutation(n_chunks).astype(np.int32)
    if dtype == "int32":
        jx, tx = jnp.asarray(x.astype(np.int32)), torch.from_numpy(x.astype(np.int32))
    else:
        jx, tx = both(x, dtype)
    ref = jax_relay(jx, jnp.asarray(perm))
    out = relay_assemble(tx, torch.from_numpy(perm))
    if dtype == "bfloat16":   # compare the bits
        assert np.array_equal(np.asarray(ref).view(np.uint16),
                              out.view(torch.int16).numpy().view(np.uint16))
    else:
        assert np.array_equal(np.asarray(ref), out.numpy())


def test_relay_roundtrip_payload():
    """Simulated out-of-order landing then assembly reconstructs payload."""
    payload = torch.arange(16 * 128, dtype=torch.float32).reshape(16, 128)
    landing_order = np.random.default_rng(0).permutation(16)
    staged = payload[torch.from_numpy(landing_order)]
    perm = torch.from_numpy(np.argsort(landing_order).astype(np.int32))
    assert torch.equal(relay_assemble(staged, perm), payload)


# ---------------------------------------------------------------------------
# Wrapper contract on the CPU
# ---------------------------------------------------------------------------
def test_cpu_wrappers_run_plain_versions_and_count_no_launch():
    before = launch_counts()
    rng = np.random.default_rng(8)
    q = torch.from_numpy(rng.standard_normal((1, 4, 24, 16), np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 2, 24, 16), np.float32))
    assert torch.equal(flash_attention(q, k, k), flash_attention_ref(q, k, k))
    q0 = q[:, :, 0].contiguous()
    assert torch.equal(decode_attention(q0, k, k, 5),
                       decode_attention_ref(q0, k, k, 5))
    perm = torch.tensor([2, 0, 1], dtype=torch.int32)
    s = torch.arange(12.0).reshape(3, 4)
    assert torch.equal(relay_assemble(s, perm), relay_assemble_ref(s, perm))
    x, top_i = _dispatch_inputs(torch.float32)
    for got, want in zip(moe_dispatch(x, top_i, 8, 5), moe_dispatch_ref(x, top_i, 8, 5)):
        assert torch.equal(got, want)
    assert launch_counts() == before


def _dispatch_inputs(dtype, B=2, S=40, d=24, E=8, K=2):
    """Tokens and their top-K experts; every 5th token is zero, so its
    router probabilities tie and it takes the lowest experts (drops)."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((B, S, d), np.float32)).to(dtype)
    x[:, ::5] = 0
    w = torch.from_numpy(rng.standard_normal((d, E), np.float32))
    return x, top_k(torch.softmax(x.float() @ w, dim=-1), K)[1]


@pytest.mark.parametrize("cf", [1.25, 0.5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_dispatch_gradient_is_autograd_through_the_plain_version(dtype, cf):
    """``moe_dispatch_bwd`` (MoEDispatchFn's backward on the card) gives x
    the gradient autograd takes through the plain scatter, bit for bit,
    drops included; MoEDispatchFn on the CPU returns the plain outputs, and
    pos_c and keep carry no gradient."""
    B, S, d, E, K = 2, 40, 24, 8, 2
    x, top_i = _dispatch_inputs(dtype, B, S, d, E, K)
    C = capacity(S, SimpleNamespace(top_k=K, n_experts=E, capacity_factor=cf))
    g = torch.from_numpy(np.random.default_rng(6).standard_normal((B, E, C, d), np.float32))
    g = g.to(dtype)
    leaf = x.clone().requires_grad_(True)
    buffers, pos_c, keep = moe_dispatch_ref(leaf, top_i, E, C)
    (want,) = torch.autograd.grad(buffers, leaf, g)
    assert (keep == 0).any(), "no assignment was dropped"
    assert torch.equal(moe_dispatch_bwd(g, top_i, pos_c, keep), want)
    leaf = x.clone().requires_grad_(True)
    got = MoEDispatchFn.apply(leaf, top_i, E, C)
    for a, b in zip(got, (buffers, pos_c, keep)):
        assert torch.equal(a, b)
    assert not (got[1].requires_grad or got[2].requires_grad)
    assert torch.equal(torch.autograd.grad(got[0], leaf, g)[0], want)


@pytest.mark.parametrize("S,K", [(1, 8), (7, 8), (3328, 8), (8192, 8), (8193, 8),
                                 (300, 2), (3328, 1), (5, 512), (100_000, 64)])
def test_moe_dispatch_tiles_cover_each_token_once(S, K):
    """The dispatch's tiles: consecutive runs of ``tile`` tokens, the last
    ragged, covering the row once; one ranking pass of assignments (at least
    one token) unless the row would take more than MAX_TILES tiles."""
    tile, n = dispatch_tiles(S, K)
    assert tile >= 1 and (n - 1) * tile < S <= n * tile
    assert n <= MAX_TILES
    if S <= MAX_TILES * max(1, THREADS // K):
        assert tile == max(1, THREADS // K)


@pytest.mark.parametrize("name", sorted(build._SIGNATURES))
def test_kernel_entry_points_match_their_c_prototypes(name):
    """Each ctypes signature in ``build._SIGNATURES`` has the C entry
    point's parameters, in order: a pointer as c_void_p, ``int``,
    ``long long`` and ``float`` as themselves. A miscount shifts every
    later argument, which nothing on the CPU would see."""
    src = "\n".join(p.read_text() for p in sorted(build.CSRC.glob("*.cu")))
    m = re.search(r'extern "C" [\w ]+?\b' + name + r"\s*\((.*?)\)\s*\{", src, re.S)
    assert m, f"no extern \"C\" {name} in csrc/"
    scalar = {"int": ctypes.c_int, "long long": ctypes.c_longlong, "float": ctypes.c_float}
    params = [re.sub(r"\s*\b\w+$", "", p.strip()) for p in m.group(1).split(",")]
    assert [ctypes.c_void_p if "*" in t else scalar[t.replace("const ", "").strip()]
            for t in params] == build._SIGNATURES[name]


# ---------------------------------------------------------------------------
# The kernels' launch plans, which only the Python side can check here
# ---------------------------------------------------------------------------
_RNG_LENS = [int(x) for x in np.random.default_rng(11).integers(0, 4097, size=12)]


@pytest.mark.parametrize("T,B,G", [(1024, 1, 4), (4096, 2, 4), (300, 1, 1), (64, 8, 8),
                                   (4096, 1, 32)])
@pytest.mark.parametrize("kv_len", [0, 1, 31, 32, 33, "T"] + _RNG_LENS)
def test_decode_cluster_plan_covers_valid_keys_exactly(T, B, G, kv_len):
    """K2's blocks of one cluster take disjoint, tile-aligned key ranges
    whose union is exactly [0, kv_len), for the cluster size the wrapper
    picks from the cache length and from the length itself."""
    kv_len = T if kv_len == "T" else min(kv_len, T)
    for n_keys in (T, kv_len):
        cluster = cluster_plan(n_keys, B, G, 132)
        assert 1 <= cluster <= MAX_CLUSTER
        covered = []
        for rank in range(cluster):
            begin, end = split_range(rank, cluster, kv_len)
            if end > begin:
                assert begin % TILE_K == 0
                covered.extend(range(begin, end))
        assert covered == list(range(kv_len))


@pytest.mark.parametrize("n_qt,H,B", [(8, 32, 1), (1, 4, 2), (16, 8, 2), (3, 6, 3)])
def test_flash_block_order_visits_every_tile_once(n_qt, H, B):
    """K3's block index -> (q tile, head, batch) map is a permutation, runs
    the q tiles from the last to the first, and keeps the heads of one
    (q tile, batch) next to each other."""
    order = block_order(n_qt, H, B)
    assert sorted(order) == sorted((t, h, b) for t in range(n_qt) for h in range(H)
                                   for b in range(B))
    tiles = [t for t, _, _ in order]
    assert tiles == sorted(tiles, reverse=True)
    for i in range(0, len(order), H):
        assert [h for _, h, _ in order[i:i + H]] == list(range(H))


@pytest.mark.parametrize("case", ["dtype", "group", "head_dim", "layout", "perm",
                                  "ssd_dtype", "ssd_group", "mixed_dtype",
                                  "decode_mixed_dtype", "decode_head_dim",
                                  "decode_kv_len_shape", "dispatch_experts",
                                  "dispatch_no_experts", "dispatch_index_dtype",
                                  "dispatch_dtype", "dispatch_shape", "dispatch_capacity"])
def test_wrappers_reject_what_the_kernels_do_not_take(case):
    q = torch.zeros(1, 4, 8, 16)
    k = torch.zeros(1, 2, 8, 16)
    with pytest.raises((TypeError, ValueError)):
        if case == "dtype":
            flash_attention(q.half(), k.half(), k.half())
        elif case == "group":
            decode_attention(torch.zeros(1, 3, 16), k, k, 4)
        elif case == "head_dim":
            # the plain versions take any D >= 1; the CUDA kernels' limits
            # are tests/test_torch_headdim.py's
            flash_attention(torch.zeros(1, 4, 8, 0), torch.zeros(1, 2, 8, 0),
                            torch.zeros(1, 2, 8, 0))
        elif case == "layout":
            flash_attention(torch.zeros(1, 8, 4, 16).transpose(1, 2), k, k)
        elif case == "ssd_dtype":
            x = torch.zeros(2, 1, 8, 4, dtype=torch.half)
            ssd_chunk(x, torch.zeros(2, 1, 8), x, x)
        elif case == "mixed_dtype":
            flash_attention(q.bfloat16(), k, k)
        elif case == "decode_mixed_dtype":
            decode_attention(torch.zeros(1, 4, 16), k.bfloat16(), k, 4)
        elif case == "decode_head_dim":
            decode_attention(torch.zeros(1, 4, 0), torch.zeros(1, 2, 8, 0),
                             torch.zeros(1, 2, 8, 0), 4)
        elif case == "decode_kv_len_shape":     # one length per sequence, or one
            decode_attention(torch.zeros(2, 4, 16), torch.zeros(2, 2, 8, 16),
                             torch.zeros(2, 2, 8, 16), torch.tensor([1, 2, 3]))
        elif case == "ssd_group":       # 3 B/C groups do not divide 4 heads
            ssd_chunk_op(torch.zeros(1, 8, 4, 2), torch.zeros(1, 8, 4),
                         torch.zeros(1, 8, 3, 4), torch.zeros(1, 8, 3, 4), 8)
        elif case.startswith("dispatch"):
            x, top_i, E, C = torch.zeros(1, 4, 8), torch.zeros(1, 4, 2, dtype=torch.long), 4, 2
            if case == "dispatch_experts":       # past the kernel's 512
                E = 513
            elif case == "dispatch_no_experts":
                E = 0
            elif case == "dispatch_index_dtype":  # top-k's indices are int64
                top_i = top_i.int()
            elif case == "dispatch_dtype":
                x = x.double()
            elif case == "dispatch_shape":        # a top_i for 5 tokens
                top_i = torch.zeros(1, 5, 2, dtype=torch.long)
            else:                                 # no slot for 8 assignments
                C = 0
            moe_dispatch(x, top_i, E, C)
        else:
            relay_assemble(torch.zeros(3, 4), torch.tensor([0, 1, 2]))


@pytest.mark.parametrize("dtype,Q,P,N,expected", [
    (torch.bfloat16, 256, 64, 128, "tensor_cores"),   # Mamba2-370m
    (torch.bfloat16, 256, 64, 16, "tensor_cores"),    # jamba-1.5's SSM widths
    (torch.bfloat16, 64, 64, 128, "tensor_cores"),
    (torch.bfloat16, 1024, 128, 256, "tensor_cores"),  # the widest it takes
    (torch.float32, 256, 64, 128, "cuda_cores"),      # fp32 keeps 1e-4 on CUDA cores
    (torch.bfloat16, 32, 32, 16, "cuda_cores"),       # chunk 32 (reduced configs)
    (torch.bfloat16, 256, 64, 8, "cuda_cores"),       # N = 8
    (torch.bfloat16, 96, 64, 128, "cuda_cores"),      # Q not a multiple of 64
    (torch.bfloat16, 2048, 64, 128, "cuda_cores"),    # more than 16 row tiles
    (torch.bfloat16, 256, 40, 128, "cuda_cores"),     # P not a multiple of 16
    (torch.bfloat16, 256, 64, 272, "cuda_cores"),     # N past 256
])
def test_ssd_route_is_a_function_of_dtype_and_shape(dtype, Q, P, N, expected):
    """The default route is the tensor cores for the bf16 shapes
    ``tensor_cores_take`` accepts and the CUDA cores for the rest; a call
    that names the CUDA cores takes them, and the tensor cores, named,
    refuse what they do not take."""
    assert ssd_tensor_cores_take(dtype, Q, P, N) == (expected == "tensor_cores")
    assert ssd_route(dtype, Q, P, N) == expected
    assert ssd_route(dtype, Q, P, N, "cuda_cores") == "cuda_cores"
    if expected == "tensor_cores":
        assert ssd_route(dtype, Q, P, N, "tensor_cores") == "tensor_cores"
    else:
        with pytest.raises(ValueError):
            ssd_route(dtype, Q, P, N, "tensor_cores")


@pytest.mark.parametrize("model,reduced,expected", [
    ("mamba2-370m", False, "tensor_cores"),
    ("jamba-1.5-large-398b", False, "tensor_cores"),
    ("mamba2-370m", True, "cuda_cores"),      # fp32, chunk 32
])
def test_ssd_route_of_the_configured_models(model, reduced, expected):
    from repro_torch.configs import get_config

    cfg = get_config(model)
    cfg = cfg.reduced() if reduced else cfg
    shape = (cfg.dtype, cfg.ssm_chunk, cfg.ssm_head_dim, cfg.ssm_state)
    assert ssd_tensor_cores_take(*shape) == (expected == "tensor_cores")
    assert ssd_route(*shape) == expected          # what the model's ssd_op launches


@pytest.mark.parametrize("dtype,which", [(torch.float32, "tensor_cores"),
                                         (torch.bfloat16, "gpu")])
def test_ssd_launch_rejects_a_route_that_cannot_take_the_call(dtype, which):
    """A named route that does not take the dtype, or no route at all,
    raises before anything is launched."""
    x = torch.zeros(1, 256, 2, 64, dtype=dtype)
    B = torch.zeros(1, 256, 1, 128, dtype=dtype)
    a = torch.zeros(1, 256, 2)
    with pytest.raises(ValueError):
        ssd_launch(x, a, B, B, x, torch.zeros(1, 2, 1, 64, 128), torch.zeros(1, 2, 1, 256),
                   (1, 2, 1, 256, 256, 64, 128), (0,) * 15, which)


def test_ssd_route_counts_reset_with_the_launch_counts():
    from repro_torch.kernels import reset_launch_counts, route_counts

    ssd_chunk.route_launches["tensor_cores"] += 3
    ssd_chunk_bwd.route_launches["tensor_cores"] += 2
    reset_launch_counts()
    assert route_counts() == {"ssd_chunk:cuda_cores": 0, "ssd_chunk:tensor_cores": 0,
                              "ssd_chunk_bwd:cuda_cores": 0, "ssd_chunk_bwd:tensor_cores": 0}


@pytest.mark.parametrize("which", [None, "cuda_cores", "tensor_cores"])
def test_ssd_op_runs_the_plain_version_on_the_cpu_whatever_the_route(which):
    """On CPU tensors K4 computes the plain version for any route, and so
    does ssd_op, which takes the default route."""
    from repro_torch.kernels import ssd_chunk_op, ssd_chunk_op_ref, ssd_op, ssd_op_ref

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((1, 40, 4, 8), dtype=np.float32))
    a = -torch.from_numpy(rng.random((1, 40, 4), dtype=np.float32))
    B = torch.from_numpy(rng.standard_normal((1, 40, 2, 16), dtype=np.float32))
    before = launch_counts()
    pairs = [(ssd_chunk_op(x, a, B, B, 16, which=which), ssd_chunk_op_ref(x, a, B, B, 16))]
    if which is None:
        pairs.append((ssd_op(x, a, B, B, 16), ssd_op_ref(x, a, B, B, 16)))
    assert launch_counts() == before
    for got, want in pairs:
        for g, w in zip(got, want):
            assert torch.equal(g, w)
