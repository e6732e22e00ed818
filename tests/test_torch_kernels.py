"""The port's kernels (repro_torch.kernels) against the JAX package's
Pallas kernels, run in interpret mode, over the sweeps of test_kernels.py.

On the CPU each wrapper runs its plain PyTorch version, so these cases
hold the plain versions to the JAX kernels; tests/test_torch_cuda.py
holds the CUDA kernels to the plain versions on the card.
Inputs are made with numpy from a seed and handed to both packages.
Tolerances: 2e-5 in fp32 (summation order), 2e-2 in bf16 (one bf16 ulp
of the output), bit-exact for the relay copy.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.decode_attention import decode_attention as jax_decode
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.relay_copy import relay_assemble as jax_relay
from repro_torch.kernels import (
    decode_attention,
    decode_attention_op,
    decode_attention_ref,
    flash_attention,
    flash_attention_op,
    flash_attention_ref,
    launch_counts,
    relay_assemble,
    relay_assemble_ref,
)

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
    assert launch_counts() == before


@pytest.mark.parametrize("case", ["dtype", "group", "head_dim", "layout", "perm"])
def test_wrappers_reject_what_the_kernels_do_not_take(case):
    q = torch.zeros(1, 4, 8, 16)
    k = torch.zeros(1, 2, 8, 16)
    with pytest.raises((TypeError, ValueError)):
        if case == "dtype":
            flash_attention(q.half(), k.half(), k.half())
        elif case == "group":
            decode_attention(torch.zeros(1, 3, 16), k, k, 4)
        elif case == "head_dim":
            flash_attention(torch.zeros(1, 4, 8, 160), torch.zeros(1, 2, 8, 160),
                            torch.zeros(1, 2, 8, 160))
        elif case == "layout":
            flash_attention(torch.zeros(1, 8, 4, 16).transpose(1, 2), k, k)
        else:
            relay_assemble(torch.zeros(3, 4), torch.tensor([0, 1, 2]))
