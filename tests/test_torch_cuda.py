"""The port on an sm_90 card: the CUDA kernels against their plain
versions, the data plane bit-exact through real CUDA copies, a reduced
model on the card against the same model on the CPU, and gradients: K3's
through FlashAttentionFn (K3b), K4's through SSDChunkFn (K4b), 2-layer dense, 2-layer
Mamba2 and one-period hybrid models' against the plain path's, and the
kernels without a gradient refusing one.

Every test here needs the card (marker ``cuda``) and skips elsewhere; the
file imports neither JAX nor the JAX package, so it runs on a machine
that has only PyTorch:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: bf16 2e-2 (one bf16 ulp of the output), fp32 1e-4 with TF32
off (another summation order), bit-exact for copies.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config
from repro_torch.core import MMAConfig, make_functional_engine, \
    multipath_device_get, multipath_device_put
from repro_torch.kernels import build
from repro_torch.kernels.ssd_chunk.ssd_chunk import bwd_route, route, tensor_cores_take
from repro_torch.kernels import (
    decode_attention,
    decode_attention_op,
    decode_attention_op_ref,
    decode_attention_ref,
    flash_attention,
    flash_attention_bwd,
    flash_attention_lse_ref,
    flash_attention_op,
    flash_attention_op_bwd,
    flash_attention_op_ref,
    flash_attention_ref,
    relay_assemble,
    relay_assemble_op,
    relay_assemble_ref,
    ssd_chunk,
    ssd_chunk_bwd,
    ssd_chunk_bwd_ref,
    ssd_chunk_op,
    ssd_chunk_op_bwd,
    ssd_chunk_op_bwd_ref,
    ssd_chunk_op_ref,
    ssd_chunk_ref,
)
from repro_torch.models import (
    decode_step,
    init_params,
    loss_fn,
    moe_ffn,
    prefill,
    router,
)
from repro_torch.models.moe import capacity, slot_positions
from repro_torch.tree import tree_leaves, tree_map

pytestmark = pytest.mark.cuda
TOL = {torch.bfloat16: dict(rtol=2e-2, atol=2e-2),
       torch.float32: dict(rtol=1e-4, atol=1e-4)}


@pytest.fixture
def dev():
    """An sm_90 card, or skip (decided here, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("the kernels are built for sm_90a")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _close(out, ref, dtype):
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               ref.float().cpu().numpy(), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,G,Sq,T,D,window,q_offset", [
    (2, 8, 2, 64, 64, 64, 0, 0),
    (2, 8, 2, 96, 96, 32, 16, 0),
    (2, 8, 2, 200, 200, 128, 0, 0),
    (1, 8, 2, 1000, 1000, 64, 0, 0),      # ragged, 16 key tiles: the ring wraps
    (1, 8, 2, 512, 512, 128, 256, 0),     # D = 128 with a window
    (1, 8, 2, 64, 576, 64, 0, 512),       # a chunk of a chunked prefill
    (1, 4, 2, 100, 100, 20, 8, 0),        # D = 20: element staging, zero-padded
    (1, 16, 16, 512, 512, 128, 0, 0),     # OLMoE's prefill: MHA, D = 128
    (1, 16, 16, 200, 200, 128, 0, 0),     # OLMoE, a ragged q and key tile
    (1, 64, 8, 512, 512, 128, 0, 0),      # the VLM's self-attention: R = 8, D = 128
    # heads past 128: one warpgroup over 256 padded columns, by TMA where
    # D % 64 == 0 and by cp.async otherwise (250: element by element)
    (1, 16, 16, 512, 512, 256, 0, 0),     # gemma-7b's prefill: MHA, D = 256
    (2, 4, 4, 1000, 1000, 256, 0, 0),     # 16 key tiles: the ring wraps
    (1, 16, 16, 200, 200, 256, 48, 0),    # a window, ragged q and key tiles
    (1, 8, 2, 64, 576, 256, 0, 512),      # a chunk of a chunked prefill, R = 4
    (1, 8, 2, 200, 200, 192, 0, 0),       # D = 192, R = 4
    (1, 4, 4, 300, 300, 160, 0, 0),       # D = 160
    (1, 4, 2, 100, 100, 200, 8, 0),       # D = 200, a window
    (1, 4, 1, 40, 64, 250, 16, 48),       # D = 250; rows with no key
])
def test_flash_matches_plain(dev, dtype, B, H, G, Sq, T, D, window, q_offset):
    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn(B, H, Sq, D, device=dev, generator=g).to(dtype)
    k = torch.randn(B, G, T, D, device=dev, generator=g).to(dtype)
    v = torch.randn(B, G, T, D, device=dev, generator=g).to(dtype)
    n = flash_attention.launches
    out = flash_attention(q, k, v, window=window, q_offset=q_offset)
    assert flash_attention.launches == n + 1
    _close(out, flash_attention_ref(q, k, v, window=window, q_offset=q_offset), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,G,Sq,T,D", [
    (1, 64, 8, 512, 576, 128),            # the VLM's cross-attention prefill: 9 key tiles
    (1, 64, 8, 1, 576, 128),              # one query row
    (1, 8, 2, 200, 100, 64),              # a ragged frontend: a last key tile of 36
    (1, 16, 16, 512, 576, 256),           # heads of 256: 9 key tiles, TMA
    (1, 16, 16, 1, 576, 256),
    (1, 8, 2, 200, 100, 192),             # heads of 192: cp.async
])
def test_flash_without_causal_mask_matches_plain(dev, dtype, B, H, G, Sq, T, D):
    """K3 with causal=False (cross-attention: every query sees all T keys,
    T != Sq), in both layouts: the model's wrapper gives the same bits."""
    g = torch.Generator(device=dev).manual_seed(2)
    q = torch.randn(B, H, Sq, D, device=dev, generator=g).to(dtype)
    k = torch.randn(B, G, T, D, device=dev, generator=g).to(dtype)
    v = torch.randn(B, G, T, D, device=dev, generator=g).to(dtype)
    n = flash_attention.launches
    out = flash_attention(q, k, v, causal=False)
    assert flash_attention.launches == n + 1
    _close(out, flash_attention_ref(q, k, v, causal=False), dtype)
    qm, km, vm = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    assert torch.equal(flash_attention_op(qm, km, vm, causal=False).transpose(1, 2), out)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,G,T,D,kv", [
    (32, 4, 300, 64, (1, 1)),
    (32, 4, 300, 64, (37, 18)),
    (32, 4, 300, 64, (300, 150)),
    (32, 4, 300, 64, 300),              # one length for both, passed by value
    (32, 4, 4096, 64, (4000, 4000)),    # more key tiles per block than blocks
    (32, 4, 300, 64, (0, 300)),         # no key beside a full cache
    (4, 4, 300, 64, (37, 300)),         # R = 1
    (32, 1, 300, 64, (37, 300)),        # R = 32
    (32, 4, 300, 128, (37, 300)),       # D = 128
    (8, 2, 100, 20, (37, 100)),         # D = 20: element staging in bf16
    (16, 16, 1024, 128, (300, 1024)),   # OLMoE's decode: R = 1, D = 128
    (16, 16, 1024, 128, (0, 513)),      # OLMoE, no key beside a ragged tile
    (16, 16, 1024, 128, 544),           # OLMoE, one length passed by value
    (64, 8, 1024, 128, (300, 513)),     # the VLM's self-attention: R = 8, D = 128
    (64, 8, 576, 128, 576),             # its cross-attention: every frontend key valid
    (16, 16, 1024, 256, (300, 1024)),   # gemma-7b's decode: R = 1, D = 256
    (16, 16, 1024, 256, (0, 513)),      # gemma, no key beside a ragged tile
    (16, 16, 1024, 256, 544),           # gemma, one length passed by value
    (16, 1, 4096, 256, (4000, 4000)),   # R = 16, the most K2 takes past D = 128
    (32, 8, 300, 192, (37, 300)),       # D = 192, R = 4
    (16, 1, 300, 160, (37, 300)),       # D = 160, R = 16
    (8, 2, 100, 200, (37, 100)),        # D = 200
    (8, 2, 100, 250, (37, 100)),        # D = 250: element staging
])
def test_decode_matches_plain(dev, dtype, H, G, T, D, kv):
    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn(2, H, D, device=dev, generator=g).to(dtype)
    k = torch.randn(2, G, T, D, device=dev, generator=g).to(dtype)
    v = torch.randn(2, G, T, D, device=dev, generator=g).to(dtype)
    lens = torch.tensor(kv, dtype=torch.int32, device=dev) if isinstance(kv, tuple) else kv
    n = decode_attention.launches
    out = decode_attention(q, k, v, lens)
    assert decode_attention.launches == n + 1
    _close(out, decode_attention_ref(q, k, v, lens), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rows_with_no_key_match_plain(dev, dtype):
    """K2 at kv_len 0 (both wrappers) and K3 rows past T with a window give
    the plain versions' mean of V over the whole cache."""
    g = torch.Generator(device=dev).manual_seed(1)
    q = torch.randn(2, 32, 64, device=dev, generator=g).to(dtype)
    k = torch.randn(2, 4, 300, 64, device=dev, generator=g).to(dtype)
    v = torch.randn(2, 4, 300, 64, device=dev, generator=g).to(dtype)
    lens = torch.tensor([0, 37], dtype=torch.int32, device=dev)
    _close(decode_attention(q, k, v, lens), decode_attention_ref(q, k, v, lens), dtype)
    km, vm = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
    _close(decode_attention_op(q[:, None], km, vm, 0),
           decode_attention_op_ref(q[:, None], km, vm, 0), dtype)
    qs = torch.randn(2, 8, 40, 64, device=dev, generator=g).to(dtype)
    ks, vs = k[:, :2, :64].contiguous(), v[:, :2, :64].contiguous()
    _close(flash_attention(qs, ks, vs, window=16, q_offset=48),
           flash_attention_ref(qs, ks, vs, window=16, q_offset=48), dtype)


def _ssd_inputs(dev, dtype, b, l, h, p, n, groups, decay="fast"):
    """``fast``: a = -softplus(randn), about -0.8 a step, so only keys near
    the diagonal show. ``slow``: Mamba2's decays, a = -A dt with A over
    U(1, 16) and dt over log-uniform [1e-3, 1e-1] by quantiles across the
    heads (dt jittered per position) and x times dt, so every key tile and
    every state position of a 256-position chunk adds to the result."""
    g = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn(b, l, h, p, device=dev, generator=g)
    if decay == "fast":
        x, scale = x * 0.3, 0.3
        a = -torch.nn.functional.softplus(torch.randn(b, l, h, device=dev, generator=g))
    else:
        q = (torch.arange(h, device=dev) + 0.5) / h
        A = 1 + 15 * q[torch.randperm(h, device=dev, generator=g)]
        dt0 = 1e-3 * 100 ** q[torch.randperm(h, device=dev, generator=g)]
        dt = dt0 * (0.5 + torch.rand(b, l, h, device=dev, generator=g))
        x, scale = x * dt[..., None], 0.5
        a = -A * dt
    B = (torch.randn(b, l, groups, n, device=dev, generator=g) * scale).to(dtype)
    C = (torch.randn(b, l, groups, n, device=dev, generator=g) * scale).to(dtype)
    return x.to(dtype), a, B, C


def _ssd_matches_plain(dev, dtype, l, h, p, n, groups, chunk, decay, which=None):
    """K4 on route ``which`` (the default route when None) against its
    plain version; y_diag at x's dtype's tolerance, the states and out_decay
    (fp32 on both sides) at fp32's. The route counter must move for the
    route asked for; a tensor-core route for a shape the tensor cores do not
    take must raise before anything is launched."""
    x, a, B, C = _ssd_inputs(dev, dtype, 2, l, h, p, n, groups, decay)
    before, by_route = ssd_chunk.launches, dict(ssd_chunk.route_launches)
    if which == "tensor_cores" and not tensor_cores_take(dtype, chunk, p, n):
        with pytest.raises(ValueError):
            ssd_chunk_op(x, a, B, C, chunk, which=which)
        assert ssd_chunk.launches == before
        return
    got = ssd_chunk_op(x, a, B, C, chunk, which=which)
    assert ssd_chunk.launches == before + 1
    took = route(dtype, chunk, p, n, which)
    assert ssd_chunk.route_launches[took] == by_route[took] + 1
    want = ssd_chunk_op_ref(x, a, B, C, chunk)
    for out, ref, want_dtype in zip(got, want, (dtype, torch.float32, torch.float32)):
        assert out.dtype == want_dtype and out.shape == ref.shape
        _close(out, ref, want_dtype)


@pytest.mark.parametrize("which", ["cuda_cores", None])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("l,h,p,n,groups,chunk", [
    (512, 32, 64, 128, 1, 256),    # Mamba2-370m's prefill of 512 tokens
    (200, 8, 64, 128, 2, 256),     # ragged single chunk, two groups
    (100, 4, 32, 16, 2, 32),       # ragged last chunk, reduced widths
])
def test_ssd_chunk_matches_plain(dev, dtype, l, h, p, n, groups, chunk, which):
    _ssd_matches_plain(dev, dtype, l, h, p, n, groups, chunk, "fast", which)


@pytest.mark.parametrize("which", ["cuda_cores", None])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("l,h,p,n,groups,chunk", [
    (512, 32, 64, 128, 1, 256),    # Mamba2-370m's prefill of 512 tokens
    (384, 32, 64, 128, 2, 256),    # ragged last chunk, two groups
])
def test_ssd_chunk_slow_decays_match_plain(dev, dtype, l, h, p, n, groups, chunk, which):
    """Decays slow enough that a kernel which dropped key tiles far below
    the diagonal, or early positions of the state, would fail."""
    _ssd_matches_plain(dev, dtype, l, h, p, n, groups, chunk, "slow", which)


@pytest.mark.parametrize("decay", ["fast", "slow"])
@pytest.mark.parametrize("l,h,p,n,groups,chunk", [
    (512, 32, 64, 128, 1, 256),    # Mamba2-370m's prefill of 512 tokens
    (300, 32, 64, 128, 1, 256),    # ragged length
    (200, 32, 64, 128, 1, 256),    # one ragged chunk
    (384, 32, 64, 128, 2, 256),    # two groups, ragged last chunk
    (512, 32, 64, 16, 1, 256),     # jamba's N = 16: cp.async, zero-padded columns
    (512, 32, 64, 128, 1, 64),     # chunks of one row tile
    (512, 32, 64, 128, 1, 128),    # chunks of two row tiles
    (320, 8, 128, 256, 2, 128),    # P = 128, N = 256: the widest tiles
    (200, 6, 32, 64, 2, 64),       # P = 32; three heads per group, a slice of one
    (1100, 4, 64, 64, 2, 1024),    # the longest chunk it takes (16 row tiles), ragged
])
def test_ssd_chunk_tensor_cores_match_plain(dev, l, h, p, n, groups, chunk, decay):
    """K4's tensor-core route in bf16 against the plain version, with the
    random model's fast decays and Mamba2's slow ones."""
    assert tensor_cores_take(torch.bfloat16, chunk, p, n)
    _ssd_matches_plain(dev, torch.bfloat16, l, h, p, n, groups, chunk, decay, "tensor_cores")


@pytest.mark.parametrize("which", ["cuda_cores", None])
@pytest.mark.parametrize("h", [16, 8, 2])
def test_ssd_chunk_on_a_ranks_local_heads_matches_plain(dev, h, which):
    """Mamba2-370m's prefill with its 32 heads split over a model axis of
    2, 4 or 16: the head counts K4 takes under a mesh, Mamba2's slow
    decays, forced onto the CUDA cores and on the default route (the
    tensor cores)."""
    _ssd_matches_plain(dev, torch.bfloat16, 512, h, 64, 128, 1, 256, "slow", which)


def test_ssd_chunk_cuda_cores_forced_at_the_served_shape(dev):
    """The served bf16 shape takes the tensor-core kernel by default and
    when named, and the CUDA-core kernel only when named; each agrees with
    the plain version."""
    x, a, B, C = _ssd_inputs(dev, torch.bfloat16, 1, 512, 32, 64, 128, 1, "slow")
    want = ssd_chunk_op_ref(x, a, B, C, 256)
    for which, took in ((None, "tensor_cores"), ("cuda_cores", "cuda_cores"),
                        ("tensor_cores", "tensor_cores")):
        before = dict(ssd_chunk.route_launches)
        got = ssd_chunk_op(x, a, B, C, 256, which=which)
        assert {r: n - before[r] for r, n in ssd_chunk.route_launches.items()} == {
            r: int(r == took) for r in before}
        for out, ref, dtype in zip(got, want, (torch.bfloat16, torch.float32, torch.float32)):
            _close(out, ref, dtype)


@pytest.mark.parametrize("decay", ["fast", "slow"])
@pytest.mark.parametrize("l,h,p,n,groups,chunk", [
    (512, 32, 64, 128, 1, 256),    # Mamba2-370m's prefill of 512 tokens (served)
    (512, 16, 64, 128, 1, 256),    # its heads on 2 model ranks
    (512, 8, 64, 128, 1, 256),     # on 4
    (512, 2, 64, 128, 1, 256),     # on 16
    (384, 32, 64, 128, 2, 256),    # two groups, ragged last chunk
    (512, 32, 64, 16, 1, 256),     # jamba's N = 16 (cp.async)
])
def test_ssd_chunk_default_route_is_the_tensor_cores(dev, l, h, p, n, groups, chunk, decay):
    """The shapes the served models give K4 take the tensor-core kernel
    (each head its own C B^T, S in registers) without naming it, and
    agree with the plain version."""
    assert route(torch.bfloat16, chunk, p, n) == "tensor_cores"
    _ssd_matches_plain(dev, torch.bfloat16, l, h, p, n, groups, chunk, decay)


def test_ssd_chunk_tensor_core_kernel_has_hgmma(dev):
    """The bf16 K4 functions' SASS carries wgmma (HGMMA) instructions and
    no warp-level mma (HMMA)."""
    counts = build.sass_counts("ssd_chunk_tc", ("HGMMA", "HMMA"))
    if counts is None:
        pytest.skip("the toolkit has no cuobjdump")
    assert counts and all(c["HGMMA"] > 0 and c["HMMA"] == 0 for c in counts.values()), counts


def test_ssd_chunk_fused_layout_matches_plain(dev):
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(6, 2, 64, 16, device=dev, generator=g) * 0.3
    a = -torch.rand(6, 2, 64, device=dev, generator=g)
    B = torch.randn(6, 2, 64, 32, device=dev, generator=g) * 0.3
    C = torch.randn(6, 2, 64, 32, device=dev, generator=g) * 0.3
    for out, ref in zip(ssd_chunk(x, a, B, C), ssd_chunk_ref(x, a, B, C)):
        _close(out, ref, torch.float32)


def test_ssd_chunk_fused_layout_on_the_tensor_cores(dev):
    """The (BH, nc, Q, .) wrapper in bf16 launches the tensor-core kernel
    with one head and one group per fused row (head strides of 0)."""
    g = torch.Generator(device=dev).manual_seed(3)
    x = (torch.randn(6, 2, 64, 64, device=dev, generator=g) * 0.3).bfloat16()
    a = -torch.rand(6, 2, 64, device=dev, generator=g)
    B = (torch.randn(6, 2, 64, 64, device=dev, generator=g) * 0.3).bfloat16()
    C = (torch.randn(6, 2, 64, 64, device=dev, generator=g) * 0.3).bfloat16()
    before = ssd_chunk.route_launches["tensor_cores"]
    got = ssd_chunk(x, a, B, C, which="tensor_cores")
    assert ssd_chunk.route_launches["tensor_cores"] == before + 1
    for out, ref, dtype in zip(got, ssd_chunk_ref(x, a, B, C),
                               (torch.bfloat16, torch.float32, torch.float32)):
        _close(out, ref, dtype)


@pytest.mark.parametrize("width", [1, 7, 4096])
def test_relay_is_bit_exact(dev, width):
    g = torch.Generator(device=dev).manual_seed(0)
    s = torch.randint(0, 255, (9, width), dtype=torch.uint8, device=dev, generator=g)
    perm = torch.randperm(9, device=dev, generator=g).to(torch.int32)
    n = relay_assemble.launches
    assert torch.equal(relay_assemble(s, perm), relay_assemble_ref(s, perm))
    assert relay_assemble.launches == n + 1


@pytest.mark.parametrize("n_devices,target,direct_priority",
                         [(1, 0, True), (2, 1, False)])
def test_data_plane_bit_exact_on_the_card(dev, n_devices, target, direct_priority):
    x = torch.arange(300_001, dtype=torch.int32)
    eng = make_functional_engine(
        [dev] * n_devices,
        MMAConfig(chunk_bytes=4096, fallback_bytes=0,
                  direct_priority=direct_priority),
    )
    y = multipath_device_put(x, target=target, engine=eng)
    assert y.device == dev and torch.equal(y.cpu(), x)
    z = multipath_device_get(y, target=target, engine=eng)
    assert z.is_pinned() and torch.equal(z, x)
    relays = sum(w.chunks_relay for w in eng.workers.values())
    assert (relays > 0) == (not direct_priority)


def test_reduced_model_on_the_card_matches_cpu(dev):
    """Prefill and 4 greedy decode steps through K3/K2 on the card against
    the plain versions on the CPU, same fp32 weights."""
    cfg = get_config("tinyllama-1.1b").reduced()
    cpu_params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    gpu_params = tree_map(lambda t: t.to(dev), cpu_params)
    toks = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab, (2, 40))).long()
    cl, cc, cn = prefill(cpu_params, toks, cfg, max_len=48)
    gl, gc, gn = prefill(gpu_params, toks.to(dev), cfg, max_len=48)
    _close(gl, cl, torch.float32)
    for _ in range(4):
        tok = torch.argmax(cl, -1)
        assert torch.equal(torch.argmax(gl, -1).cpu(), tok)
        cl, cc = decode_step(cpu_params, tok, cc, cn, cfg)
        gl, gc = decode_step(gpu_params, tok.to(dev), gc, gn, cfg)
        cn += 1
        gn += 1
        _close(gl, cl, torch.float32)


def test_reduced_mamba2_on_the_card_matches_cpu(dev):
    """Prefill (K4, a ragged last chunk) and 4 greedy recurrent decode steps
    on the card against the plain version on the CPU, same fp32 weights."""
    cfg = get_config("mamba2-370m").reduced()
    cpu_params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    gpu_params = tree_map(lambda t: t.to(dev), cpu_params)
    toks = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab, (2, 40))).long()
    before = ssd_chunk.launches
    cl, cc, cn = prefill(cpu_params, toks, cfg, max_len=48)
    gl, gc, gn = prefill(gpu_params, toks.to(dev), cfg, max_len=48)
    assert ssd_chunk.launches == before + cfg.n_layers
    _close(gl, cl, torch.float32)
    for _ in range(4):
        tok = torch.argmax(cl, -1)
        assert torch.equal(torch.argmax(gl, -1).cpu(), tok)
        cl, cc = decode_step(cpu_params, tok, cc, cn, cfg)
        gl, gc = decode_step(gpu_params, tok.to(dev), gc, gn, cfg)
        cn += 1
        gn += 1
        _close(gl, cl, torch.float32)
    for c_cache, g_cache in zip(cc, gc):
        for name in c_cache:
            _close(g_cache[name], c_cache[name], torch.float32)


def _olmoe_experts(S):
    """OLMoE's routing (64 experts, top 8, capacity factor 1.25) at reduced
    widths in fp32, with its init's scales."""
    cfg = dataclasses.replace(get_config("olmoe-1b-7b").reduced(), n_experts=64,
                              top_k=8, capacity_factor=1.25)
    g = torch.Generator().manual_seed(0)
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {"router": torch.randn(d, E, generator=g) * d ** -0.5,
         "w_gate": torch.randn(E, d, f, generator=g) * E ** -0.5,
         "w_up": torch.randn(E, d, f, generator=g) * E ** -0.5,
         "w_down": torch.randn(E, f, d, generator=g) * E ** -0.5}
    return cfg, p, torch.randn(2, S, d, generator=g)


@pytest.mark.parametrize("S", [1, 512])
def test_moe_ffn_on_the_card_matches_cpu(dev, S):
    """moe_ffn on the card against the same call on the CPU in fp32 (TF32
    off): the same routes and drops, the output within 1e-4 of its largest
    magnitude (the E^-0.5 expert scale makes outputs of several hundred)."""
    cfg, p, x = _olmoe_experts(S)
    gp = {k: t.to(dev) for k, t in p.items()}
    ci, gi = router(p, x, cfg)[1], router(gp, x.to(dev), cfg)[1]
    assert torch.equal(gi.cpu(), ci)
    pos = slot_positions(ci, cfg.n_experts)
    assert torch.equal(slot_positions(gi, cfg.n_experts).cpu(), pos)
    dropped = int((pos >= capacity(S, cfg)).sum())
    want, aux = moe_ffn(p, x, cfg, return_aux=True)
    got, gaux = moe_ffn(gp, x.to(dev), cfg, return_aux=True)
    scale = want.abs().max().item()
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-4 * scale, err_msg=f"{dropped} dropped")
    np.testing.assert_allclose(gaux.item(), aux.item(), rtol=1e-4)


def test_card_tracer_times_the_moe_stages_on_the_card(dev):
    """With the card tracer (``obs.card``) in place, moe_ffn on the card
    gives the same output, and each stage's row carries its card time: the
    three within the whole call's time between two events around it."""
    from repro_torch.obs import card

    cfg, p, x = _olmoe_experts(256)
    gp, gx = {k: t.to(dev) for k, t in p.items()}, x.to(dev)
    want = moe_ffn(gp, gx, cfg)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    tr = card.install()
    try:
        start.record()
        got = moe_ffn(gp, gx, cfg)
        end.record()
    finally:
        card.uninstall()
    end.synchronize()
    assert torch.equal(got, want)
    rows = {s.name: s for s in tr.all_spans()}
    stages = [rows[f"mma.moe.{n}"].args["device_s"] for n in ("route", "experts", "combine")]
    assert all(t > 0 for t in stages)
    assert sum(stages) <= start.elapsed_time(end) / 1e3 + 2e-6     # 0.5 us a reading
    assert "device_s" not in rows["mma.moe"].args


def test_reduced_olmoe_on_the_card_matches_cpu(dev):
    """Prefill (K3, MoE layers with capacity drops) and 4 greedy decode
    steps (K2) on the card against the plain versions on the CPU, same fp32
    weights."""
    cfg = get_config("olmoe-1b-7b").reduced()
    cpu_params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    gpu_params = tree_map(lambda t: t.to(dev), cpu_params)
    toks = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab, (2, 40))).long()
    before = (flash_attention.launches, decode_attention.launches)
    cl, cc, cn = prefill(cpu_params, toks, cfg, max_len=48)
    gl, gc, gn = prefill(gpu_params, toks.to(dev), cfg, max_len=48)
    _close(gl, cl, torch.float32)
    for _ in range(4):
        tok = torch.argmax(cl, -1)
        assert torch.equal(torch.argmax(gl, -1).cpu(), tok)
        cl, cc = decode_step(cpu_params, tok, cc, cn, cfg)
        gl, gc = decode_step(gpu_params, tok.to(dev), gc, gn, cfg)
        cn += 1
        gn += 1
        _close(gl, cl, torch.float32)
    assert (flash_attention.launches - before[0],
            decode_attention.launches - before[1]) == (cfg.n_layers, 4 * cfg.n_layers)


def test_reduced_vlm_on_the_card_matches_cpu(dev):
    """The reduced llama-3.2-vision with a frontend: prefill (K3, 2 of the 10
    launches without the causal mask) and 4 greedy decode steps (K2, the
    cross layers over every frontend key) on the card against the plain
    versions on the CPU, same fp32 weights and frontend."""
    cfg = get_config("llama-3.2-vision-90b").reduced()
    cpu_params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    gpu_params = tree_map(lambda t: t.to(dev), cpu_params)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 40))).long()
    fe = torch.from_numpy(rng.standard_normal((2, 100, cfg.d_model)).astype(np.float32))
    before = (flash_attention.launches, decode_attention.launches)
    cl, cc, cn = prefill(cpu_params, toks, cfg, max_len=48, frontend=fe)
    gl, gc, gn = prefill(gpu_params, toks.to(dev), cfg, max_len=48, frontend=fe.to(dev))
    _close(gl, cl, torch.float32)
    for _ in range(4):
        tok = torch.argmax(cl, -1)
        assert torch.equal(torch.argmax(gl, -1).cpu(), tok)
        cl, cc = decode_step(cpu_params, tok, cc, cn, cfg, frontend=fe)
        gl, gc = decode_step(gpu_params, tok.to(dev), gc, gn, cfg, frontend=fe.to(dev))
        cn += 1
        gn += 1
        _close(gl, cl, torch.float32)
    assert (flash_attention.launches - before[0],
            decode_attention.launches - before[1]) == (cfg.n_layers, 4 * cfg.n_layers)


def test_reduced_musicgen_on_the_card_matches_cpu(dev):
    """The reduced musicgen through inputs_embeds: prefill from frame
    embeddings and 4 decode steps, 2 from greedy tokens and 2 from (B, 1, d)
    embeddings, on the card against the CPU, same fp32 weights."""
    cfg = get_config("musicgen-large").reduced()
    cpu_params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    gpu_params = tree_map(lambda t: t.to(dev), cpu_params)
    rng = np.random.default_rng(0)
    emb = torch.from_numpy(rng.standard_normal((2, 40, cfg.d_model)).astype(np.float32))
    cl, cc, cn = prefill(cpu_params, None, cfg, max_len=48, inputs_embeds=emb)
    gl, gc, gn = prefill(gpu_params, None, cfg, max_len=48, inputs_embeds=emb.to(dev))
    _close(gl, cl, torch.float32)
    for step in range(4):
        tok = torch.argmax(cl, -1)
        assert torch.equal(torch.argmax(gl, -1).cpu(), tok)
        if step < 2:
            cl, cc = decode_step(cpu_params, tok, cc, cn, cfg)
            gl, gc = decode_step(gpu_params, tok.to(dev), gc, gn, cfg)
        else:
            e = torch.from_numpy(rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32))
            cl, cc = decode_step(cpu_params, None, cc, cn, cfg, inputs_embeds=e)
            gl, gc = decode_step(gpu_params, None, gc, gn, cfg, inputs_embeds=e.to(dev))
        cn += 1
        gn += 1
        _close(gl, cl, torch.float32)


# ---------------------------------------------------------------------------
# Gradients on the card
# ---------------------------------------------------------------------------
def test_wide_head_launches_refuse_what_the_kernels_cannot_take(dev):
    """D past 256 for K3 and K2, and R = 32 at D = 256 for K2, raise before
    any launch; the plain versions on the CPU take them."""
    z = lambda *s: torch.zeros(*s, device=dev, dtype=torch.bfloat16)
    n3, n2 = flash_attention.launches, decode_attention.launches
    with pytest.raises(ValueError, match="CUDA kernel takes"):
        flash_attention(z(1, 2, 8, 320), z(1, 2, 8, 320), z(1, 2, 8, 320))
    with pytest.raises(ValueError, match="CUDA kernel takes"):
        decode_attention(z(1, 32, 256), z(1, 1, 8, 256), z(1, 1, 8, 256), 4)
    assert (flash_attention.launches, decode_attention.launches) == (n3, n2)


def test_reduced_gemma_with_256_wide_heads_on_the_card_matches_cpu(dev):
    """Reduced gemma-7b with its head width of 256 (``reduced()`` caps it
    at 64): prefill and 4 greedy decode steps through K3/K2 on the card
    against the plain versions on the CPU, same fp32 weights."""
    cfg = dataclasses.replace(get_config("gemma-7b").reduced(), head_dim=256)
    cpu_params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    gpu_params = tree_map(lambda t: t.to(dev), cpu_params)
    toks = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab, (2, 40))).long()
    cl, cc, cn = prefill(cpu_params, toks, cfg, max_len=48)
    gl, gc, gn = prefill(gpu_params, toks.to(dev), cfg, max_len=48)
    _close(gl, cl, torch.float32)
    for _ in range(4):
        tok = torch.argmax(cl, -1)
        assert torch.equal(torch.argmax(gl, -1).cpu(), tok)
        cl, cc = decode_step(cpu_params, tok, cc, cn, cfg)
        gl, gc = decode_step(gpu_params, tok.to(dev), gc, gn, cfg)
        cn += 1
        gn += 1
        _close(gl, cl, torch.float32)


def _rel_to_scale(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp_min(1e-30)).item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,T,H,G,D,causal,window,q_offset", [
    (2, 512, 512, 32, 4, 64, True, 0, 0),      # TinyLlama's heads at a train shape
    (1, 200, 200, 8, 2, 128, True, 64, 0),     # window, ragged tiles, D = 128
    (1, 64, 576, 8, 2, 64, True, 0, 512),      # a later chunk of a prompt
    (1, 100, 576, 16, 2, 64, False, 0, 0),     # cross-attention
    (1, 512, 512, 16, 16, 256, True, 0, 0),    # gemma-7b's heads, D = 256
    (1, 100, 300, 8, 2, 192, False, 0, 0),     # D = 192, not causal
    (1, 40, 64, 8, 2, 64, True, 16, 48),       # the last 9 rows see no key
])
def test_flash_attention_backward_on_the_card_matches_plain(
        dev, dtype, B, S, T, H, G, D, causal, window, q_offset):
    """K3 through FlashAttentionFn, its backward K3b: its output and (dq,
    dk, dv) against autograd through the plain version on the same inputs
    and dO, relative to each gradient's largest magnitude."""
    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn(B, S, H, D, device=dev, generator=g).to(dtype)
    k, v = (torch.randn(B, T, G, D, device=dev, generator=g).to(dtype) for _ in range(2))
    do = torch.randn(B, S, H, D, device=dev, generator=g).to(dtype)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before, before_b = flash_attention.launches, flash_attention_op_bwd.launches
    out = flash_attention_op(*leaves, **kw)
    assert flash_attention.launches == before + 1
    got = torch.autograd.grad(out, leaves, do)
    assert flash_attention_op_bwd.launches == before_b + 1
    plain = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref = flash_attention_op_ref(*plain, **kw)
    want = torch.autograd.grad(ref, plain, do)
    _close(out.detach(), ref.detach(), dtype)
    tol = TOL[dtype]["atol"]
    for a, b in zip(got, want):
        assert a.dtype == dtype and torch.isfinite(a).all()
        assert _rel_to_scale(a, b) <= tol


def _k3b_inputs(dev, dtype, B, S, T, H, G, D, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    q, do = (torch.randn(B, S, H, D, device=dev, generator=g).to(dtype) for _ in range(2))
    k, v = (torch.randn(B, T, G, D, device=dev, generator=g).to(dtype) for _ in range(2))
    return q, k, v, do


def test_k3b_at_the_train_shape_matches_plain(dev):
    """K3b at TinyLlama's train shape (8 x 512 tokens, 32 query heads on 4
    KV heads of 64, bf16, causal) against autograd through the plain
    version on the same inputs and dO (2e-2 of each gradient's max), and
    the forward's lse against the plain helper's."""
    q, k, v, do = _k3b_inputs(dev, torch.bfloat16, 8, 512, 512, 32, 4, 64)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = flash_attention_op(*leaves)
    lse = out.grad_fn.saved_tensors[4]
    want_lse = flash_attention_lse_ref(q.transpose(1, 2), k.transpose(1, 2))
    assert (lse - want_lse).abs().max().item() <= 1e-4
    got = torch.autograd.grad(out, leaves, do)
    plain = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(flash_attention_op_ref(*plain), plain, do)
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16 and torch.isfinite(a).all()
        assert _rel_to_scale(a, b) <= TOL[torch.bfloat16]["atol"]


@pytest.mark.parametrize("dtype,B,S,T,H,G,D,window,q_offset", [
    (torch.bfloat16, 2, 512, 512, 32, 4, 64, 0, 0),     # tensor cores
    (torch.bfloat16, 1, 40, 64, 8, 2, 64, 16, 48),      # rows that see no key
    (torch.float32, 8, 128, 128, 32, 4, 64, 0, 0),      # launch.train's fp32 shape
    (torch.bfloat16, 1, 200, 200, 16, 16, 256, 0, 0),   # CUDA cores at D = 256
])
def test_k3b_gives_the_same_bits_twice(dev, dtype, B, S, T, H, G, D, window, q_offset):
    """No atomics: the same inputs give the same dq, dk, dv bits."""
    q, k, v, do = _k3b_inputs(dev, dtype, B, S, T, H, G, D, seed=1)
    kw = dict(causal=True, window=window, q_offset=q_offset)
    from repro_torch.kernels.flash_attention.ops import _forward

    o, lse = _forward(q, k, v, True, window, q_offset, with_lse=True)
    first = flash_attention_op_bwd(q, k, v, o, do, lse, **kw)
    second = flash_attention_op_bwd(q, k, v, o, do, lse, **kw)
    for a, b in zip(first, second):
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))


@pytest.mark.parametrize("dtype,B,S,T,H,G,D,window,q_offset", [
    (torch.bfloat16, 8, 512, 512, 32, 4, 64, 0, 0),     # the train shape: tensor cores
    (torch.float32, 8, 128, 128, 32, 4, 64, 0, 0),      # launch.train's fp32: CUDA cores
    (torch.bfloat16, 1, 130, 130, 8, 2, 80, 0, 0),      # D = 80, tensor cores by cp.async
    (torch.float32, 1, 130, 130, 8, 2, 80, 0, 0),       # D = 80, CUDA cores, walked 32
    (torch.bfloat16, 1, 100, 300, 8, 2, 192, 0, 200),   # D = 192, CUDA cores, walked 16
    (torch.bfloat16, 1, 512, 512, 16, 16, 256, 0, 0),   # gemma's D = 256, R = 1
    (torch.float32, 1, 200, 200, 8, 8, 64, 0, 0),       # R = 1
    (torch.bfloat16, 2, 256, 256, 8, 4, 64, 0, 0),      # R = 2
    (torch.float32, 2, 100, 100, 8, 4, 64, 32, 0),      # R = 2, a window
    (torch.bfloat16, 1, 256, 256, 16, 2, 128, 0, 0),    # R = 8 at D = 128
    (torch.float32, 2, 100, 100, 16, 2, 64, 0, -20),    # R = 8, rows before position 0
    (torch.float32, 1, 70, 90, 4, 2, 30, 0, 20),        # D % 4 != 0: staged element-wise
    (torch.bfloat16, 1, 70, 90, 4, 2, 140, 0, 20),      # bf16 D % 8 != 0 on the CUDA cores
    (torch.bfloat16, 1, 70, 90, 4, 2, 100, 0, 20),      # ... and on the tensor cores
])
def test_k3b_matches_plain_and_repeats_its_bits_on_each_route(dev, dtype, B, S, T, H, G, D,
                                                              window, q_offset):
    """K3b on both routes, with the head slices its dK/dV pass takes there:
    (dq, dk, dv) against autograd through the plain version on the same
    inputs and dO (2e-2 / 1e-4 of each gradient's max), and the same bits
    on a second call."""
    from repro_torch.kernels.flash_attention.ops import _forward

    q, k, v, do = _k3b_inputs(dev, dtype, B, S, T, H, G, D, seed=5)
    kw = dict(causal=True, window=window, q_offset=q_offset)
    o, lse = _forward(q, k, v, True, window, q_offset, with_lse=True)
    first = flash_attention_op_bwd(q, k, v, o, do, lse, **kw)
    second = flash_attention_op_bwd(q, k, v, o, do, lse, **kw)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(flash_attention_op_ref(*leaves, **kw), leaves, do)
    for a, b, w in zip(first, second, want):
        assert a.dtype == dtype and torch.isfinite(a).all()
        assert _rel_to_scale(a, w) <= TOL[dtype]["atol"]
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))


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
def test_k3b_head_slices_follow_the_rule(dev, B, H, G, T, want):
    """The C source's head slices of K3b's dK/dV pass (the fewest dividing
    R that give 256 blocks) and the fp32 partials they ask for."""
    lib = build.library()
    assert lib.flash_attention_bwd_head_slices(B, H, G, T) == want
    D = 64
    assert lib.flash_attention_bwd_scratch_floats(B, H, G, T, D) == \
        (2 * want * B * T * G * D if want > 1 else 0)


@pytest.mark.parametrize("dtype,H,G,D,S,T,causal,window,q_offset", [
    (torch.bfloat16, 32, 4, 64, 512, 512, True, 0, 0),
    (torch.bfloat16, 64, 8, 128, 512, 576, False, 0, 0),
    (torch.bfloat16, 16, 16, 256, 512, 512, True, 0, 0),
    (torch.bfloat16, 32, 4, 64, 64, 512, True, 48, 504),
    (torch.float32, 32, 4, 64, 128, 128, True, 0, 0),
])
def test_k3_output_is_the_same_with_and_without_lse(dev, dtype, H, G, D, S, T, causal,
                                                    window, q_offset):
    """Writing the row log-sum-exp for K3b leaves K3's output bit for bit
    what a served call (no lse) gets, and the lse is the plain helper's."""
    from repro_torch.kernels.flash_attention.ops import _forward

    q, k, v, _ = _k3b_inputs(dev, dtype, 1, S, T, H, G, D, seed=2)
    served = _forward(q, k, v, causal, window, q_offset)
    out, lse = _forward(q, k, v, causal, window, q_offset, with_lse=True)
    assert torch.equal(served.view(torch.uint8), out.view(torch.uint8))
    want = flash_attention_lse_ref(q.transpose(1, 2), k.transpose(1, 2), causal=causal,
                                   window=window, q_offset=q_offset)
    assert (lse - want).abs().max().item() <= 1e-4


def test_k3b_tensor_core_kernels_carry_hgmma(dev):
    """K3b's bf16 kernels (both passes at D 64 and 128) run on wgmma."""
    flash_attention_op_bwd(*_k3b_bwd_args(dev))            # builds the library
    counts = build.sass_counts("flash_bwd", ("HGMMA", "HMMA"))
    if counts is None:
        pytest.skip("the toolkit has no cuobjdump")
    tc = {n: c for n, c in counts.items() if "wgmma" in n}
    assert len(tc) == 4 and all(c["HGMMA"] > 0 for c in tc.values()), counts


def _k3b_bwd_args(dev, dtype=torch.bfloat16, D=64):
    from repro_torch.kernels.flash_attention.ops import _forward

    q, k, v, do = _k3b_inputs(dev, dtype, 1, 64, 64, 4, 2, D)
    o, lse = _forward(q, k, v, True, 0, 0, with_lse=True)
    return q, k, v, o, do, lse


def test_k3b_refuses_what_it_cannot_take(dev):
    """On the card the op launches K3b or raises: no lse, dtypes that
    differ, an lse of another shape, heads past 256."""
    q, k, v, o, do, lse = _k3b_bwd_args(dev)
    before = flash_attention_op_bwd.launches
    with pytest.raises(ValueError, match="lse"):
        flash_attention_op_bwd(q, k, v, o, do, None)
    with pytest.raises(TypeError):
        flash_attention_op_bwd(q, k.float(), v, o, do, lse)
    with pytest.raises(ValueError, match="lse"):
        flash_attention_op_bwd(q, k, v, o, do, lse.transpose(1, 2).contiguous())
    wide = torch.zeros(1, 8, 2, 264, device=dev, dtype=torch.bfloat16)
    kv = torch.zeros(1, 8, 1, 264, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="D <= 256"):
        flash_attention_op_bwd(wide, kv, kv, wide, wide,
                               torch.zeros(1, 2, 8, device=dev))
    assert flash_attention_op_bwd.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_model_grads_on_the_card_match_plain_path(dev, dtype):
    """loss.backward() of a 2-layer dense model on the card (K3 forward,
    its recompute under remat, FlashAttentionFn's backward) gives every
    parameter leaf a finite gradient within 2e-2 (bf16) / 1e-4 (fp32) of
    the plain path's on the card, relative to the leaf's largest
    magnitude."""
    from unittest import mock

    import repro_torch.models.attention as attention

    cfg = dataclasses.replace(get_config("tinyllama-1.1b").reduced(), dtype=dtype)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    toks = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab, (2, 129))).long().to(dev)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def grads():
        live = tree_map(lambda t: t.detach().clone().requires_grad_(True), params)
        loss, _ = loss_fn(live, batch, cfg)
        loss.backward()
        return loss.detach(), [t.grad for t in tree_leaves(live)]

    before, before_b = flash_attention.launches, flash_attention_op_bwd.launches
    loss, got = grads()
    assert flash_attention.launches - before == 2 * cfg.n_layers   # forward + remat
    assert flash_attention_op_bwd.launches - before_b == cfg.n_layers   # K3b
    with mock.patch.object(attention, "flash_attention_op", flash_attention_op_ref):
        plain_loss, want = grads()
    assert torch.isfinite(loss)
    for a, b in zip(got, want):
        assert a is not None and torch.isfinite(a).all() and a.abs().max() > 0
        assert _rel_to_scale(a, b) <= TOL[dtype]["atol"]


def test_kernels_without_a_gradient_refuse_one_on_the_card(dev):
    """K2, and K3 and K4 called outside FlashAttentionFn and SSDChunkFn
    (the fused-layout ``ssd_chunk``), raise where autograd would record
    their launch, and run under no_grad; ``ssd_chunk_op`` carries K4's
    gradient through K4b."""
    q = torch.randn(1, 1, 8, 64, device=dev, requires_grad=True)
    kv = torch.randn(1, 32, 2, 64, device=dev)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        decode_attention_op(q, kv, kv, 16)
    x = torch.randn(1, 64, 4, 32, device=dev, requires_grad=True)
    a = -torch.rand(1, 64, 4, device=dev)
    Bm = torch.randn(1, 64, 1, 16, device=dev)
    before = ssd_chunk_bwd.launches
    y, _, _ = ssd_chunk_op(x, a, Bm, Bm, 32)
    (dx,) = torch.autograd.grad(y.square().sum(), x)
    assert ssd_chunk_bwd.launches == before + 1
    assert torch.isfinite(dx).all() and dx.abs().max() > 0
    xf = torch.randn(4, 2, 32, 32, device=dev, requires_grad=True)
    af = -torch.rand(4, 2, 32, device=dev)
    Bf = torch.randn(4, 2, 32, 16, device=dev)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ssd_chunk(xf, af, Bf, Bf)
    qh = torch.randn(1, 8, 64, 64, device=dev, requires_grad=True)
    kh = torch.randn(1, 2, 64, 64, device=dev)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        flash_attention(qh, kh, kh)
    with torch.no_grad():
        decode_attention_op(q, kv, kv, 16)
        ssd_chunk_op(x, a, Bm, Bm, 32)
        ssd_chunk(xf, af, Bf, Bf)
        flash_attention(qh, kh, kh)


def _ssd_grads_match_plain(dev, dtype, b, l, h, p, n, groups, chunk, decay, which,
                           bwd_which=None):
    """K4 forward on route ``which`` (the default when None), then K4b on
    route ``bwd_which`` (its default when None), through SSDChunkFn: dx,
    da, dB and dC against ``ssd_chunk_op_bwd_ref`` on the same inputs and
    cotangents, each relative to that gradient's largest magnitude, at x's
    dtype's tolerance; one K4b launch, on the route ``bwd_route`` names."""
    import functools
    import importlib
    from unittest import mock

    ops = importlib.import_module("repro_torch.kernels.ssd_chunk.ops")
    x, a, B, C = _ssd_inputs(dev, dtype, b, l, h, p, n, groups, decay)
    g = torch.Generator(device=dev).manual_seed(3)
    with torch.no_grad():
        shapes = [o.shape for o in ssd_chunk_op_ref(x, a, B, C, chunk)]
    dy = torch.randn(shapes[0], device=dev, generator=g).to(dtype)
    dst, dde = (torch.randn(s, device=dev, generator=g) for s in shapes[1:])
    leaves = [t.clone().requires_grad_(True) for t in (x, a, B, C)]
    before = ssd_chunk_bwd.launches
    took = bwd_route(dtype, chunk, p, n, bwd_which)
    by_route = dict(ssd_chunk_bwd.route_launches)
    with mock.patch.object(ops, "ssd_chunk_op_bwd",
                           functools.partial(ops.ssd_chunk_op_bwd, which=bwd_which)):
        got = torch.autograd.grad(ssd_chunk_op(*leaves, chunk, which=which), leaves,
                                  (dy, dst, dde))
    assert ssd_chunk_bwd.launches == before + 1
    assert ssd_chunk_bwd.route_launches[took] == by_route[took] + 1
    want = ssd_chunk_op_bwd_ref(x, a, B, C, chunk, dy, dst, dde)
    for gt, w in zip(got, want):
        assert gt.dtype == w.dtype and gt.shape == w.shape and torch.isfinite(gt).all()
        assert _rel_to_scale(gt, w) <= TOL[dtype]["atol"]


@pytest.mark.parametrize("bwd_which", ["cuda_cores", None])
@pytest.mark.parametrize("which", ["cuda_cores", None])
@pytest.mark.parametrize("decay", ["fast", "slow"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,l,h,p,n,groups,chunk", [
    (8, 512, 32, 64, 128, 1, 256),   # Mamba2-370m's train shape
    (1, 384, 32, 64, 128, 2, 256),   # ragged last chunk, two groups
    (1, 300, 32, 64, 128, 1, 256),   # ragged last chunk
    (2, 100, 4, 32, 16, 2, 32),      # reduced widths, chunk 32
    (1, 120, 4, 20, 12, 1, 50),      # a chunk that is no multiple of 32
    (1, 300, 2, 32, 256, 1, 128),    # N = 256 (the wide instance)
    (1, 512, 32, 64, 16, 1, 256),    # jamba's N = 16
])
def test_ssd_chunk_bwd_matches_plain(dev, b, l, h, p, n, groups, chunk, dtype, decay, which,
                                     bwd_which):
    """Each K4 forward route, then each K4b route (the default: the tensor
    cores for the bf16 shapes they take, else the CUDA cores)."""
    _ssd_grads_match_plain(dev, dtype, b, l, h, p, n, groups, chunk, decay, which, bwd_which)


@pytest.mark.parametrize("decay", ["fast", "slow"])
@pytest.mark.parametrize("b,l,h,p,n,groups,chunk,bwd_which", [
    (2, 1024, 32, 64, 128, 1, 512, None),   # chunk 512: 8 row tiles, slices of <= 16 heads
    (2, 1024, 32, 64, 128, 1, 512, "cuda_cores"),
    (1, 1024, 16, 64, 128, 1, 1024, None),  # chunk 1024, the largest the tensor cores take
    (1, 1024, 16, 64, 128, 1, 1024, "cuda_cores"),
    (1, 700, 16, 64, 128, 2, 1024, None),   # chunk 1024, ragged, two groups
    (2, 512, 16, 128, 128, 1, 256, None),   # P = 128 at N = 128: the tensor cores alone
    (2, 512, 16, 128, 64, 1, 256, None),    # P = 128 at N = 64, on each route
    (2, 512, 16, 128, 64, 1, 256, "cuda_cores"),
    (1, 300, 8, 128, 64, 1, 512, None),     # P = 128 at chunk 512, ragged
    (1, 300, 8, 128, 64, 1, 512, "cuda_cores"),
])
def test_ssd_chunk_bwd_matches_plain_at_the_widest_shapes(dev, b, l, h, p, n, groups, chunk,
                                                          bwd_which, decay):
    """The bf16 shapes ``tensor_cores_take`` admits past Mamba2-370m's: chunks
    of 512 and 1024 (the head-slice rule caps a slice at 8192 / Q heads)
    and heads of P = 128, on the default K4b route (the tensor cores) and on
    the CUDA cores where they take the shape (at N = 128 their state
    accumulators stop at P = 64), after the default forward."""
    assert bwd_route(torch.bfloat16, chunk, p, n) == "tensor_cores"
    _ssd_grads_match_plain(dev, torch.bfloat16, b, l, h, p, n, groups, chunk, decay, None,
                           bwd_which)


@pytest.mark.parametrize("which", [None, "cuda_cores"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_chunk_bwd_gives_the_same_bits_twice(dev, dtype, which):
    """No atomics on either route (the default is the tensor cores in
    bf16): the same inputs give the same bits on every call."""
    x, a, B, C = _ssd_inputs(dev, dtype, 8, 512, 32, 64, 128, 1, "slow")
    with torch.no_grad():
        y, st, de = ssd_chunk_op(x, a, B, C, 256)
    g = torch.Generator(device=dev).manual_seed(4)
    cot = (torch.randn(y.shape, device=dev, generator=g).to(dtype),
           torch.randn(st.shape, device=dev, generator=g),
           torch.randn(de.shape, device=dev, generator=g))
    first = ssd_chunk_op_bwd(x, a, B, C, 256, *cot, which=which)
    second = ssd_chunk_op_bwd(x, a, B, C, 256, *cot, which=which)
    for u, v in zip(first, second):
        assert torch.equal(u.view(-1).view(torch.uint8), v.view(-1).view(torch.uint8))


def test_ssd_chunk_bwd_tensor_core_kernel_has_hgmma(dev):
    """K4b's tensor-core functions' SASS carries wgmma (HGMMA) instructions
    and no warp-level mma (HMMA)."""
    counts = build.sass_counts("ssd_chunk_bwd_tc", ("HGMMA", "HMMA"))
    if counts is None:
        pytest.skip("the toolkit has no cuobjdump")
    assert counts and all(c["HGMMA"] > 0 and c["HMMA"] == 0 for c in counts.values()), counts


def test_ssd_chunk_bwd_default_route_is_the_tensor_cores(dev):
    """Mamba2-370m's bf16 train shape takes K4b's tensor-core kernel
    without naming it, one launch on that route, within 2e-2 of each
    gradient's max."""
    cfg = get_config("mamba2-370m")
    h, p, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    assert bwd_route(cfg.dtype, cfg.ssm_chunk, p, n) == "tensor_cores"
    _ssd_grads_match_plain(dev, cfg.dtype, 8, 512, h, p, n, cfg.ssm_groups, cfg.ssm_chunk,
                           "slow", None)


@pytest.mark.parametrize("dtype,chunk", [(torch.float32, 256), (torch.bfloat16, 32)])
def test_ssd_chunk_bwd_forced_tensor_cores_refuse_what_they_cannot_take(dev, dtype, chunk):
    """fp32, and a chunk of 32, on the tensor cores: ValueError before
    anything is launched."""
    x, a, B, C = _ssd_inputs(dev, dtype, 1, 256, 4, 64, 128, 1, "fast")
    nc = -(-256 // chunk)
    before = ssd_chunk_bwd.launches
    with pytest.raises(ValueError, match="tensor cores"):
        ssd_chunk_op_bwd(x, a, B, C, chunk, x, torch.zeros(1, 4, nc, 64, 128, device=dev),
                         torch.zeros(1, 4, nc, chunk, device=dev), which="tensor_cores")
    assert ssd_chunk_bwd.launches == before


def test_ssd_chunk_bwd_fused_layout_matches_plain(dev):
    """``ssd_chunk_bwd`` in the (BH, nc, Q, .) layout against
    ``ssd_chunk_bwd_ref``, fp32."""
    g = torch.Generator(device=dev).manual_seed(5)
    x, dy = (torch.randn(6, 2, 64, 32, device=dev, generator=g) for _ in range(2))
    a = -torch.rand(6, 2, 64, device=dev, generator=g) * 0.2
    B, C = (torch.randn(6, 2, 64, 16, device=dev, generator=g) for _ in range(2))
    dst = torch.randn(6, 2, 32, 16, device=dev, generator=g)
    dde = torch.randn(6, 2, 64, device=dev, generator=g)
    before = ssd_chunk_bwd.launches
    got = ssd_chunk_bwd(x, a, B, C, dy, dst, dde)
    assert ssd_chunk_bwd.launches == before + 1
    for gt, w in zip(got, ssd_chunk_bwd_ref(x, a, B, C, dy, dst, dde)):
        assert gt.dtype == w.dtype
        assert _rel_to_scale(gt, w) <= TOL[torch.float32]["atol"]


@pytest.mark.parametrize("p,n,chunk", [(32, 6, 32), (129, 16, 32), (64, 256, 32),
                                       (32, 16, 2048)])
def test_ssd_chunk_bwd_refuses_what_it_cannot_take(dev, p, n, chunk):
    """N % 4, P > 128, a thread's share of a state column past 32, a chunk
    past 1024: ValueError before anything is launched."""
    x = torch.randn(1, 64, 2, p, device=dev)
    a = -torch.rand(1, 64, 2, device=dev)
    B = torch.randn(1, 64, 1, n, device=dev)
    nc = -(-64 // chunk)
    before = ssd_chunk_bwd.launches
    with pytest.raises(ValueError):
        ssd_chunk_op_bwd(x, a, B, B, chunk, x, torch.zeros(1, 2, nc, p, n, device=dev),
                         torch.zeros(1, 2, nc, chunk, device=dev))
    assert ssd_chunk_bwd.launches == before


# jamba cut to one period without experts: one attention and seven SSM layers
HYBRID_PERIOD = dict(n_experts=0, n_layers=8)


def _ssm_model(dev, name, overrides, dtype):
    """(cfg, params, batch, SSM layers) of a reduced model on the card."""
    cfg = dataclasses.replace(get_config(name).reduced(), dtype=dtype, **overrides)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    toks = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab, (2, 101))).long().to(dev)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    plan = cfg.layer_plan()
    n_ssm = cfg.n_layers // len(plan) * sum(m == "ssm" for m, _ in plan)
    return cfg, params, batch, n_ssm


def _model_grads(params, batch, cfg):
    live = tree_map(lambda t: t.detach().clone().requires_grad_(True), params)
    loss, _ = loss_fn(live, batch, cfg)
    loss.backward()
    return loss.detach(), [t.grad for t in tree_leaves(live)]


@pytest.mark.parametrize("name,overrides,dtype", [
    ("mamba2-370m", {}, torch.float32),
    ("mamba2-370m", {}, torch.bfloat16),
    ("jamba-1.5-large-398b", HYBRID_PERIOD, torch.float32),
])
def test_ssm_model_grads_on_the_card_match_plain_path(dev, name, overrides, dtype):
    """loss.backward() of a reduced Mamba2 and of one jamba period on the
    card (K4 forward, K4b; K3 and its gradient in jamba's attention layer)
    gives every leaf a finite gradient within 2e-2 (bf16) / 1e-4 (fp32) of
    the plain path's on the card (both plain versions of K4, K3's plain
    version), relative to the leaf's largest magnitude. The bf16 hybrid is
    held call by call instead (the next test): eight random bf16 layers
    carry single roundings past 2e-2 of a leaf."""
    import importlib
    from unittest import mock

    import repro_torch.models.attention as attention

    ops = importlib.import_module("repro_torch.kernels.ssd_chunk.ops")
    cfg, params, batch, n_ssm = _ssm_model(dev, name, overrides, dtype)
    before = ssd_chunk_bwd.launches
    loss, got = _model_grads(params, batch, cfg)
    assert ssd_chunk_bwd.launches - before == n_ssm
    with mock.patch.multiple(
            ops, _forward=lambda x, a, B, C, chunk, which: ssd_chunk_op_ref(x, a, B, C, chunk),
            ssd_chunk_op_bwd=ssd_chunk_op_bwd_ref), \
            mock.patch.object(attention, "flash_attention_op", flash_attention_op_ref):
        plain_loss, want = _model_grads(params, batch, cfg)
    assert torch.isfinite(loss)
    for a, b in zip(got, want):
        assert a is not None and torch.isfinite(a).all() and a.abs().max() > 0
        assert _rel_to_scale(a, b) <= TOL[dtype]["atol"]


def test_hybrid_bf16_grads_hold_every_k4_call_to_its_plain_version(dev):
    """loss.backward() of one jamba period in bf16 on the card: every K4
    forward and K4b backward held to its plain version on the same inputs
    and cotangents (2e-2 of each output's or gradient's max), two forwards
    (remat) and one backward a SSM layer, and every leaf's gradient finite
    and non-zero."""
    from unittest import mock

    from repro_torch.kernels import SSDChunkFn

    cfg, params, batch, n_ssm = _ssm_model(dev, "jamba-1.5-large-398b", HYBRID_PERIOD,
                                           torch.bfloat16)
    fwd, bwd = SSDChunkFn.forward, SSDChunkFn.backward
    errs = {"forward": [], "backward": []}

    def forward(ctx, xbar, a, B, C, chunk, which):
        out = fwd(ctx, xbar, a, B, C, chunk, which)
        ref = ssd_chunk_op_ref(xbar, a, B, C, chunk)
        errs["forward"].append(max(_rel_to_scale(o, r) for o, r in zip(out, ref)))
        ctx.probe_inputs = (xbar, a, B, C)
        return out

    def backward(ctx, dy, dstates, ddecay):
        grads = bwd(ctx, dy, dstates, ddecay)
        want = ssd_chunk_op_bwd_ref(*ctx.probe_inputs, ctx.chunk, dy, dstates, ddecay)
        errs["backward"].append(max(_rel_to_scale(g, w) for g, w in zip(grads[:4], want)))
        return grads

    with mock.patch.object(SSDChunkFn, "forward", staticmethod(forward)), \
            mock.patch.object(SSDChunkFn, "backward", staticmethod(backward)):
        loss, got = _model_grads(params, batch, cfg)
    assert torch.isfinite(loss)
    assert len(errs["forward"]) == 2 * n_ssm and len(errs["backward"]) == n_ssm  # remat
    assert max(errs["forward"] + errs["backward"]) <= TOL[torch.bfloat16]["atol"]
    for g in got:
        assert g is not None and torch.isfinite(g).all() and g.abs().max() > 0


@pytest.mark.parametrize("use_kernel", [True, False])
def test_relay_assemble_op_on_the_card(dev, use_kernel):
    """The JAX package's op: K1 (one launch) or the plain version (none),
    bit-exact against the plain version, a permutation with repeats."""
    g = torch.Generator(device=dev).manual_seed(0)
    s = torch.randint(-2 ** 15, 2 ** 15, (37, 1000), dtype=torch.int16, device=dev,
                      generator=g).view(torch.bfloat16)
    perm = torch.randint(0, 37, (37,), device=dev, generator=g).to(torch.int32)
    n = relay_assemble.launches
    out = relay_assemble_op(s, perm, use_kernel=use_kernel)
    assert relay_assemble.launches == n + int(use_kernel)
    assert torch.equal(out.view(torch.int16), relay_assemble_ref(s, perm).view(torch.int16))


@pytest.mark.parametrize("bound", ["prefill", "decode"])
def test_linear_cache_bounds_refused_on_the_card(dev, bound):
    """A prefill longer than a linear cache, and a decode step at a full
    one, raise ValueError on the card before any cache is written (the
    decode step before K2 is launched)."""
    from repro_torch.kernels import launch_counts

    cfg = dataclasses.replace(get_config("tinyllama-1.1b").reduced(), dtype=torch.bfloat16)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    toks = torch.randint(0, cfg.vocab, (2, 17), device=dev)
    if bound == "prefill":
        with pytest.raises(ValueError, match="prefill of 17 positions"):
            prefill(params, toks, cfg, max_len=16)
        return
    _, caches, n = prefill(params, toks[:, :16], cfg, max_len=16)
    kept = [c["k"].clone() for c in caches]
    before = launch_counts()
    with pytest.raises(ValueError, match="cache_len 16"):
        decode_step(params, toks[:, 16], caches, n, cfg)
    assert launch_counts()["decode_attention"] == before["decode_attention"]
    assert all(torch.equal(k, c["k"]) for k, c in zip(kept, caches))


@pytest.fixture
def one_rank_mesh(dev):
    """A ("data", "model") = (1, 1) NCCL mesh over a world of one, ended
    after the test."""
    import torch.distributed as dist

    from repro_torch.launch import make_host_mesh

    mesh = make_host_mesh(model=1)
    yield mesh
    dist.destroy_process_group()


@pytest.mark.parametrize("name", ["tinyllama-1.1b", "olmoe-1b-7b"])
def test_stage_from_host_and_wakeup_reshard_bit_exact_on_the_card(one_rank_mesh, name):
    """Each leaf lands from pinned host memory through the multipath engine
    (K1 on every leaf) into the staging layout, and the wake-up program
    reshards it into the serving layout, bit for bit."""
    from repro_torch.distributed import make_wakeup_step, stage_from_host
    from repro_torch.models import abstract_params

    cfg = get_config(name).reduced()
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    host = tree_map(lambda a: torch.randn(a.shape, generator=gen).to(a.dtype).pin_memory(),
                    abstract_params(cfg))
    fn, stage_sh, serve_sh = make_wakeup_step(cfg, one_rank_mesh)
    before = relay_assemble.launches
    eng = make_functional_engine(config=MMAConfig(chunk_bytes=4096, fallback_bytes=0))
    served = fn(stage_from_host(host, stage_sh, eng))
    torch.cuda.synchronize()
    assert relay_assemble.launches - before == len(tree_leaves(host))
    for s, h, sh in zip(tree_leaves(served), tree_leaves(host), tree_leaves(serve_sh)):
        assert tuple(s.placements) == tuple(sh.placements)
        assert s.to_local().device == dev
        assert torch.equal(s.full_tensor().cpu(), h)


def test_mamba2_under_a_one_rank_mesh_is_the_run_without_one(one_rank_mesh):
    """Reduced Mamba2 in bf16 on the card with DTensor parameters under a
    (1, 1) mesh (the mixer in the head-parallel layout, every placement
    replicated): prefill (K4 once a layer) and 3 decode steps give the
    logits and caches of the same calls without a mesh, bit for bit."""
    from repro_torch.distributed import distribute, params_shardings
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import use_mesh

    dev = torch.device("cuda", 0)
    cfg = dataclasses.replace(get_config("mamba2-370m").reduced(), dtype=torch.bfloat16)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    toks = torch.randint(0, cfg.vocab, (2, 40), device=dev)

    def run(p):
        logits, caches, n = prefill(p, toks[:, :37], cfg, max_len=64)
        out = [logits]
        for i in range(3):
            logits, caches = decode_step(p, toks[:, 37 + i], caches, n + i, cfg)
            out.append(logits)
        whole = lambda t: t.full_tensor() if hasattr(t, "full_tensor") else t
        return [whole(t) for t in out + tree_leaves(caches)]

    reset_launch_counts()
    with use_mesh(one_rank_mesh):
        meshed = run(distribute(params, params_shardings(params, one_rank_mesh)))
    assert launch_counts()["ssd_chunk"] == cfg.n_layers
    free = run(params)
    assert len(meshed) == len(free)
    for a, b in zip(meshed, free):
        assert a.dtype == b.dtype == torch.bfloat16
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))


@pytest.mark.parametrize("S", [1, 512])
def test_moe_ffn_ep_with_one_model_rank_is_moe_ffn_on_the_card(one_rank_mesh, S):
    """With a model axis of 1, moe_ffn_ep under the mesh is moe_ffn without
    one, exactly (outputs and aux loss), as JAX's falls back."""
    from repro_torch.distributed import NamedSharding, P, distribute
    from repro_torch.models import moe_ffn_ep, use_mesh

    cfg, p, x = _olmoe_experts(S)
    dev = torch.device("cuda", 0)
    gp, gx = {k: t.to(dev) for k, t in p.items()}, x.to(dev)
    want, aux = moe_ffn(gp, gx, cfg, return_aux=True)
    with use_mesh(one_rank_mesh):
        rep = NamedSharding(one_rank_mesh, P())
        got, gaux = moe_ffn_ep(distribute(gp, {k: rep for k in gp}), distribute(gx, rep),
                               dataclasses.replace(cfg, moe_ep=True), return_aux=True)
    assert torch.equal(got.full_tensor(), want) and torch.equal(gaux.full_tensor(), aux)


def test_serve_launcher_on_the_card_matches_cpu(dev):
    """``launch.serve.run`` with the reduced fp32 TinyLlama on the card: K3
    once per prefill layer and K2 once per decode step and layer, a prefix
    hit on request 3, the printed lines and the tokens of the same run on
    the CPU with the same weights."""
    import contextlib
    import io
    import re

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import serve

    cfg = get_config("tinyllama-1.1b").reduced()
    cpu_params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    printed = {}
    for where, params in (("cpu", cpu_params),
                          ("cuda", tree_map(lambda t: t.to(dev), cpu_params))):
        reset_launch_counts()
        with contextlib.redirect_stdout(io.StringIO()) as out:
            done, _ = serve.run(cfg, params=params, device=dev if where == "cuda" else "cpu")
        printed[where] = (out.getvalue(), launch_counts())
    (cpu_out, cpu_counts), (gpu_out, gpu_counts) = printed["cpu"], printed["cuda"]
    # request ids count on across servers
    assert re.sub(r"req \d+", "req", gpu_out) == re.sub(r"req \d+", "req", cpu_out)
    assert "1 prefix hits" in gpu_out
    assert done[3].hit_tokens == 48
    assert cpu_counts["flash_attention"] == cpu_counts["decode_attention"] == 0
    assert gpu_counts["flash_attention"] == 6 * cfg.n_layers
    assert gpu_counts["decode_attention"] == 6 * 5 * cfg.n_layers


def test_train_launcher_step_on_the_card_matches_cpu(dev):
    """One ``launch.train`` step of the reduced fp32 TinyLlama on the card
    (a one-rank NCCL mesh) against the same step on the CPU (gloo), the
    same initial weights: loss and gradient norm within 1e-4 relative."""
    import repro_torch.launch.train as launch_train

    cfg = get_config("tinyllama-1.1b").reduced()
    cpu_params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    argv = ["--steps", "1", "--batch", "2", "--seq", "16"]
    with _init_params_from(launch_train, cpu_params):
        card = launch_train.main(argv + ["--device", "cuda"])
        host = launch_train.main(argv + ["--device", "cpu"])
    for key in ("loss", "grad_norm"):
        assert card[0][key] == pytest.approx(host[0][key], rel=1e-4)


def _init_params_from(module, params):
    """``module.init_params`` giving ``params`` on the device asked for."""
    from unittest import mock

    return mock.patch.object(module, "init_params",
                             lambda cfg, gen, device: tree_map(lambda t: t.to(device), params))
