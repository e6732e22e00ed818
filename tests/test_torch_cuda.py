"""The port on an sm_90 card: the CUDA kernels against their plain
versions, the data plane bit-exact through real CUDA copies, a reduced
model on the card against the same model on the CPU, and gradients: K3's
through FlashAttentionFn and a 2-layer model's against the plain path's,
and the kernels without a gradient refusing one.

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
from repro_torch.kernels.ssd_chunk.ssd_chunk import route, tensor_cores_take
from repro_torch.kernels import (
    decode_attention,
    decode_attention_op,
    decode_attention_op_ref,
    decode_attention_ref,
    flash_attention,
    flash_attention_op,
    flash_attention_op_ref,
    flash_attention_ref,
    relay_assemble,
    relay_assemble_ref,
    ssd_chunk,
    ssd_chunk_op,
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


@pytest.mark.parametrize("which", [None, "tensor_cores"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("l,h,p,n,groups,chunk", [
    (512, 32, 64, 128, 1, 256),    # Mamba2-370m's prefill of 512 tokens
    (200, 8, 64, 128, 2, 256),     # ragged single chunk, two groups
    (100, 4, 32, 16, 2, 32),       # ragged last chunk, reduced widths
])
def test_ssd_chunk_matches_plain(dev, dtype, l, h, p, n, groups, chunk, which):
    _ssd_matches_plain(dev, dtype, l, h, p, n, groups, chunk, "fast", which)


@pytest.mark.parametrize("which", [None, "tensor_cores"])
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


def test_ssd_chunk_cuda_cores_forced_at_the_served_shape(dev):
    """The served bf16 shape takes the CUDA-core kernel by default and when
    named, and the tensor-core kernel only when named; each agrees with the
    plain version."""
    x, a, B, C = _ssd_inputs(dev, torch.bfloat16, 1, 512, 32, 64, 128, 1, "slow")
    want = ssd_chunk_op_ref(x, a, B, C, 256)
    for which, took in ((None, "cuda_cores"), ("cuda_cores", "cuda_cores"),
                        ("tensor_cores", "tensor_cores")):
        before = dict(ssd_chunk.route_launches)
        got = ssd_chunk_op(x, a, B, C, 256, which=which)
        assert {r: n - before[r] for r, n in ssd_chunk.route_launches.items()} == {
            r: int(r == took) for r in before}
        for out, ref, dtype in zip(got, want, (torch.bfloat16, torch.float32, torch.float32)):
            _close(out, ref, dtype)


def test_ssd_chunk_tensor_core_kernel_has_hgmma(dev):
    """The bf16 K4 functions' SASS carries wgmma (HGMMA) instructions."""
    counts = build.sass_counts("ssd_chunk_tc", ("HGMMA", "HMMA"))
    if counts is None:
        pytest.skip("the toolkit has no cuobjdump")
    assert counts and all(c["HGMMA"] > 0 for c in counts.values()), counts


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
def _rel_to_scale(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp_min(1e-30)).item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,T,H,G,D,causal,window,q_offset", [
    (2, 512, 512, 32, 4, 64, True, 0, 0),      # TinyLlama's heads at a train shape
    (1, 200, 200, 8, 2, 128, True, 64, 0),     # window, ragged tiles, D = 128
    (1, 64, 576, 8, 2, 64, True, 0, 512),      # a later chunk of a prompt
    (1, 100, 576, 16, 2, 64, False, 0, 0),     # cross-attention
])
def test_flash_attention_backward_on_the_card_matches_plain(
        dev, dtype, B, S, T, H, G, D, causal, window, q_offset):
    """K3 through FlashAttentionFn: its output and (dq, dk, dv) against
    autograd through the plain version on the same inputs and dO, relative
    to each gradient's largest magnitude."""
    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn(B, S, H, D, device=dev, generator=g).to(dtype)
    k, v = (torch.randn(B, T, G, D, device=dev, generator=g).to(dtype) for _ in range(2))
    do = torch.randn(B, S, H, D, device=dev, generator=g).to(dtype)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = flash_attention.launches
    out = flash_attention_op(*leaves, **kw)
    assert flash_attention.launches == before + 1
    got = torch.autograd.grad(out, leaves, do)
    plain = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref = flash_attention_op_ref(*plain, **kw)
    want = torch.autograd.grad(ref, plain, do)
    _close(out.detach(), ref.detach(), dtype)
    tol = TOL[dtype]["atol"]
    for a, b in zip(got, want):
        assert a.dtype == dtype and torch.isfinite(a).all()
        assert _rel_to_scale(a, b) <= tol


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

    before = flash_attention.launches
    loss, got = grads()
    assert flash_attention.launches - before == 2 * cfg.n_layers   # forward + remat
    with mock.patch.object(attention, "flash_attention_op", flash_attention_op_ref):
        plain_loss, want = grads()
    assert torch.isfinite(loss)
    for a, b in zip(got, want):
        assert a is not None and torch.isfinite(a).all() and a.abs().max() > 0
        assert _rel_to_scale(a, b) <= TOL[dtype]["atol"]


def test_kernels_without_a_gradient_refuse_one_on_the_card(dev):
    """K2 and K4 (and K3 called outside FlashAttentionFn) raise where
    autograd would record their launch, and run under no_grad."""
    q = torch.randn(1, 1, 8, 64, device=dev, requires_grad=True)
    kv = torch.randn(1, 32, 2, 64, device=dev)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        decode_attention_op(q, kv, kv, 16)
    x = torch.randn(1, 64, 4, 32, device=dev, requires_grad=True)
    a = -torch.rand(1, 64, 4, device=dev)
    Bm = torch.randn(1, 64, 1, 16, device=dev)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ssd_chunk_op(x, a, Bm, Bm, 32)
    qh = torch.randn(1, 8, 64, 64, device=dev, requires_grad=True)
    kh = torch.randn(1, 2, 64, 64, device=dev)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        flash_attention(qh, kh, kh)
    with torch.no_grad():
        decode_attention_op(q, kv, kv, 16)
        ssd_chunk_op(x, a, Bm, Bm, 32)
        flash_attention(qh, kh, kh)



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
