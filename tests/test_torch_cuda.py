"""The port on an sm_90 card: the CUDA kernels against their plain
versions, the data plane bit-exact through real CUDA copies, and a reduced
model on the card against the same model on the CPU.

Every test here needs the card (marker ``cuda``) and skips elsewhere; the
file imports neither JAX nor the JAX package, so it runs on a machine
that has only PyTorch:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: bf16 2e-2 (one bf16 ulp of the output), fp32 1e-4 with TF32
off (another summation order), bit-exact for copies.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config
from repro_torch.core import MMAConfig, make_functional_engine, \
    multipath_device_get, multipath_device_put
from repro_torch.kernels import (
    decode_attention,
    decode_attention_ref,
    flash_attention,
    flash_attention_ref,
    relay_assemble,
    relay_assemble_ref,
)
from repro_torch.models import decode_step, init_params, prefill
from repro_torch.tree import tree_map

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
@pytest.mark.parametrize("S,window,D", [(64, 0, 64), (96, 16, 32), (200, 0, 128)])
def test_flash_matches_plain(dev, dtype, S, window, D):
    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn(2, 8, S, D, device=dev, generator=g).to(dtype)
    k = torch.randn(2, 2, S, D, device=dev, generator=g).to(dtype)
    v = torch.randn(2, 2, S, D, device=dev, generator=g).to(dtype)
    n = flash_attention.launches
    out = flash_attention(q, k, v, window=window)
    assert flash_attention.launches == n + 1
    _close(out, flash_attention_ref(q, k, v, window=window), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kv", [1, 37, 300])
def test_decode_matches_plain(dev, dtype, kv):
    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn(2, 32, 64, device=dev, generator=g).to(dtype)
    k = torch.randn(2, 4, 300, 64, device=dev, generator=g).to(dtype)
    v = torch.randn(2, 4, 300, 64, device=dev, generator=g).to(dtype)
    lens = torch.tensor([kv, max(1, kv // 2)], dtype=torch.int32, device=dev)
    n = decode_attention.launches
    out = decode_attention(q, k, v, lens)
    assert decode_attention.launches == n + 1
    _close(out, decode_attention_ref(q, k, v, lens), dtype)


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
