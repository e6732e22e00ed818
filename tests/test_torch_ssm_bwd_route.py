"""K4b's two routes on the CPU: the route rule (``ssd_chunk.bwd_route``) as
a function of dtype and shape and of the configured models, a forced route
that cannot take a call raising before anything is launched, the CPU and
meta running the plain version whatever the route, the route counters, the
launcher taking only a route the caller names, and a plain
emulation of the tensor-core kernel's arithmetic (``ssd_chunk_bwd_tc_
emulated``: bf16 operands, register-built M, dS and dstates in bf16 parts,
fp32 sums) against the fp32 closed form and against ``jax.vjp`` of the JAX
package's K4 oracle.

Inputs are made with numpy from a seed. Tolerances, of each gradient's
largest magnitude: the parts the kernel uses keep the emulation within
1e-4 of the closed form on the same bf16-rounded inputs and of JAX, where
one part misses both; 2e-2 is the card's bf16 gate. tests/test_torch_cuda.py
holds the kernel itself to the plain version on the card.
"""
import dataclasses
import re
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.ssd_chunk.ref import ssd_chunk_ref as jax_ssd_chunk_ref
from repro_torch.configs import get_config
from repro_torch.kernels import build, ssd_chunk, ssd_chunk_bwd, ssd_chunk_op_bwd, \
    ssd_chunk_op_bwd_ref
from repro_torch.kernels.ssd_chunk.ref import ssd_chunk_bwd_f32, ssd_chunk_bwd_tc_emulated
from repro_torch.kernels.ssd_chunk.ssd_chunk import BWD_TC_PARTS, bwd_route, launch_bwd

TOL = 2e-2               # of each gradient's largest magnitude (bf16)
PARTS_TOL = 1e-4         # what the kernel's parts leave; one part misses it
CSRC = Path(build.__file__).resolve().parents[1] / "csrc" / "ssd_chunk_bwd.cu"


@pytest.mark.parametrize("dtype,Q,P,N,want", [
    (torch.bfloat16, 256, 64, 128, "tensor_cores"),   # Mamba2-370m
    (torch.bfloat16, 256, 64, 16, "tensor_cores"),    # jamba's N = 16
    (torch.bfloat16, 128, 32, 256, "tensor_cores"),   # the widest N
    (torch.bfloat16, 1024, 128, 128, "tensor_cores"),
    (torch.float32, 256, 64, 128, "cuda_cores"),      # fp32 keeps its 1e-4 on the CUDA cores
    (torch.bfloat16, 32, 32, 16, "cuda_cores"),       # the reduced models' chunk
    (torch.bfloat16, 50, 20, 12, "cuda_cores"),
    (torch.bfloat16, 2048, 64, 128, "cuda_cores"),    # past 16 row tiles
    (torch.bfloat16, 256, 8, 128, "cuda_cores"),      # P under 16
    (torch.bfloat16, 256, 64, 8, "cuda_cores"),       # N under 16
])
def test_bwd_route_by_dtype_and_shape(dtype, Q, P, N, want):
    assert bwd_route(dtype, Q, P, N) == want


@pytest.mark.parametrize("name,launcher,want", [
    ("mamba2-370m", False, "tensor_cores"),           # the bf16 train shape
    ("mamba2-370m", True, "cuda_cores"),              # launch.train: fp32
    ("jamba-1.5-large-398b", False, "tensor_cores"),  # N = 16
])
def test_bwd_route_of_the_configured_models(name, launcher, want):
    """The route each configured SSM model's gradient takes at full width:
    the training loop keeps the config's bf16; ``launch.train`` trains in
    fp32. Their reduced widths (chunk 32) take the CUDA cores."""
    cfg = get_config(name)
    if launcher:
        cfg = dataclasses.replace(cfg, dtype=torch.float32)
    assert bwd_route(cfg.dtype, cfg.ssm_chunk, cfg.ssm_head_dim, cfg.ssm_state) == want
    small = cfg.reduced()
    assert bwd_route(small.dtype, small.ssm_chunk, small.ssm_head_dim,
                     small.ssm_state) == "cuda_cores"


def _inputs(b, l, h, g, p, n, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x, dy = (torch.from_numpy(rng.standard_normal((b, l, h, p)).astype(np.float32)).to(dtype)
             for _ in range(2))
    a = -torch.from_numpy(rng.random((b, l, h)).astype(np.float32))
    B, C = (torch.from_numpy(rng.standard_normal((b, l, g, n)).astype(np.float32)).to(dtype)
            for _ in range(2))
    return x, a, B, C, dy


@pytest.mark.parametrize("dtype,chunk,which", [
    (torch.float32, 256, "tensor_cores"),
    (torch.bfloat16, 32, "tensor_cores"),
    (torch.bfloat16, 256, "wgmma"),                   # no such route
])
def test_forcing_a_route_that_cannot_take_the_call_raises(dtype, chunk, which):
    """``bwd_route`` and ``launch_bwd`` raise ValueError before anything is
    launched (the library is never loaded)."""
    with pytest.raises(ValueError):
        bwd_route(dtype, chunk, 64, 128, which)
    x, a, B, C, dy = _inputs(1, 256, 2, 1, 64, 128, dtype)
    nc = -(-256 // chunk)
    before = ssd_chunk_bwd.launches
    with mock.patch.object(build, "library", side_effect=AssertionError("launched")), \
            pytest.raises(ValueError):
        launch_bwd(x, a, B, C, dy, torch.zeros(1, 2, nc, 64, 128), torch.zeros(1, 2, nc, chunk),
                   torch.empty_like(x), torch.empty_like(a), torch.empty_like(B),
                   torch.empty_like(C), (1, 2, 1, 256, chunk, 64, 128), (0,) * 27, which)
    assert ssd_chunk_bwd.launches == before


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("which", [None, "cuda_cores", "tensor_cores"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_chunk_op_bwd_runs_the_plain_version_whatever_the_route(device, which, dtype):
    """On the CPU (bit for bit) and on meta (shapes and dtypes) K4b's
    wrapper is ``ssd_chunk_op_bwd_ref`` for any route, even one the card
    would refuse; nothing is launched and no route is counted. Both run
    on one CPU thread: MKL may pick another thread count for a product
    on a loaded machine, and with it another summation order."""
    x, a, B, C, dy = _inputs(2, 300, 4, 2, 64, 128, dtype, seed=1)
    nc = 2
    rng = np.random.default_rng(2)
    dst = torch.from_numpy(rng.standard_normal((2, 4, nc, 64, 128)).astype(np.float32))
    dde = torch.from_numpy(rng.standard_normal((2, 4, nc, 256)).astype(np.float32))
    args = [t.to(device) for t in (x, a, B, C)] + [256] + [t.to(device) for t in (dy, dst, dde)]
    before = dict(ssd_chunk_bwd.route_launches)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with mock.patch.object(build, "library", side_effect=AssertionError("launched")):
            got = ssd_chunk_op_bwd(*args, which=which)
        want = ssd_chunk_op_bwd_ref(*args)
    finally:
        torch.set_num_threads(threads)
    assert ssd_chunk_bwd.route_launches == before
    for g, w in zip(got, want):
        assert g.device.type == device and g.dtype == w.dtype and g.shape == w.shape
        if device == "cpu":
            assert torch.equal(g, w)


def test_k4b_route_counts_reset_with_the_launch_counts():
    from repro_torch.kernels import launch_counts, reset_launch_counts, route_counts

    ssd_chunk_bwd.launches += 2
    ssd_chunk_bwd.route_launches["tensor_cores"] += 2
    ssd_chunk.route_launches["cuda_cores"] += 1
    reset_launch_counts()
    assert launch_counts()["ssd_chunk_bwd"] == 0
    assert route_counts() == {f"{k}:{r}": 0 for k in ("ssd_chunk", "ssd_chunk_bwd")
                              for r in ("cuda_cores", "tensor_cores")}


@pytest.mark.parametrize("dtype,Q", [(torch.bfloat16, 256), (torch.float32, 128)])
def test_launch_bwd_takes_only_a_named_route(dtype, Q):
    """``launch_bwd`` does not choose a route: its caller
    (``ssd_chunk_op_bwd``) has, so a missing one raises ValueError before
    the library is loaded, and nothing is counted."""
    which = None
    x, a, B, C, dy = _inputs(1, 256, 2, 1, 64, 128, dtype)
    nc = -(-256 // Q)
    before = dict(ssd_chunk_bwd.route_launches)
    with mock.patch.object(build, "library", side_effect=AssertionError("launched")), \
            pytest.raises(ValueError, match="unknown route"):
        launch_bwd(x, a, B, C, dy, torch.zeros(1, 2, nc, 64, 128), torch.zeros(1, 2, nc, Q),
                   torch.empty_like(x), torch.empty_like(a), torch.empty_like(B),
                   torch.empty_like(C), (1, 2, 1, 256, Q, 64, 128), (0,) * 27, which)
    assert ssd_chunk_bwd.route_launches == before


def test_the_parts_mirror_the_kernel():
    """``BWD_TC_PARTS`` is the kernel's kPartsM, kPartsDS and kPartsST."""
    src = CSRC.read_text()
    got = tuple(int(re.search(rf"constexpr int {k} = (\d+);", src).group(1))
                for k in ("kPartsM", "kPartsDS", "kPartsST"))
    assert got == BWD_TC_PARTS


def _fused(BH, nc, Q, P, N, decay, ragged, seed):
    """Fused-layout inputs and cotangents, bf16-representable; ``slow``
    decays reach every key of the chunk; ``ragged`` zeroes the last chunk's
    tail (a, x, B, C, dy), as the kernel reads positions past L."""
    rng = np.random.default_rng(seed)
    scale = 0.5 if decay == "fast" else 0.01
    a = -rng.random((BH, nc, Q)) * scale
    x, dy = (rng.standard_normal((BH, nc, Q, P)) for _ in range(2))
    B, C = (rng.standard_normal((BH, nc, Q, N)) * 0.3 for _ in range(2))
    dst, dde = rng.standard_normal((BH, nc, P, N)), rng.standard_normal((BH, nc, Q))
    if ragged:
        for t in (a, x, B, C, dy):
            t[:, -1, Q - Q // 3:] = 0
    ins = [torch.from_numpy(t.astype(np.float32)) for t in (x, a, B, C, dy, dst, dde)]
    for k in (0, 2, 3, 4):                         # x, B, C, dy: the kernel's bf16 operands
        ins[k] = ins[k].bfloat16().float()
    return ins


def _errs(got, want):
    return [((g - w).abs().max() / w.abs().max()).item() for g, w in zip(got, want)]


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("decay", ["fast", "slow"])
def test_the_emulated_tensor_core_arithmetic_holds_the_tolerance(decay, ragged):
    """The kernel's parts keep every gradient within 1e-4 of the fp32
    closed form's max (so within the card's 2e-2 with room for the bf16
    outputs' own rounding), fast and slow decays, a ragged last chunk."""
    ins = _fused(4, 2, 64, 16, 32, decay, ragged, seed=3)
    errs = _errs(ssd_chunk_bwd_tc_emulated(*ins, parts=BWD_TC_PARTS), ssd_chunk_bwd_f32(*ins))
    assert max(errs) <= PARTS_TOL, errs


@pytest.mark.parametrize("decay", ["fast", "slow"])
def test_one_bf16_part_errs_as_much_as_a_bf16_rounding(decay):
    """With one bf16 part for M, dS and dstates the products carry a bf16
    rounding of their operands: dx, dB and dC miss the closed form by the
    order of bf16's own half-ulp (2^-9 of a value), over 100x what the
    kernel's parts leave, though still inside 2e-2; da (from G and the
    cumsums, fp32 on both) barely moves."""
    ins = _fused(4, 2, 64, 16, 32, decay, False, seed=4)
    want = ssd_chunk_bwd_f32(*ins)
    one = _errs(ssd_chunk_bwd_tc_emulated(*ins, parts=(1, 1, 1)), want)
    built = _errs(ssd_chunk_bwd_tc_emulated(*ins, parts=BWD_TC_PARTS), want)
    for k in (0, 2, 3):                            # dx, dB, dC
        assert 2 ** -11 < one[k] <= TOL and one[k] > 100 * built[k], (one, built)


@pytest.mark.parametrize("decay", ["fast", "slow"])
def test_the_emulated_tensor_core_gradient_matches_jax_vjp(decay):
    """The emulation against ``jax.vjp`` of the JAX package's K4 oracle
    (vmapped over BH, fp32) on the same bf16-representable inputs and
    cotangents: with the kernel's parts within 1e-4 of each gradient's
    max (about 6e-6 is what they leave), where one part misses dx, dB and
    dC by 9e-4 to 3e-3."""
    ins = _fused(3, 2, 64, 32, 16, decay, False, seed=5)
    _, vjp = jax.vjp(jax.vmap(jax_ssd_chunk_ref), *(jnp.asarray(t.numpy()) for t in ins[:4]))
    want = [np.asarray(w, np.float64) for w in
            vjp(tuple(jnp.asarray(t.numpy()) for t in ins[4:]))]

    def errs(parts):
        got = ssd_chunk_bwd_tc_emulated(*ins, parts=parts)
        return [np.abs(g.numpy() - w).max() / np.abs(w).max() for g, w in zip(got, want)]

    built, one = errs(BWD_TC_PARTS), errs((1, 1, 1))
    assert max(built) <= PARTS_TOL, built
    assert min(one[k] for k in (0, 2, 3)) > PARTS_TOL, one   # dx, dB, dC
