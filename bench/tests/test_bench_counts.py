"""The metrics' operation and byte counts against values worked out by
hand at the cells' shapes: an OLMoE-1B-7B prefill of 3,232 tokens and a
Mamba2-370m one of the same length (12 chunks of 256 and one of 160)."""
import importlib.util
from pathlib import Path

import pytest

from benchkit import counts, peaks
from benchkit.record import Run
from benchkit.trace import Calls, Summary, span_name

METRICS = Path(__file__).resolve().parents[1] / "metrics"
S = 3232
# a layer's macs: q, k, v and o, the router, and top-8 of 64 SwiGLU experts
OLMOE = dict(n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, hd=128, d_ff=1024,
             vocab=50304, n_experts=64, top_k=8, ssm_state=0,
             plan=[dict(mixer="attn", channel="moe",
                        macs=2048 * 6144 + 2048 * 2048 + 2048 * 64 + 8 * 3 * 2048 * 1024)] * 16)
# z, x, B, C and dt in; the three depthwise convolutions; out
MAMBA2 = dict(n_layers=48, d_model=1024, n_heads=0, vocab=50280, n_experts=0, d_ff=0,
              ssm_state=128, ssm_head_dim=64, ssm_heads=32, ssm_d_inner=2048,
              ssm_groups=1, ssm_chunk=256, conv_width=4,
              plan=[dict(mixer="ssm", channel="none",
                         macs=1024 * 4384 + 4 * 2304 + 2048 * 1024)] * 48)


def metric(name):
    spec = importlib.util.spec_from_file_location(name, METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_olmoe_counts():
    # router 2*3232*2048*64 + eight SwiGLU experts a token 2*3232*8*3*2048*1024
    assert counts.moe_flops(S, OLMOE) == 326_191_022_080
    # every expert's three matrices in bf16, the fp32 router, x in and y out
    assert counts.moe_bytes(S, OLMOE) == 832_307_200
    # 16 heads of 128 over 3232*3233/2 kept pairs, 4 operations a pair and dim
    assert counts.attention_flops(1, 16, S, S, 128) == 42_799_333_376
    # 7.64 TFLOP: projections, attention and the active experts in 16 layers,
    # the head at the last position
    assert counts.prefill_flops(S, OLMOE) == 7_639_218_520_064


def test_mamba2_counts():
    assert counts.ssd_flops(1, S, 32, 64, 1, 128, 256) == 5_163_012_096
    # xbar bf16, a fp32, B and C bf16 in; y fp32 and the bf16 state out
    assert counts.ssd_bytes(1, S, 32, 64, 1, 128) == 42_307_584
    assert counts.prefill_flops(S, MAMBA2) == 2_294_352_592_896


def test_rooflines_from_calls_and_device_time():
    run = Run(sizes={**OLMOE, "ssm_chunk": 256}, seconds=1.0)
    run.summary = Summary()
    run.calls = Calls()
    k3 = "repro_torch.models.attention.flash_attention_op"
    run.calls.by_target[k3] = [(((1, S, 16, 128), "bfloat16"), ((1, S, 16, 128), "bfloat16"),
                                ((1, S, 16, 128), "bfloat16"))] * 16
    least = 16 * max(42_799_333_376 / 989e12, 52_953_088 / 3.35e12)
    run.summary.span_device_s[span_name(k3)] = 2 * least
    assert metric("k3.roofline").read(run) == pytest.approx(50.0)
    moe = "repro_torch.models.transformer.moe_ffn"
    run.calls.by_target[moe] = [(None, ((1, S, 2048), "bfloat16"), None)]
    run.summary.span_device_s[span_name(moe)] = 4 * peaks.least_seconds(
        326_191_022_080, 832_307_200)
    assert metric("moe.roofline").read(run) == pytest.approx(25.0)
    k1 = "repro_torch.core.torch_backend.relay_assemble"
    run.calls.by_target[k1] = [(((820, 2621440), "bfloat16"), ((820,), "int32"))]
    run.summary.span_device_s[span_name(k1)] = 2 * 2 * 820 * 2621440 * 2 / 3.35e12
    assert metric("k1.roofline").read(run) == pytest.approx(50.0)
    run.summary.span_device_s.clear()                  # nothing launched: no reading
    assert metric("k3.roofline").read(run) is None


def test_idle_share_and_mfu():
    run = Run(sizes=OLMOE, seconds=2.0)
    run.summary = Summary()
    run.summary.window_s, run.summary.busy_s, run.summary.n_device_events = 2.0, 0.5, 10
    assert metric("idle_share.prefill").read(run) == pytest.approx(75.0)
    run.summary.n_device_events = 0
    assert metric("idle_share.prefill").read(run) is None
