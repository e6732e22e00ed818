"""The weights' layout, the per-layer plan and the prefill counts taken
from the port's parameter tree and the configuration file.

``layout_counts.json`` holds what the harness gave before it took its
leaves from the port and counted layer by layer: ``layout`` at the
published sizes of the two configurations with cells, ``prefill_flops``
at three lengths, and a digest of each leaf of a tree made at a CPU size
(``tiny``). The harness must still give exactly those."""
import dataclasses
import hashlib
import json
from pathlib import Path

import pytest
import torch

import run as bench_run
import tiny
from benchkit import BenchError, counts, weights

HERE = Path(__file__).resolve().parent
RECORDED = json.loads((HERE / "layout_counts.json").read_text())
CONFIGS = HERE.parent / "configs"
CELL_CONFIGS = ["olmoe-1b-7b", "mamba2-370m"]
CROSS_INIT = {"wk_cross": ["normal", "initializer_range", 0.0],
              "wv_cross": ["normal", 0.01, 0.0]}


def published(name):
    conf = json.loads((CONFIGS / f"{name}.json").read_text())
    return conf, bench_run.port_config(conf)


def vision():
    """llama-3.2-vision-90b cut to a CPU size: four ``attn`` layers and a
    ``cross_attn`` one a period, whose ``wk_cross`` and ``wv_cross`` the
    table has no rule for."""
    from repro_torch.configs import get_config

    return get_config("llama-3.2-vision-90b").reduced()


@pytest.mark.parametrize("name", CELL_CONFIGS)
def test_layout_is_as_recorded(name):
    conf, cfg = published(name)
    got = [[k, list(shape), str(dtype).removeprefix("torch."), list(rule)]
           for k, (shape, dtype, rule) in
           weights.layout(cfg, float(conf["initializer_range"]), conf.get("init")).items()]
    assert got == RECORDED[name]["layout"]


@pytest.mark.parametrize("name", CELL_CONFIGS)
@pytest.mark.parametrize("S", [1, 300, 3328])
def test_prefill_flops_are_as_recorded(name, S):
    _, cfg = published(name)
    assert counts.prefill_flops(S, bench_run.sizes_of(cfg)) == \
        RECORDED[name]["prefill_flops"][str(S)]


@pytest.mark.parametrize("name", CELL_CONFIGS)
def test_weights_are_the_recorded_bits(name):
    conf, cfg = published(name)
    small = tiny.for_cell(name)(cfg)
    seed, init_range = RECORDED[name]["tiny_seed"], float(conf["initializer_range"])
    tree = weights.make(small, seed, init_range, "cpu", conf.get("init"))
    digests = {k: hashlib.sha256(t.contiguous().view(-1).view(torch.uint8).numpy()
                                 .tobytes()).hexdigest()[:16]
               for k, t in weights.iter_leaves(tree)}
    assert digests == RECORDED[name]["tiny_digests"]
    assert list(tree) == ["blocks", "embedding", "ln_f", "head"]
    assert weights.same_bits(tree, small, seed, init_range, "cpu", init=conf.get("init")) == []


def test_prefill_flops_count_a_hybrid_layer_by_layer():
    """jamba-1.5-large cut to one period: one attention layer and seven
    Mamba layers, MoE channels at odd positions and MLPs at even ones.
    Counting attention, the SSM and the experts in every layer read 1.4x
    this."""
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config("jamba-1.5-large-398b"), n_layers=8)
    S, d, V, H, G, D = 3328, 8192, 65536, 64, 8, 128
    E, K, f = 16, 2, 24576
    di, h, p, n, g, w = 16384, 256, 64, 16, 1, 4
    attn = 2 * S * (d * (H * D + 2 * G * D) + H * D * d) + counts.attention_flops(1, H, S, S, D)
    ssm = (2 * S * (d * (2 * di + 2 * g * n + h) + w * (di + 2 * g * n) + di * d)
           + counts.ssd_flops(1, S, h, p, g, n, 256))
    moe = counts.moe_flops(S, dict(d_model=d, n_experts=E, top_k=K, d_ff=f))
    mlp = 2 * S * 3 * d * f
    want = attn + 7 * ssm + 4 * moe + 4 * mlp + 2 * d * V
    assert counts.prefill_flops(S, bench_run.sizes_of(cfg)) == want


@pytest.mark.parametrize("S,W", [(10, 4), (4, 10), (7, 7), (300, 64)])
def test_window_pairs(S, W):
    assert counts.window_pairs(S, W) == sum(min(i + 1, W) for i in range(S))
    z = dict(d_model=8, vocab=16, n_heads=2, hd=4, attn_window=W,
             plan=[dict(mixer="attn", channel="none", macs=0)])
    assert counts.prefill_flops(S, z) == 2 * 8 * 16 + 4 * 2 * 4 * counts.window_pairs(S, W)


@pytest.mark.parametrize("name,layers", [("olmoe-1b-7b", 16), ("mamba2-370m", 48)])
def test_sizes_carry_the_plan_and_every_field(name, layers):
    _, cfg = published(name)
    z = bench_run.sizes_of(cfg)
    assert len(z["plan"]) == cfg.n_layers == layers
    assert [(x["mixer"], x["channel"]) for x in z["plan"]] == \
        list(cfg.layer_plan() * cfg.n_periods)
    assert z["dtype"] == "bfloat16"
    for field in ("attn_window", "qkv_bias", "tie_embeddings", "mlp", "moe_every"):
        assert z[field] == getattr(cfg, field)


def test_sizes_plan_of_a_cross_attention_model():
    cfg = vision()
    z = bench_run.sizes_of(cfg)
    assert len(z["plan"]) == cfg.n_layers
    cross = [x for x in z["plan"] if x["mixer"] == "cross_attn"]
    d, H, G, D, f = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_ff
    assert len(cross) == cfg.n_layers // 5
    assert cross[0]["macs"] == 2 * d * H * D + 2 * d * G * D + 3 * d * f
    assert z["cross_attn_every"] == 5 and z["dtype"] == "float32"


def test_init_rules_make_the_leaves_the_table_lacks():
    cfg = vision()
    with pytest.raises(BenchError, match=r"blocks\.4\.wk_cross"):
        weights.layout(cfg, 0.02)
    spec = weights.layout(cfg, 0.02, CROSS_INIT)
    port = weights.port_leaves(cfg)
    assert list(spec) == list(port)
    assert all(spec[k][:2] == port[k] for k in port)
    assert spec["blocks.4.wk_cross"][2] == ("normal", 0.02, 0.0)
    assert spec["blocks.4.wv_cross"][2] == ("normal", 0.01, 0.0)
    assert spec["blocks.4.wq"][2] == spec["blocks.0.wq"][2] == ("normal", 0.02, 0.0)
    assert spec["blocks.4.w_gate"][2] == ("normal", 0.02, 0.0)
    tree = weights.make(cfg, 7, 0.02, "cpu", CROSS_INIT)
    assert float(tree["blocks"][4]["wv_cross"].std()) == pytest.approx(0.01, rel=0.05)
    assert weights.same_bits(tree, cfg, 7, 0.02, "cpu", init=CROSS_INIT) == []
    assert weights.same_bits(tree, cfg, 8, 0.02, "cpu", init=CROSS_INIT) != []


@pytest.mark.parametrize("init,leaf", [
    ({"wk_cross": ["normal", 0.02, 0.0]}, "wv_cross"),                 # one left without
    ({**CROSS_INIT, "w_shared": ["normal", 0.02, 0.0]}, "w_shared"),   # no such leaf
    ({**CROSS_INIT, "wq": ["normal", 0.01, 0.0]}, "wq"),               # the table rules it
    ({**CROSS_INIT, "wk_cross": ["gamma", 1.0, 1.0]}, "wk_cross"),     # no such kind
    ({**CROSS_INIT, "wv_cross": ["normal", 0.02]}, "wv_cross"),        # not [kind, a, b]
])
def test_a_missing_or_stray_rule_names_its_leaf(init, leaf):
    with pytest.raises(BenchError, match=leaf):
        weights.layout(vision(), 0.02, init)


@pytest.mark.parametrize("change", ["dtype", "shape", "missing"])
def test_a_table_leaf_unlike_the_port_names_its_leaf(monkeypatch, change):
    _, cfg = published("olmoe-1b-7b")
    real = weights.port_leaves(cfg)

    def port(_cfg):
        out = dict(real)
        shape, dtype = out["blocks.0.router"]
        if change == "dtype":
            out["blocks.0.router"] = (shape, torch.bfloat16)
        elif change == "shape":
            out["blocks.0.router"] = (shape[:-1] + (shape[-1] + 1,), dtype)
        else:
            del out["blocks.0.router"]
        return out

    monkeypatch.setattr(weights, "port_leaves", port)
    with pytest.raises(BenchError, match=r"blocks\.0\.router"):
        weights.layout(cfg, 0.02)
