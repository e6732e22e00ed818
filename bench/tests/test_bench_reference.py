"""The plain references against the port's prefill on the same weights:
the configurations cut to a CPU size (``tiny``), in fp32, where the two
differ only in summation order."""
import dataclasses
import importlib
import json
from pathlib import Path

import pytest
import torch

import run as bench_run
import tiny
from benchkit import weights

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


@pytest.mark.parametrize("name", ["olmoe-1b-7b", "mamba2-370m"])
@pytest.mark.parametrize("S", [40, 77])
def test_reference_matches_the_port_prefill(name, S):
    from repro_torch.models import prefill

    conf = json.loads((CONFIGS / f"{name}.json").read_text())
    cfg = bench_run.port_config(conf)
    small = (tiny.ssm if name.startswith("mamba2") else tiny.moe)(cfg)
    small = dataclasses.replace(small, dtype=torch.float32)
    tree = weights.make(small, 123, 0.02, "cpu")
    toks = torch.randint(0, small.vocab, (S,), generator=torch.Generator().manual_seed(S))
    with torch.no_grad():
        port = prefill(tree, toks[None], small, max_len=128)[0][0]
        ref = importlib.import_module(f"reference.{conf['reference']}").last_logits(
            tree, toks, bench_run.sizes_of(small))
    err = (port.float() - ref).abs().max() / ref.abs().max()
    assert err < 1e-4, err
    assert int(port.argmax()) == int(ref.argmax())


def test_fp8_control_moves_the_logits_far_more_than_bf16():
    """The control's rounding is the coarser one: on the same weights its
    logits lie further from the fp32 reference than a bf16 copy's."""
    from reference import olmoe
    from reference.plain import fp8

    conf = json.loads((CONFIGS / "olmoe-1b-7b.json").read_text())
    small = dataclasses.replace(tiny.moe(bench_run.port_config(conf)), dtype=torch.float32)
    tree = weights.make(small, 5, 0.02, "cpu")
    toks = torch.randint(0, small.vocab, (60,), generator=torch.Generator().manual_seed(1))
    z = bench_run.sizes_of(small)
    ref = olmoe.last_logits(tree, toks, z)
    low = olmoe.last_logits(tree, toks, z, fp8_control=True)
    t = torch.linspace(-3, 3, 1001)
    assert (fp8(t, None) - t).abs().max() > 8 * (t.bfloat16().float() - t).abs().max()
    assert (low - ref).abs().max() > 1e-3 * ref.abs().max()
