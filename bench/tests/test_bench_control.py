"""The control at each cell's own size, on the card: the plain reference
in fp8 put in the program's place must come out not correct, its widest
``logit_err`` over the cell's sample beyond the cell's limit. One seed a cell here;
``bench/calibrate.py`` reads it on three or more, beside the program's
dozen.

    python -m pytest -q -m cuda bench/tests/test_bench_control.py
"""
import pytest

import run as bench_run

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    bench_run.prepare_environment()


@pytest.mark.parametrize("cell, seconds", [("olmoe.prefix-docs", 6.0), ("olmoe.switch", 8.0)])
def test_control_is_not_correct(card, cell, seconds):
    limits = bench_run.read_json(bench_run.BENCH / "workloads" / f"{cell}.json")["limits"]
    res = bench_run.run_cell(cell, 3_100_000_019, seconds, False, "cuda:0", control=True)
    control = max(res["_readings"]["control_errs"])
    assert control > limits["logit_err"], (control, limits)
    assert res["_readings"]["sampled"] >= 8
