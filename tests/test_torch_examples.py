"""The port's examples (``python -m repro_torch.examples.<name>``) in
subprocesses on the CPU, with JAX and the JAX package blocked, asserting
what tests/test_examples.py asserts of the JAX package's (they are
user-facing API surface; breaking them is a release blocker)."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytestmark = pytest.mark.slow       # full tier, as tests/test_examples.py

ROOT = Path(__file__).resolve().parents[1]
RUN = ("import runpy, sys\n"
       "sys.modules['jax'] = None\n"
       "sys.modules['repro'] = None\n"
       "name, sys.argv = sys.argv[1], sys.argv[1:]\n"
       "runpy.run_module('repro_torch.examples.' + name, run_name='__main__')\n")


def run_example(name: str, *args: str, timeout: int = 300) -> str:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run(
        [sys.executable, "-c", RUN, name, *args, "--device", "cpu"],
        env=env, capture_output=True, text=True, cwd=ROOT, timeout=timeout,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout


def test_quickstart():
    out = run_example("quickstart")
    assert "bit-exact: True" in out
    assert "downstream released exactly at multipath completion" in out


def test_kv_fetch_serving():
    out = run_example("kv_fetch_serving")
    assert "prefix hit" in out
    # the repeated prompt must actually hit
    assert any(
        "prefix hit" in l and " 0 tokens" not in l
        for l in out.splitlines() if l.startswith("req")
    )


def test_model_switching():
    out = run_example("model_switching")
    assert "bit-exact after round-trip: True" in out


def test_train_small_short():
    out = run_example("train_small", "--steps", "12", "--batch", "4",
                      "--seq", "64")
    assert "improved" in out
