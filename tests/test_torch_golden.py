"""The port's copies of the simulator, the kvstore, the serving control
plane and the workloads reproduce every digest of ``tests/GOLDEN_sim.json``.

The JAX package's digest captures (``tests/golden_equivalence.py`` and the
``benchmarks`` modules it calls) import ``repro``, which pulls in JAX.
Here each digest is computed in a subprocess where ``jax`` and ``repro``
are blocked: an import hook loads ``golden_equivalence`` and the
``benchmarks`` modules from their source text with every ``repro.``
import renamed to ``repro_torch.``, the one change the port's copies make
(``tests/test_torch_core.py::_imports_renamed``). So the same capture
logic runs on the port's modules alone, and no object of the reference
can leak into the digest.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = json.loads((ROOT / "tests" / "GOLDEN_sim.json").read_text())["digests"]
FAST = ["qos", "slo.fast", "tenant.fast", "disagg.fast", "kvdisk"]
FULL = ["slo.full", "tenant.full", "disagg.full"]

CAPTURE = r'''
import importlib.abc
import importlib.util
import sys
from pathlib import Path

sys.modules["jax"] = None
sys.modules["repro"] = None
ROOT = Path(sys.argv[1])


def renamed(text):
    out = []
    for line in text.splitlines(keepends=True):
        if line.lstrip().startswith(("from repro.", "import repro.",
                                     "from repro ", "import repro ")):
            line = line.replace("repro", "repro_torch", 1)
        out.append(line)
    return "".join(out)


class Renamed(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    """golden_equivalence and benchmarks.* from source, imports renamed."""

    def find_spec(self, name, path=None, target=None):
        if name == "golden_equivalence":
            file = ROOT / "tests" / "golden_equivalence.py"
        elif name == "benchmarks":
            file = ROOT / "benchmarks" / "__init__.py"
        elif name.startswith("benchmarks."):
            file = ROOT / "benchmarks" / (name.split(".", 1)[1] + ".py")
        else:
            return None
        return importlib.util.spec_from_loader(
            name, self, origin=str(file), is_package=name == "benchmarks")

    def exec_module(self, module):
        file = Path(module.__spec__.origin)
        text = renamed(file.read_text()) if file.is_file() else ""
        module.__file__ = str(file)
        exec(compile(text, str(file), "exec"), module.__dict__)


sys.meta_path.insert(0, Renamed())
sys.path.insert(0, str(ROOT / "src"))
import golden_equivalence as ge

name = sys.argv[2]
digest = ge.digest(ge.capture(name))
leaked = sorted(m for m, mod in sys.modules.items() if mod is not None
                and (m.split(".")[0] in ("jax", "jaxlib", "repro")))
assert not leaked, leaked
assert "repro_torch.core" in sys.modules
print("DIGEST", digest)
'''


def _port_digest(name: str) -> str:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run([sys.executable, "-c", CAPTURE, str(ROOT), name],
                         env=env, capture_output=True, text=True, cwd=ROOT,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return out.stdout.split("DIGEST ")[-1].strip()


def test_every_digest_is_driven():
    assert sorted(FAST + FULL) == sorted(GOLDEN)


@pytest.mark.parametrize("name", FAST)
def test_port_reproduces_golden_fast(name):
    assert _port_digest(name) == GOLDEN[name]


@pytest.mark.slow
@pytest.mark.parametrize("name", FULL)
def test_port_reproduces_golden_full(name):
    assert _port_digest(name) == GOLDEN[name]
