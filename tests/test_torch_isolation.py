"""The port stands alone: repro_torch and chip_smoke.py import neither JAX
nor the JAX package, and the entry points run on the card unless the
caller asks for the CPU."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def test_port_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch, repro_torch.core, repro_torch.models\n"
        "import repro_torch.serving, repro_torch.kernels, repro_torch.configs\n"
        "import repro_torch.training, repro_torch.workloads\n"
        "import repro_torch.distributed, repro_torch.launch\n"
        "import repro_torch.models.moe_ep\n"
        "import repro_torch.launch.serve, repro_torch.launch.specs\n"
        "import repro_torch.launch.train, repro_torch.launch.roofline\n"
        "import repro_torch.launch.dryrun, repro_torch.examples\n"
        "import repro_torch.examples.quickstart, repro_torch.examples.kv_fetch_serving\n"
        "import repro_torch.examples.model_switching, repro_torch.examples.train_small\n"
        "import torch.distributed as dist\n"
        "assert not dist.is_initialized()   # importing starts no world\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.'))\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
        "print('ISOLATED')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "ISOLATED" in out.stdout


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_package_import(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level:          # relative: inside repro_torch
                continue
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{path}: imports {name}"


def test_entry_points_need_a_card_unless_asked_for_cpu(monkeypatch):
    from repro_torch.configs import get_config
    from repro_torch.core import make_functional_engine, multipath_device_put
    from repro_torch.device import resolve_device
    from repro_torch.models import init_params
    from repro_torch.serving import FunctionalServer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("tinyllama-1.1b").reduced()
    for call in (
        lambda: resolve_device(None),
        lambda: resolve_device("cuda"),
        lambda: make_functional_engine(),
        lambda: multipath_device_put(torch.zeros(4)),
        lambda: init_params(cfg),
        lambda: FunctionalServer(cfg),
    ):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    import repro_torch.launch.serve as serve
    import repro_torch.launch.train as train

    for call in (
        lambda: serve.main(["--requests", "1"]),
        lambda: train.main(["--steps", "1"]),
        lambda: serve.run(cfg, device="cuda"),
    ):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    # asked for the CPU, they run there
    assert resolve_device("cpu") == torch.device("cpu")
    eng = make_functional_engine(devices=[torch.device("cpu")])
    assert multipath_device_put(torch.arange(4), engine=eng).device.type == "cpu"
    srv = FunctionalServer(cfg, device="cpu", max_len=16)
    assert srv.params["embedding"].device.type == "cpu"


@pytest.mark.parametrize("example", ["quickstart", "kv_fetch_serving", "model_switching",
                                     "train_small"])
def test_examples_need_a_card_unless_asked_for_cpu(example):
    out = subprocess.run([sys.executable, "-m", f"repro_torch.examples.{example}"],
                         env=_env(), capture_output=True, text=True, cwd=ROOT, timeout=120)
    assert out.returncode != 0
    assert "no CUDA device available; pass device='cpu'" in out.stderr


def test_chip_smoke_fails_without_a_card(tmp_path):
    for where in (ROOT, tmp_path):
        script = where / "chip_smoke.py"
        if where is tmp_path:      # the script alone, without the program
            script.write_text((ROOT / "chip_smoke.py").read_text())
        out = subprocess.run([sys.executable, str(script)], env=_env(),
                             capture_output=True, text=True, cwd=where,
                             timeout=120)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout


def _top_level_names(path: Path):
    """(public names a module defines, every name it binds by import)."""
    defined, imported = set(), set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            defined.add(node.name)
        elif isinstance(node, ast.Assign):
            defined |= {t.id for t in node.targets if isinstance(t, ast.Name)}
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            defined.add(node.target.id)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            imported |= {(a.asname or a.name).split(".")[0] for a in node.names}
    return {n for n in defined if not n.startswith("_")}, imported


# The JAX data plane, which core/torch_backend.py replaces
JAX_DATA_PLANE = {"core/jax_backend.py"}


def test_every_public_name_of_the_jax_package_has_a_counterpart():
    """Each top-level public name that a module of src/repro defines (a
    function, class or constant) is bound in the port's module of the same
    path, by definition or import; only the JAX data plane has no
    counterpart module."""
    jax_root = ROOT / "src" / "repro"
    missing = {}
    for jf in sorted(jax_root.rglob("*.py")):
        rel = jf.relative_to(jax_root).as_posix()
        tf = PORT / rel
        if rel in JAX_DATA_PLANE:
            assert not tf.exists()
            continue
        assert tf.exists(), rel
        want = _top_level_names(jf)[0]
        got = set.union(*_top_level_names(tf))
        if want - got:
            missing[rel] = sorted(want - got)
    assert missing == {}
