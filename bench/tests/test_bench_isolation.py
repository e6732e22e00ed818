"""The benchmark stands alone and refuses to measure the wrong thing: no
card, no result; no JAX or JAX package, compared by whole top-level
names; no program beside it, no result; the references import nothing of
the port."""
import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import run as bench_run

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
SOURCES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


def top_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and not node.level:
            names.add(node.module.split(".")[0])
    return names


def test_no_source_imports_jax_or_the_jax_package():
    for path in SOURCES:
        assert not top_imports(path) & bench_run.BANNED, path


def test_references_import_nothing_of_the_port():
    for path in (BENCH / "reference").glob("*.py"):
        assert not top_imports(path) & {"repro_torch", "benchkit", "jax", "repro"}, path


def test_banned_names_are_compared_whole():
    saved = dict(sys.modules)
    try:
        sys.modules["repro_torch_probe"] = sys
        sys.modules["jaxtyping_probe"] = sys
        assert bench_run.banned_modules() == []
        sys.modules["repro.core"] = sys
        assert bench_run.banned_modules() == ["repro"]
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def _run(args, cwd, env=None):
    e = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env or {}))
    return subprocess.run([sys.executable, *args], cwd=cwd, env=e, capture_output=True,
                          text=True, timeout=300)


def test_no_card_no_result():
    out = _run(["bench/run.py", "--workload", "olmoe.prefix-docs", "--seed", "1",
                "--seconds", "1", "--trace", "0"], ROOT)
    assert out.returncode != 0
    assert "{" not in out.stdout


def test_a_cpu_run_loads_no_jax():
    code = ("import sys; sys.path[:0] = ['bench', 'bench/tests']\n"
            "import run, tiny\n"
            "run.prepare_environment()\n"
            "r = run.run_cell('olmoe.prefix-docs', 7, 1.0, False, 'cpu',\n"
            "                 cfg_override=tiny.moe, mix_override=tiny.MIX)\n"
            "print(run.banned_modules())\n")
    out = _run(["-c", code], ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_without_the_program_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "bench", ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; sys.path[:0] = ['bench', 'bench/tests']\n"
            "import run, tiny\n"
            "run.prepare_environment()\n"
            "run.emit(run.run_cell('olmoe.prefix-docs', 7, 1.0, False, 'cpu',\n"
            "                      cfg_override=tiny.moe, mix_override=tiny.MIX))\n")
    out = _run(["-c", code], tmp_path, env={"PYTHONPATH": ""})
    assert out.returncode != 0
    assert not any(line.startswith("{") for line in out.stdout.splitlines())


def test_benchmark_json_names_files_that_exist():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file()
    for w in bench["workloads"]:
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        assert (BENCH / "workloads" / f"{w['name']}.json").is_file()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
