#!/usr/bin/env python3
"""The port's benchmark: one run of one cell of ``BENCHMARK.json``.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds ``src/repro_torch``. A cell
names a configuration (``bench/configs/<config>.json``) and a traffic mix
(``bench/traffic/<mix>.json``, whose ``driver`` names
``bench/drivers/<driver>.py``); its correctness limits and sample size are
in ``bench/workloads/<cell>.json``; each metric is read by
``bench/metrics/<metric>.py``. A run makes the weights and the traffic
from ``--seed``, warms up the cell's shapes, measures for ``--seconds``
(under ``torch.profiler`` with ``--trace 1``), compares the served tokens
with the plain reference (``bench/reference/``), and prints one JSON line
last on standard output, the numbers compared last on standard error.

It needs CUDA cards (as many as the cell asks for) and exits non-zero
without them; it imports neither JAX nor the JAX package, and exits
non-zero if either is loaded once the window has closed.
"""
import time

T_START = time.monotonic()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

from benchkit import BenchError  # noqa: E402  (bench/, the script's directory, is on the path)

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "bench"
BANNED = frozenset({"jax", "jaxlib", "flax", "repro"})


def prepare_environment() -> None:
    """Caches inside the checkout, no JAX behind a library's back, one
    thread for the CPU's own math, and no ``MMA_*`` variable for any
    engine to read: the yardstick's engines take the configuration file's
    settings alone."""
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for key in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[key] = "1"                 # one process, few threads
    for key in [k for k in os.environ if k.startswith("MMA_")]:
        del os.environ[key]
    for p in (str(ROOT / "src"), str(BENCH)):
        if p not in sys.path:
            sys.path.insert(0, p)


def banned_modules() -> list:
    """Top-level names of loaded modules that are JAX or the JAX package,
    compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({name.split(".")[0] for name, mod in list(sys.modules.items())
                   if mod is not None} & BANNED)


def load_file(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise BenchError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def find_cell(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise BenchError(f"no workload {name!r} in BENCHMARK.json")


def cell_metrics(bench: dict, cell: str, traced: bool) -> list:
    """This cell's end-to-end metrics (``--trace 0``) or per-layer ones."""
    kind = "per_layer" if traced else "end_to_end"
    if not traced:
        return [m for m in bench[kind] if cell in m.get("workloads", [cell])]
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    out = []
    for m in bench[kind]:
        cells = m.get("workloads")
        if cells is None:
            moves = e2e[m["moves"]]
            cells = moves.get("workloads", [cell])
        if cell in cells:
            out.append(m)
    return out


def port_config(conf: dict, override=None):
    """The port's ``ModelConfig`` for the file, held to the file's numbers
    (``port_fields``: file key -> port field)."""
    from repro_torch.configs import get_config

    cfg = get_config(conf["port_config"])
    wrong = {k: (conf[k], getattr(cfg, f)) for k, f in conf["port_fields"].items()
             if conf[k] != getattr(cfg, f)}
    wrong.update({k: (conf["assumed"][k], getattr(cfg, f))
                  for k, f in conf["assumed_port_fields"].items()
                  if conf["assumed"][k] != getattr(cfg, f)})
    if wrong:
        raise BenchError(f"{conf['name']}: the port runs other numbers than the file: {wrong}")
    return override(cfg) if override else cfg


def sizes_of(cfg) -> dict:
    """The port's ``ModelConfig`` as plain values, for the references and
    the metric readers: every field (``dtype`` by its name, such as
    ``bfloat16``), the sizes it derives (``hd``, ``ssm_heads``,
    ``ssm_d_inner``), and ``plan``, one entry per layer (``weights.plan``)."""
    from benchkit import weights

    out = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    out.update(dtype=str(cfg.dtype).removeprefix("torch."), hd=cfg.hd,
               ssm_heads=cfg.ssm_heads, ssm_d_inner=cfg.ssm_d_inner, plan=weights.plan(cfg))
    return out


@dataclasses.dataclass
class Ctx:
    seed: int
    conf: dict
    mix: dict
    cfg: object
    sizes: dict
    device: object
    init_range: float
    init: dict                   # the configuration file's own weight rules
    max_len: int


def run_cell(workload: str, seed: int, seconds: float, traced: bool, device,
             cfg_override=None, mix_override=None, limits_override=None,
             control: bool = False, bench=None) -> dict:
    """One run, without the look for a card: returns the result line's
    dict (with ``checks`` last) and, under ``_readings``, the numbers
    compared (and the control's, with ``control``). The overrides (a
    function of the port's config; dicts merged into the mix and the
    cell's limits file) are for tests at a size the CPU holds."""
    import torch

    torch.set_num_threads(1)
    from benchkit import check, weights
    from benchkit.record import Capture, Run
    from benchkit.trace import Window

    bench = bench or read_json(ROOT / "BENCHMARK.json")
    cell = find_cell(bench, workload)
    conf = read_json(BENCH / "configs" / f"{cell['config']}.json")
    mix = read_json(BENCH / "traffic" / f"{cell['traffic']}.json")
    mix.update(mix_override or {})
    limits = read_json(BENCH / "workloads" / f"{workload}.json")
    limits.update(limits_override or {})
    cfg = port_config(conf, cfg_override)
    device = torch.device(device)
    ctx = Ctx(seed=seed, conf=conf, mix=mix, cfg=cfg,
              sizes=sizes_of(cfg), device=device, init_range=float(conf["initializer_range"]),
              init=conf.get("init", {}), max_len=int(conf["max_len"]))
    metrics = [(m, load_file(BENCH / "metrics" / f"{m['name']}.py", f"metric_{i}"))
               for i, m in enumerate(cell_metrics(bench, workload, traced))]
    targets = sorted({t for _, mod in metrics for t in mod.WRAPS})

    driver = importlib.import_module(f"drivers.{mix['driver']}").Driver(ctx)
    driver.warm_up()
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    run = Run(sizes=ctx.sizes, seconds=float(seconds))
    win = Window(traced, targets, run.calls)
    capture = Capture()
    gc.collect()
    gc.freeze()                  # set-up's objects stay out of the window's collections
    with capture.patched():
        driver.window(run, win, traced, capture)
    gc.unfreeze()
    if cuda:
        torch.cuda.synchronize(device)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    run.setup_s = run.t0 - T_START
    found = banned_modules()
    if found:
        raise BenchError(f"JAX or the JAX package is loaded: {found}")
    run.summary = win.reduce()

    values = {}
    for m, mod in metrics:
        v = mod.read(run)
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}

    numbers = {k: float(v) for k, v in driver.checks().items()}
    sample = driver.sample(run, int(limits["sample"]))
    chosen = {id(r) for r in sample}
    for r in run.requests:
        if id(r) not in chosen:
            r.logits = None
    seeds = driver.instance_seeds
    driver.free()
    del driver
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ref = check.reference_gaps(
        ctx, sample,
        lambda inst: weights.make(cfg, seeds[inst], ctx.init_range, device, ctx.init),
        control=control)
    numbers["logit_gap"] = max(ref["gaps"]) if ref["gaps"] else float("inf")
    numbers["logit_err"] = max(ref["errs"]) if ref["errs"] else float("inf")
    lim = dict(limits["limits"])
    compared = {k: v for k, v in numbers.items() if k in lim}
    attempted = len(run.requests) + len(run.switches)
    failed = sum(r.failed for r in run.requests)
    correct = (failed == 0 and len(sample) >= int(limits["min_sample"])
               and check.verdict(compared, lim))
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": attempted, "failed": failed,
              "metrics": values, "device": dev}
    if traced and run.summary is not None:
        dev["busy_s"] = run.summary.busy_s
        dev["window_s"] = run.summary.window_s
        result["breakdown"] = run.summary.breakdown()
    result["checks"] = {k: {"value": v, "limit": lim[k]} for k, v in compared.items()}
    result["_readings"] = {"numbers": numbers, "gaps": ref["gaps"], "errs": ref["errs"],
                           "control_gaps": ref["control_gaps"],
                           "control_errs": ref["control_errs"],
                           "reference_s": ref["seconds"], "reduce_s": win.reduce_s,
                           "requests": len(run.requests), "switches": len(run.switches),
                           "sampled": len(sample)}
    return result


def _finite(x):
    """The result with every non-finite number as null (strict JSON)."""
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_finite(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return None
    return x


def emit(result: dict) -> None:
    """The numbers compared, last on standard error; the result line, last
    on standard output (``checks`` its last key)."""
    result = _finite(result)
    readings = result.pop("_readings", {})
    print(f"readings: {json.dumps(readings, allow_nan=False)}", file=sys.stderr)
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result, allow_nan=False), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    prepare_environment()
    import torch

    bench = read_json(ROOT / "BENCHMARK.json")
    try:
        chips = int(find_cell(bench, args.workload)["chips"])
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            raise BenchError(f"the cell needs {chips} CUDA card(s); "
                             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} here")
        result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                          "cuda:0", bench=bench)
        found = banned_modules()
        if found:
            raise BenchError(f"JAX or the JAX package is loaded: {found}")
    except BenchError as e:
        print(f"bench: {e}", file=sys.stderr)
        return 2
    emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
