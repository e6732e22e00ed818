"""The end-to-end arithmetic is taken over every request and every switch
of the window: a stall injected into a fake log moves each metric."""
import importlib.util
from pathlib import Path

import numpy as np

from benchkit.record import Request, Run, Switch

METRICS = Path(__file__).resolve().parents[1] / "metrics"


def metric(name):
    spec = importlib.util.spec_from_file_location(name, METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def serve_log(stall_at=None, stall=0.0, n=100):
    run = Run(sizes={}, seconds=10.0, t0=0.0, t1=10.0)
    t = 0.0
    for i in range(n):
        dt = 0.1 + (stall if i == stall_at else 0.0)
        run.requests.append(Request(index=i, tokens=np.zeros(1000, np.int64), issue=t,
                                    prefill_start=t + 0.01, first_token=t + dt, served=1))
        t += dt
    return run


def test_ttft_tail_and_rate_see_a_stall():
    p95, rate = metric("ttft_p95_ms"), metric("prompt_tokens_per_s")
    base = serve_log()
    assert abs(p95.read(base) - 100.0) < 1e-9
    assert abs(rate.read(base) - 1000 * 100 / 10.0) < 1e-6
    # six requests that each wait 2 s more: past the 5% tail
    stalled = serve_log()
    for r in stalled.requests[:6]:
        r.first_token += 2.0
    assert p95.read(stalled) > 2000.0
    late = serve_log(stall_at=50, stall=3.0)          # pushes 30 requests out of the window
    assert rate.read(late) < rate.read(base) * 0.75


def test_a_failed_request_counts_as_missing():
    p95 = metric("ttft_p95_ms")
    run = serve_log(n=20)
    run.requests[3].failed = True
    assert p95.read(run) is None or p95.read(run) > 100.0


def test_switch_mean_over_every_switch_in_the_window():
    sw = metric("switch_s")
    run = Run(sizes={}, seconds=20.0, t0=0.0, t1=20.0)
    for k in range(4):
        run.switches.append(Switch(start=5.0 * k, slept=5.0 * k + 3, end=5.0 * k + 4, nbytes=10))
    assert abs(sw.read(run) - 4.0) < 1e-12
    run.switches[1].end += 4.0                        # one switch stalls
    assert abs(sw.read(run) - 5.0) < 1e-12
    run.switches.append(Switch(start=19.0, slept=21.0, end=22.0, nbytes=10))  # ends outside
    assert abs(sw.read(run) - 5.0) < 1e-12


def test_bandwidths_and_shares():
    run = Run(sizes={}, seconds=20.0, t0=0.0, t1=20.0)
    run.switches = [Switch(start=0.0, slept=2.0, end=3.0, nbytes=10**9),
                    Switch(start=5.0, slept=7.0, end=8.0, nbytes=10**9)]
    assert abs(metric("wake_gbps").read(run) - 1.0) < 1e-12
    assert abs(metric("sleep_gbps").read(run) - 0.5) < 1e-12
    srv = serve_log(n=10)
    for r in srv.requests:
        r.hit_tokens = 250
    assert abs(metric("prefix_hit_share").read(srv) - 25.0) < 1e-12
    assert abs(metric("queue_ms").read(srv) - 10.0) < 1e-9
