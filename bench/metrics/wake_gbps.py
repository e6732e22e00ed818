"""wake_gbps: the bytes every wake of the window moved over the host-clock
seconds of those ``wake()`` calls, in decimal GB/s."""
WRAPS = []


def read(run):
    s = sum(w.end - w.slept for w in run.switches)
    return sum(w.nbytes for w in run.switches) / s / 1e9 if s else None
