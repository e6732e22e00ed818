"""sleep_gbps: the bytes every sleep of the window moved over the
host-clock seconds of those ``sleep()`` calls, in decimal GB/s."""
WRAPS = []


def read(run):
    s = sum(w.slept - w.start for w in run.switches)
    return sum(w.nbytes for w in run.switches) / s / 1e9 if s else None
