"""idle_share.prefill: the share of the traced window in which no kernel,
memcpy or memset ran on the card, in %."""
WRAPS = []


def read(run):
    s = run.summary
    if s is None or not s.window_s or not s.n_device_events:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)
