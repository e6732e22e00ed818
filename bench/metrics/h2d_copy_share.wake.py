"""h2d_copy_share.wake: the share of the wakes' host time during which a
host-to-device memcpy ran on the card, in %: how far the host's
bookkeeping leaves the link idle."""
WRAPS = []


def read(run):
    s = run.summary
    if s is None or not s.span_s.get("bench.wake"):
        return None
    return 100.0 * s.span_h2d_s.get("bench.wake", 0.0) / s.span_s["bench.wake"]
