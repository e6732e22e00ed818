"""ttft_p95_ms: the 95th percentile (nearest rank) over every request the
window's clients issued, each timed from its issue to the moment the host
held its first token (drained requests included); a failed request counts
as missing every limit."""
import math

from benchkit.stats import percentile

WRAPS = []


def read(run):
    ttft = [(r.first_token - r.issue) * 1e3 if r.first_token is not None and not r.failed
            else math.inf for r in run.requests]
    if not ttft:
        return None
    p95 = percentile(ttft, 95)
    return p95 if math.isfinite(p95) else None
