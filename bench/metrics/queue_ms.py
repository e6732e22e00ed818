"""queue_ms: the mean over every request the window's clients issued of
(prefill start - issue): the time a request waits in the serving loop
before its prefill begins."""
WRAPS = []


def read(run):
    waits = [(r.prefill_start - r.issue) * 1e3 for r in run.requests
             if r.prefill_start is not None]
    return sum(waits) / len(waits) if waits else None
