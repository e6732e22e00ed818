"""prefix_hit_share: the prompt tokens the prefix cache matched
(``Request.hit_tokens``, the port's own count) over all prompt tokens of
the window's answered requests, in %."""
WRAPS = []


def read(run):
    done = [r for r in run.requests if r.served is not None]
    total = sum(r.prompt_tokens for r in done)
    return 100.0 * sum(r.hit_tokens for r in done) / total if total else None
