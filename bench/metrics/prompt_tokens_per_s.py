"""prompt_tokens_per_s: the prompt tokens of every request answered inside
the window, over the window's seconds."""
WRAPS = []


def read(run):
    done = sum(r.prompt_tokens for r in run.requests
               if not r.failed and run.in_window(r.first_token))
    return done / run.seconds if done else None
