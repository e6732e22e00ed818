"""mfu.prefill: the model operations of every prefill answered in the
traced window (``counts.prefill_flops``: active experts only, causal
attention over the kept pairs, the head at the last position) over the
window's seconds times the chip's bf16 peak, in %."""
from benchkit import counts, peaks

WRAPS = []


def read(run):
    flops = sum(counts.prefill_flops(r.prompt_tokens, run.sizes) for r in run.requests
                if r.served is not None and run.in_window(r.first_token))
    if not flops:
        return None
    return 100.0 * flops / (run.seconds * peaks.BF16_FLOPS)
