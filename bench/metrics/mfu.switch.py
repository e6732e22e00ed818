"""mfu.switch: the model operations of every prefill the switch cell
answered in the traced window (``counts.prefill_flops``) over the window's
seconds times the chip's bf16 peak, in %: the whole round's share of the
peak, which rises as switches shorten and leave more of the window to
serving, whatever kernel a later change takes off the path."""
from benchkit import counts, peaks

WRAPS = []


def read(run):
    flops = sum(counts.prefill_flops(r.prompt_tokens, run.sizes) for r in run.requests
                if r.served is not None and run.in_window(r.first_token))
    if not flops:
        return None
    return 100.0 * flops / (run.seconds * peaks.BF16_FLOPS)
