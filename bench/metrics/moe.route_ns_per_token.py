"""moe.route_ns_per_token: the card time of the MoE channel's dispatch
(the router, each assignment's slot and the scatter into the capacity
buffers), over the tokens routed in the window, in ns. The time is what
the program's ``mma.moe.route`` spans measured between the timing events
they record on the card at their two ends (the stage's kernels and the
stream's gaps between them); the tokens are the program's
``mma.moe.tokens`` counter (B x S a call: one token in one MoE layer
counts once). Loading this file puts the card tracer in place
(``benchkit.program``)."""
from benchkit import program

WRAPS = []
program.tracer()


def read(run):
    device_s = sum(s.args.get("device_s", 0.0) for s in program.rows(run, ["mma.moe.route"]))
    tokens = sum(s.args["value"] for s in program.rows(run, ["mma.moe.tokens"]))
    if not device_s or not tokens:
        return None
    return 1e9 * device_s / tokens
