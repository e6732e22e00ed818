"""kv_host_ms: the host ms of the program's ``mma.kv.fetch`` and
``mma.kv.offload`` spans in the window (the prefix cache's radix match and
its sim-timed transfer, run to its end before a prefill starts or after a
request finishes), per request answered in the window. Loading this file
puts the card tracer in place (``benchkit.program``)."""
from benchkit import program

WRAPS = []
program.tracer()


def read(run):
    spans = program.rows(run, ["mma.kv.fetch", "mma.kv.offload"])
    t0, t1 = program.window(run)
    answered = sum(1 for r in run.requests if r.served is not None
                   and r.first_token is not None and t0 <= r.first_token <= t1)
    return 1e3 * program.seconds(spans) / answered if spans and answered else None
