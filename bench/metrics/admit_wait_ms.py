"""admit_wait_ms: the mean of the program's ``mma.req.queue`` spans over
the window's requests, in ms: from ``submit`` until ``Scheduler.schedule``
admits the request (``max_running`` holds it back). ``queue_ms`` less
this is the wait after admission, behind the other prefills of the step.
Loading this file puts the card tracer in place (``benchkit.program``)."""
from benchkit import program

WRAPS = []
program.tracer()


def read(run):
    waits = [s.t1 - s.t0 for s in program.rows(run, ["mma.req.queue"])]
    return 1e3 * sum(waits) / len(waits) if waits else None
