"""d2h_copy_share.sleep: the device seconds of the window's memcpys from
the card into pinned host memory over the host seconds of the program's
``mma.weights.sleep`` spans, in %: how far a sleep's host work leaves the
link idle (the counterpart of ``h2d_copy_share.wake``). Only a sleep
copies into pinned memory (a prefill's token comes back to pageable
memory), and one copy stream a card carries its chunks one after another,
so their sum is the sleeps' time with a copy on the card. Loading this
file puts the card tracer in place (``benchkit.program``)."""
from benchkit import program

WRAPS = []
program.tracer()


def read(run):
    s = run.summary
    sleeps = program.seconds(program.rows(run, ["mma.weights.sleep"]))
    if s is None or not s.n_device_events or not sleeps:
        return None
    d2h = sum(v for k, v in s.device_ops.items()
              if k.startswith("Memcpy DtoH") and "Pinned" in k)
    return 100.0 * d2h / sleeps
