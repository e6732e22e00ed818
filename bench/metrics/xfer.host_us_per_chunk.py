"""xfer.host_us_per_chunk: the host us of the transfer engine's task
spans in the window (``MMAEngine._activate`` to the last chunk's landing,
``mma.xfer.h2d`` and ``mma.xfer.d2h``), less the ``mma.xfer.pin`` and
``mma.xfer.wait`` spans inside them, over the chunks the engine's own
ledgers counted (``LinkWorker.chunks_direct`` and ``chunks_relay``, read
by each ``mma.weights.sleep`` and ``mma.weights.wake`` span: in the
switch cell every transfer is a sleep's or a wake's). Loading this file
puts the card tracer in place (``benchkit.program``)."""
from benchkit import program

WRAPS = []
program.tracer()


def read(run):
    tasks = program.rows(run, cat="transfer")
    chunks = sum(s.args.get("chunks", 0)
                 for s in program.rows(run, ["mma.weights.sleep", "mma.weights.wake"]))
    if not tasks or not chunks:
        return None
    inner = program.rows(run, ["mma.xfer.pin", "mma.xfer.wait"])
    host = program.seconds(tasks) - program.overlap(tasks, inner)
    return 1e6 * host / chunks
