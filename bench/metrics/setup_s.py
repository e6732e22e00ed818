"""setup_s: seconds from the start of the process to the window's start:
imports, the kernels' build or load, the weights made from the seed, the
servers, and the warm-up of every shape the cell's traffic uses."""
WRAPS = []


def read(run):
    return run.setup_s
