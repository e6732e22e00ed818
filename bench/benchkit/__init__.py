"""The benchmark's own machinery: cells read from data files, seeded
weights and traffic, the profiler's window reduced to per-layer numbers,
operation and byte counts, and the comparison that decides ``correct``.
Nothing here imports JAX or the JAX package."""


class BenchError(Exception):
    """A run that cannot report: it exits non-zero and prints no result."""
