"""MMA on PyTorch and CUDA: the multipath transfer engine and the serving
path it feeds, ported from the JAX package ``repro`` to an NVIDIA H100.

The port imports nothing of ``repro`` or ``jax``. Modules keep the JAX
package's names so each one's counterpart is easy to find.

Subpackages:
    core      the transfer engine; ``torch_backend`` is its CUDA data plane
    obs       tracing and metrics (copied from ``repro.obs``)
    kvstore   tiered prefix KV store (copied from ``repro.kvstore``)
    configs   the architectures, as data
    kernels   hand-written CUDA kernels for sm_90a, each beside its plain
              PyTorch version (sources in ``csrc/``)
    models    the dense transformer: prefill and decode
    serving   ``FunctionalServer``, ``WeightManager``, KV accounting

Entry points run on the first CUDA card unless the caller passes a CPU
device; with no card and no CPU request they raise.
"""

__version__ = "0.1.0"
