"""Launchers: production meshes, dry-run, train/serve entry points.

``dryrun`` is not imported here: run it as ``python -m
repro_torch.launch.dryrun`` (it starts a fake process group of 256 or 512
ranks, in its own process).
"""
from .mesh import make_host_mesh, make_production_mesh
from .roofline import (
    collective_stats,
    model_flops_estimate,
    roofline_terms,
)
from .specs import input_specs, make_step
