"""Launchers: the device meshes (the JAX package's dry-run, roofline and
train/serve entry points are not ported yet)."""
from .mesh import make_host_mesh, make_production_mesh
