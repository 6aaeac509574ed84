"""Mesh construction lives in the distribution layer
(``repro_torch.dist.mesh``), so learners and tests build meshes from one
place; this module re-exports it under the reference's launch name."""
from repro_torch.dist.mesh import (  # noqa: F401
    axis_sizes,
    make_device_mesh,
    make_host_mesh,
    make_production_mesh,
)
