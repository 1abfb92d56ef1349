"""repro_torch.launch — meshes, partitioning and the command-line entry
points (``python -m repro_torch.launch.serve``, ``.train`` and
``.elastic``)."""

from .mesh import batch_axes, dp_size, make_production_mesh, make_test_mesh
from .partitioning import DEFAULT_RULES, Partitioner, batch_shardings, device_put_tree

__all__ = [
    "batch_axes", "dp_size", "make_production_mesh", "make_test_mesh",
    "DEFAULT_RULES", "Partitioner", "batch_shardings", "device_put_tree",
]
