"""Sharded rendering, metrics and ray tracing over a mesh of ranks
(``torch.distributed``). Port of ``kaolin_tpu/parallel``; it exports the
same names except ``P`` (JAX's ``PartitionSpec``), which has no
counterpart here: each sharded function computes this rank's own block.
"""

from .mesh import make_mesh, Mesh
from .distributed import init_distributed, is_distributed
from .render import sharded_rasterize, sharded_dibr_rasterization
from .spc import sharded_raytrace
from .metrics import (sharded_sided_distance, sharded_chamfer_distance,
                      sharded_point_to_mesh_distance)
