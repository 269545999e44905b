from .pointcloud import *  # noqa: F401,F403
from .sdf import *  # noqa: F401,F403
from .tetmesh import *  # noqa: F401,F403
from .trianglemesh import *  # noqa: F401,F403
from .voxelgrid import *  # noqa: F401,F403
from .mesh import *  # noqa: F401,F403
