from . import pointcloud
from . import render
from . import tetmesh
from . import trianglemesh
from . import voxelgrid
