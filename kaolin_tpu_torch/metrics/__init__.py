from . import pointcloud
from . import render
from . import trianglemesh
