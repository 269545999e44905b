from . import camera
from . import mesh
