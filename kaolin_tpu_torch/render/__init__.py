from . import camera
from . import lighting
from . import mesh
from . import spc
