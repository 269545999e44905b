from .legacy import *  # noqa: F401,F403
from .camera import Camera
from .extrinsics import CameraExtrinsics, register_backend
from .intrinsics import CameraIntrinsics, CameraFOV
from .intrinsics_pinhole import PinholeIntrinsics
from .intrinsics_ortho import OrthographicIntrinsics
from .coordinates import blender_coords, opengl_coords
