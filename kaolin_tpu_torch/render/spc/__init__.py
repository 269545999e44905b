from .raytrace import *  # noqa: F401,F403
