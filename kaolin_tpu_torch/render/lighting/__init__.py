from .sh import *  # noqa: F401,F403
