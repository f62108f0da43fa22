from .mesh import *  # noqa: F401,F403
