from .cvar import CVar, CVarSystem, cvars  # noqa: F401
from .log import get_logger  # noqa: F401
