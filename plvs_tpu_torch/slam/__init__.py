"""SLAM front end: frames, map store, tracker and the System facade."""

from .map_store import MapStore  # noqa: F401
from .system import System, SystemConfig  # noqa: F401
