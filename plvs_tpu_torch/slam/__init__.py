"""SLAM: frames, map store, tracker, local mapping and the System facade."""

from .local_mapping import LocalMapper  # noqa: F401
from .map_store import MapStore  # noqa: F401
from .system import System, SystemConfig  # noqa: F401
