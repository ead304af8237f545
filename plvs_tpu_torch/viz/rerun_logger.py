"""Optional Rerun streaming (a no-op when the SDK is absent).

Counterpart of plvs_tpu/viz/rerun_logger.py (the reference's WITH_RERUN
integration, include/RerunSingleton.h). The import is lazy and tolerates
failure, so the port never depends on the viewer being installed; the
recording is named after the port.
"""

from __future__ import annotations

import numpy as np

_rr = None
_checked = False


def _rerun():
    global _rr, _checked
    if not _checked:
        _checked = True
        try:
            import rerun  # type: ignore

            rerun.init("plvs_tpu_torch", spawn=False)
            _rr = rerun
        except Exception:
            _rr = None
    return _rr


def available() -> bool:
    return _rerun() is not None


def log_frame(gray: np.ndarray, kp_xy: np.ndarray | None = None,
              entity: str = "camera/image"):
    rr = _rerun()
    if rr is None:
        return
    rr.log(entity, rr.Image(gray.astype(np.uint8)))
    if kp_xy is not None and len(kp_xy):
        rr.log(entity + "/keypoints", rr.Points2D(kp_xy))


def log_map(points: np.ndarray, colors: np.ndarray | None = None,
            entity: str = "map/points"):
    rr = _rerun()
    if rr is None:
        return
    rr.log(entity, rr.Points3D(points, colors=colors))


def log_trajectory(centers: np.ndarray, entity: str = "map/trajectory"):
    rr = _rerun()
    if rr is None:
        return
    rr.log(entity, rr.LineStrips3D([centers]))
