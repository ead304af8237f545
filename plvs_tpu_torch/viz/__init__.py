"""Visualization layer (headless first).

Counterpart of plvs_tpu/viz/ (the reference's Pangolin / OpenGL viewer
stack, src/Viewer.cc, src/FrameDrawer.cc, src/MapDrawer.cc,
src/PointCloudDrawer.cc, and the optional Rerun stream):

* ``frame_drawer``: per-frame 2D overlays (keypoints, keylines, tracking
  state) rendered into numpy RGB images;
* ``map_drawer``: the 3D map (keyframe frusta, covisibility graph,
  landmarks, dense cloud) through matplotlib when present, and PLY export;
* ``rerun_logger``: structured streaming when the ``rerun`` SDK is
  importable (a no-op otherwise);
* ``gl_objects``, ``ar`` and ``live_server`` are imported on their own.
"""

from . import frame_drawer, map_drawer, rerun_logger  # noqa: F401
