"""Per-frame 2D overlay rendering (numpy rasterization, no GL).

Counterpart of plvs_tpu/viz/frame_drawer.py, line for line (the
reference's FrameDrawer, src/FrameDrawer.cc: tracked keypoints as green
squares, untracked ones in blue, keylines as segments, a strip coloured by
the tracking state). Output is a plain [H, W, 3] uint8 image. ``save_png``
writes a PPM beside the requested name when PIL is absent: host file IO,
as the JAX package does.
"""

from __future__ import annotations

import numpy as np

GREEN = (80, 220, 80)
BLUE = (90, 140, 255)
RED = (230, 80, 80)
YELLOW = (240, 220, 90)

STATE_NAMES = {
    -1: "SYSTEM NOT READY",
    0: "NO IMAGES YET",
    1: "NOT INITIALIZED",
    2: "OK",
    3: "RECENTLY LOST",
    4: "LOST",
}


def to_rgb(gray: np.ndarray) -> np.ndarray:
    g = np.clip(gray, 0, 255).astype(np.uint8)
    return np.repeat(g[..., None], 3, -1)


def draw_squares(img: np.ndarray, xy: np.ndarray, color, r: int = 2):
    """Hollow squares centered at xy (the reference's keypoint marker)."""
    h, w = img.shape[:2]
    for cx, cy in np.round(xy).astype(int):
        x0, x1 = max(cx - r, 0), min(cx + r, w - 1)
        y0, y1 = max(cy - r, 0), min(cy + r, h - 1)
        if x0 > x1 or y0 > y1:
            continue
        img[y0, x0:x1 + 1] = color
        img[y1, x0:x1 + 1] = color
        img[y0:y1 + 1, x0] = color
        img[y0:y1 + 1, x1] = color
    return img


def draw_segments(img: np.ndarray, p0: np.ndarray, p1: np.ndarray, color):
    """Line segments via vectorized sampling along each segment."""
    h, w = img.shape[:2]
    for (x0, y0), (x1, y1) in zip(p0, p1):
        n = int(max(abs(x1 - x0), abs(y1 - y0), 1)) + 1
        t = np.linspace(0.0, 1.0, n)
        xs = np.round(x0 + t * (x1 - x0)).astype(int)
        ys = np.round(y0 + t * (y1 - y0)).astype(int)
        ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
        img[ys[ok], xs[ok]] = color
    return img


def _draw_state_bar(img: np.ndarray, state: int) -> np.ndarray:
    """Color-coded status strip (stands in for the reference's text bar)."""
    color = {2: GREEN, 3: YELLOW, 4: RED}.get(state, BLUE)
    img[:4, :] = color
    return img


def draw_frame(gray: np.ndarray,
               kp_xy: np.ndarray | None = None,
               kp_tracked: np.ndarray | None = None,
               kl_p0: np.ndarray | None = None,
               kl_p1: np.ndarray | None = None,
               kl_tracked: np.ndarray | None = None,
               state: int = 2) -> np.ndarray:
    """Render the reference FrameDrawer overlay: tracked features green,
    untracked blue, line features as segments, state strip on top."""
    img = to_rgb(gray)
    if kp_xy is not None and len(kp_xy):
        tracked = (np.ones(len(kp_xy), bool)
                   if kp_tracked is None else kp_tracked.astype(bool))
        draw_squares(img, kp_xy[tracked], GREEN)
        draw_squares(img, kp_xy[~tracked], BLUE)
    if kl_p0 is not None and len(kl_p0):
        trk = (np.ones(len(kl_p0), bool)
               if kl_tracked is None else kl_tracked.astype(bool))
        draw_segments(img, kl_p0[trk], kl_p1[trk], GREEN)
        draw_segments(img, kl_p0[~trk], kl_p1[~trk], BLUE)
    return _draw_state_bar(img, state)


def save_png(path: str, img: np.ndarray):
    try:
        from PIL import Image

        Image.fromarray(img).save(path)
    except ImportError:  # minimal fallback: PPM next to the requested name
        alt = path.rsplit(".", 1)[0] + ".ppm"
        h, w = img.shape[:2]
        with open(alt, "wb") as f:
            f.write(f"P6\n{w} {h}\n255\n".encode())
            f.write(img.astype(np.uint8).tobytes())
