"""3D map rendering and export (matplotlib / PLY, no GL).

Counterpart of plvs_tpu/viz/map_drawer.py (the reference's MapDrawer and
PointCloudDrawer: keyframe frusta, covisibility edges, map points and
lines, the dense cloud). The covisibility edges come from the port's numpy
replay of the JAX package's native graph (``slam.map_store.covis_graph``),
so they are the native path's edges in the native order; the JAX package's
fallback without its native library is not needed. ``render_map_png``
returns False without matplotlib, as the JAX package does.
"""

from __future__ import annotations

import numpy as np

from ..slam.map_store import covis_graph

# camera frustum wireframe in the camera frame (z forward), unit scale
_FRUSTUM = np.array([
    [0, 0, 0], [-1, -0.75, 2], [1, -0.75, 2], [1, 0.75, 2], [-1, 0.75, 2],
], np.float32) * 0.05
_FRUSTUM_EDGES = [(0, 1), (0, 2), (0, 3), (0, 4), (1, 2), (2, 3), (3, 4), (4, 1)]


def keyframe_frusta(kf_R: np.ndarray, kf_t: np.ndarray, kf_mask: np.ndarray,
                    scale: float = 1.0):
    """Wireframe segments for every live keyframe: [E, 2, 3] world coords
    (the reference draws these in MapDrawer::DrawKeyFrames)."""
    segs = []
    for k in np.nonzero(kf_mask)[0]:
        Rwc = kf_R[k].T
        C = -Rwc @ kf_t[k]
        corners = (scale * _FRUSTUM) @ Rwc.T + C
        for a, b in _FRUSTUM_EDGES:
            segs.append((corners[a], corners[b]))
    return np.asarray(segs, np.float32).reshape(-1, 2, 3)


def covisibility_segments(store, min_weight: int = 30):
    """One segment per covisibility edge between keyframe centers
    (reference: MapDrawer::DrawKeyFrames graph pass)."""
    centers = {}
    for k in np.nonzero(store.kf_mask)[0]:
        centers[int(k)] = -store.kf_R[k].T @ store.kf_t[k]
    top = store._obs_top
    ei, ej, _ = covis_graph(store.obs_kf[:top], store.obs_pt[:top],
                            store.obs_mask[:top], store.max_kf,
                            store.max_pts, min_weight=min_weight)
    segs = [(centers[a], centers[b]) for a, b in zip(ei.tolist(), ej.tolist())
            if a in centers and b in centers]
    return np.asarray(segs, np.float32).reshape(-1, 2, 3)


def render_map_png(path: str, store, dense_cloud=None, traj=None,
                   elev: float = -60.0, azim: float = -90.0):
    """Render the sparse map (+optional dense cloud and trajectory) to a PNG
    via matplotlib's 3D axes — the headless stand-in for the Pangolin
    window. Returns False when matplotlib is unavailable."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return False
    fig = plt.figure(figsize=(8, 6))
    ax = fig.add_subplot(projection="3d")
    live = store.pt_mask
    if live.any():
        pts = store.pt_xyz[live]
        ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], s=0.5, c="k", alpha=0.4)
    if store.ln_mask.any():
        for a, b in zip(store.ln_Xs[store.ln_mask],
                        store.ln_Xe[store.ln_mask]):
            ax.plot(*zip(a, b), c="tab:red", lw=0.8)
    for a, b in keyframe_frusta(store.kf_R, store.kf_t, store.kf_mask):
        ax.plot(*zip(a, b), c="tab:blue", lw=0.6)
    for a, b in covisibility_segments(store):
        ax.plot(*zip(a, b), c="tab:green", lw=0.4, alpha=0.6)
    if dense_cloud is not None and len(dense_cloud):
        sub = dense_cloud[:: max(1, len(dense_cloud) // 20000)]
        ax.scatter(sub[:, 0], sub[:, 1], sub[:, 2], s=0.3, c="tab:gray",
                   alpha=0.3)
    if traj is not None and len(traj):
        ax.plot(traj[:, 0], traj[:, 1], traj[:, 2], c="tab:orange", lw=1.5)
    ax.view_init(elev=elev, azim=azim)
    ax.set_box_aspect((1, 1, 1))
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return True


def save_segments_ply(path: str, pts: np.ndarray, labels: np.ndarray):
    """Dense segment cloud with per-label colors (the reference's segment
    shader coloring, Shaders/ + PointCloudDrawer)."""
    rng = np.random.default_rng(12345)
    palette = rng.integers(40, 255, (max(int(labels.max()) + 1, 1), 3))
    palette[0] = (128, 128, 128)
    cols = palette[np.clip(labels, 0, len(palette) - 1)]
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(pts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        for p, c in zip(pts, cols):
            f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f} "
                    f"{int(c[0])} {int(c[1])} {int(c[2])}\n")
