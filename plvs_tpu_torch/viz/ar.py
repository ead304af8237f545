"""Augmented-reality overlay: dominant-plane detection + virtual objects.

Counterpart of plvs_tpu/viz/ar.py (the reference's AR demo layer,
Examples_old/RGB-D/ViewerAR.h:55-96: ViewerAR::DetectPlane fits a plane to
the tracked map points by RANSAC and draws virtual cubes anchored to it
over the live frame). The plane RANSAC runs on the device of the points it
is given: every hypothesis is scored in one [N, n_hyp] |pts . n - d|
matrix, the winner is refit by ``eigh`` of its inliers' covariance, all
without a host branch. ``jax.random`` cannot be replayed in torch, so
``_plane_ransac`` takes its [n_hyp, 3] sample indices as an argument and
``detect_plane`` draws them from a ``torch.Generator`` seeded by ``seed``;
``detect_plane`` then reads the result back once. Rendering is the
frame drawer's numpy rasterizer.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..geometry import cameras as cam_mod
from ..ops import resolve_device
from . import frame_drawer

N_HYPOTHESES = 128


def _plane_ransac(pts: torch.Tensor, valid: torch.Tensor,
                  samples: torch.Tensor, thresh: float = 0.02):
    """Plane RANSAC over [N, 3] points from the [n_hyp, 3] point indices
    ``samples``. Returns (normal [3], d, inlier_mask [N], n_inliers) as
    tensors on the points' device; the plane is n . x = d with |n| = 1.
    The first of tied hypotheses wins (``torch.argmax``, as ``jnp.argmax``);
    a degenerate (collinear) sample scores 0; the refit's normal is the
    covariance's smallest eigenvector, turned to the winner's side."""
    th = float(np.float32(thresh))  # the gate in float32, as JAX's
    samples = samples.long()
    p0, p1, p2 = pts[samples[:, 0]], pts[samples[:, 1]], pts[samples[:, 2]]
    nrm = torch.linalg.cross(p1 - p0, p2 - p0)
    nlen = torch.linalg.norm(nrm, dim=-1, keepdim=True)
    nrm = nrm / torch.clamp(nlen, min=1e-9)
    d = (nrm * p0).sum(-1)                                   # [H]
    dist = (pts @ nrm.T - d[None, :]).abs()                  # [N, H]
    inl = (dist < th) & valid[:, None]
    score = inl.sum(0)
    score = torch.where(nlen[:, 0] > 1e-6, score, torch.zeros_like(score))
    best = torch.argmax(score)
    n_best = nrm[best]
    inl_best = inl[:, best]
    # least-squares refit on the inliers
    wi = inl_best.to(pts.dtype)
    c = (pts * wi[:, None]).sum(0) / torch.clamp(wi.sum(), min=1.0)
    q = (pts - c) * wi[:, None]
    _, vecs = torch.linalg.eigh(q.T @ q)
    n_ref = vecs[:, 0]
    # eigh's eigenvector is defined up to sign: keep the winner's side
    n_ref = torch.where((n_ref @ n_best) < 0, -n_ref, n_ref)
    d_ref = n_ref @ c
    inl_r = ((pts @ n_ref - d_ref).abs() < th) & valid
    return n_ref, d_ref, inl_r, inl_r.sum()


def draw_samples(n: int, generator: torch.Generator,
                 n_hyp: int = N_HYPOTHESES) -> torch.Tensor:
    """[n_hyp, 3] point indices in [0, n), drawn with replacement (as
    ``jax.random.randint``) on the generator's device."""
    return torch.randint(0, n, (n_hyp, 3), generator=generator,
                         device=generator.device)


@dataclasses.dataclass
class Plane:
    """A detected support plane: world pose with +z = plane normal."""

    normal: np.ndarray   # [3] unit, world frame
    d: float             # plane offset: normal . x = d
    origin: np.ndarray   # [3] anchor point on the plane (inlier centroid)
    n_inliers: int

    @property
    def Rwp(self) -> np.ndarray:
        """Plane-to-world rotation: columns = in-plane x/y axes + normal."""
        z = self.normal
        a = np.array([1.0, 0.0, 0.0], np.float32)
        if abs(z @ a) > 0.9:
            a = np.array([0.0, 1.0, 0.0], np.float32)
        x = np.cross(a, z)
        x /= np.linalg.norm(x) + 1e-12
        y = np.cross(z, x)
        return np.stack([x, y, z], axis=1).astype(np.float32)


def detect_plane(pts_world: np.ndarray, seed: int = 0,
                 thresh: float = 0.02, min_inliers: int = 30,
                 device: str | torch.device = "cuda") -> Plane | None:
    """Fit the dominant plane of tracked map points on ``device`` (reference:
    ViewerAR::DetectPlane); one host read brings back the normal, d and
    the inlier mask."""
    if len(pts_world) < 8:
        return None
    dev = resolve_device(device)
    pts_np = np.asarray(pts_world, np.float32)
    pts = torch.from_numpy(pts_np).to(dev)
    valid = torch.ones((len(pts_np),), dtype=torch.bool, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    nrm, d, inl, _ = _plane_ransac(pts, valid,
                                   draw_samples(len(pts_np), gen), thresh)
    host = torch.cat([nrm, d.reshape(1), inl.to(torch.float32)]).cpu().numpy()
    inl = host[4:] > 0.5
    k = int(inl.sum())
    if k < min_inliers:
        return None
    origin = pts_np[inl].mean(0).astype(np.float32)
    return Plane(host[:3].copy(), float(host[3]), origin, k)


def cube_vertices(plane: Plane, size: float = 0.1,
                  offset_xy=(0.0, 0.0)) -> np.ndarray:
    """[8, 3] world corners of a cube of side ``size`` resting on the plane
    (reference: ViewerAR virtual cube insertion)."""
    s = size / 2.0
    local = np.array(
        [[x, y, z] for z in (0.0, size) for y in (-s, s) for x in (-s, s)],
        np.float32,
    )
    local[:, 0] += offset_xy[0]
    local[:, 1] += offset_xy[1]
    return (plane.Rwp @ local.T).T + plane.origin


CUBE_EDGES = [
    (0, 1), (1, 3), (3, 2), (2, 0),       # bottom face
    (4, 5), (5, 7), (7, 6), (6, 4),       # top face
    (0, 4), (1, 5), (2, 6), (3, 7),       # pillars
]


def draw_object_overlay(img_rgb: np.ndarray, cam: cam_mod.Camera,
                        Rcw: np.ndarray, tcw: np.ndarray,
                        verts_world: np.ndarray, edges=None,
                        color=(0, 255, 0)) -> np.ndarray:
    """Project a wireframe object into the frame and draw its edges (the
    AR cube with ``edges=CUBE_EDGES``; ``edges=None`` draws the vertices
    as squares). The projection runs on the host: a handful of vertices."""
    Xc = (Rcw @ np.asarray(verts_world, np.float32).T).T + tcw
    z = Xc[:, 2]
    uv = cam_mod.project(cam, torch.from_numpy(
        np.ascontiguousarray(Xc, np.float32))).numpy()
    vis = z > 0.05
    out = img_rgb
    if edges is None:
        out = frame_drawer.draw_squares(out, uv[vis], color, r=2)
        return out
    p0, p1 = [], []
    for a, b in edges:
        if vis[a] and vis[b]:
            p0.append(uv[a])
            p1.append(uv[b])
    if p0:
        out = frame_drawer.draw_segments(out, np.asarray(p0), np.asarray(p1),
                                         color)
    return out


def load_ply_vertices(path: str, max_points: int | None = None) -> np.ndarray:
    """Minimal ascii-PLY vertex reader for static overlay objects
    (reference: GlObjectList loading ply overlays via ``GlObjects.*``)."""
    with open(path) as f:
        assert f.readline().strip() == "ply"
        n_vert = 0
        while True:
            line = f.readline()
            if not line:
                raise ValueError("bad ply header")
            if line.startswith("element vertex"):
                n_vert = int(line.split()[-1])
            if line.strip() == "end_header":
                break
        pts = []
        for _ in range(n_vert):
            vals = f.readline().split()
            pts.append([float(v) for v in vals[:3]])
    pts = np.asarray(pts, np.float32)
    if max_points and len(pts) > max_points:
        pts = pts[np.random.default_rng(0).choice(len(pts), max_points,
                                                  replace=False)]
    return pts


@dataclasses.dataclass
class GlObject:
    """A static world-anchored overlay object (reference: GlObject —
    ply cloud + pose from yaml)."""

    verts: np.ndarray          # [V, 3] object-frame vertices
    Rwo: np.ndarray            # object-to-world rotation
    two: np.ndarray            # object-to-world translation
    color: tuple = (255, 128, 0)

    @property
    def verts_world(self) -> np.ndarray:
        return (self.Rwo @ self.verts.T).T + self.two


def render_ar_frame(gray: np.ndarray, cam: cam_mod.Camera,
                    Rcw: np.ndarray, tcw: np.ndarray,
                    pts_world: np.ndarray | None = None,
                    plane: Plane | None = None,
                    cube_size: float = 0.1,
                    objects: list[GlObject] = (),
                    device: str | torch.device = "cuda") -> np.ndarray:
    """Full AR compositing pass (reference: ViewerAR::Run draw loop):
    camera image + detected-plane cube + static objects. Without a
    ``plane``, one is detected from ``pts_world`` on ``device``."""
    img = frame_drawer.to_rgb(gray)
    if plane is None and pts_world is not None and len(pts_world):
        plane = detect_plane(pts_world, device=device)
    if plane is not None:
        cube = cube_vertices(plane, size=cube_size)
        img = draw_object_overlay(img, cam, Rcw, tcw, cube, CUBE_EDGES)
    for obj in objects:
        img = draw_object_overlay(img, cam, Rcw, tcw, obj.verts_world,
                                  None, obj.color)
    return img
