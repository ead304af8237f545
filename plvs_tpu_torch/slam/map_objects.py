"""Planar textured map objects: detection, Sim3 pose and refinement.

Counterpart of plvs_tpu/slam/map_objects.py. An object is a reference
image of a planar target with its ORB features; at every keyframe it is
matched against the keyframe's keypoints (kernel K1, template rows against
keyframe rows), a batched homography RANSAC maps the template plane to the
normalized image, and the planar pose follows in closed form; its Sim3
world pose is refined by a fixed number of Gauss-Newton steps against the
keyframes that observed it.

The object frame is the template's z = 0 plane, x right, y down, metric;
the corners are the template rectangle.

As in the other solvers of the port, the RANSAC's sampling is split out:
``ransac_plane_homography_from_samples`` scores given [n_hyp, 4] samples,
``ransac_plane_homography`` draws them (4 distinct indices, weights the
valid mask) from an explicit ``torch.Generator`` — the store's, seeded 0
where the JAX package starts from ``PRNGKey(0)``. The Sim3 refinement's
Jacobian is one forward-mode dual pass over the 7 tangent directions per
step (what ``jacfwd`` gives), at a fixed trip count.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..features import matching, orb
from ..geometry import cameras as cam_mod
from ..geometry import lie
from ..ops import resolve_device
from ..solvers import robust
from ..solvers.autodiff import jacobian

MIN_MATCHES = 12
MIN_INLIERS = 10
RANSAC_HYPOTHESES = 512
CHI2_PLANE = 5.991  # 2-dof reprojection gate


@dataclasses.dataclass
class ObjectTemplate:
    """A planar object's reference data: metric plane coordinates of its
    ORB keypoints, their descriptors (uint32 words) and the corners."""

    plane_xy: np.ndarray      # [N, 2] metric coords in the object plane
    desc: np.ndarray          # [N, 8] packed 256-bit descriptors
    corners: np.ndarray       # [4, 2] metric plane corners
    object_id: int = 0

    @staticmethod
    def from_image(gray: np.ndarray, metric_width: float, extractor=None,
                   object_id: int = 0, max_features: int = 512,
                   device: str | torch.device = "cuda") -> "ObjectTemplate":
        """Template of a reference image that spans ``metric_width`` in x:
        ORB at ``max_features`` (8 levels, on ``device``), or
        ``extractor(gray) -> (kp_xy, desc)``."""
        if extractor is None:
            img = torch.from_numpy(np.ascontiguousarray(gray, np.float32))
            kps = orb.extract(img.to(resolve_device(device)),
                              num_features=max_features)
            m = kps.mask.cpu().numpy()
            kp_xy = kps.xy.cpu().numpy()[m]
            desc = kps.desc.cpu().numpy().view(np.uint32)[m]
        else:
            kp_xy, desc = extractor(gray)
        h, w = gray.shape
        scale = metric_width / float(w)
        corners = np.array([[0, 0], [w, 0], [w, h], [0, h]],
                           np.float32) * scale
        return ObjectTemplate(plane_xy=np.asarray(kp_xy, np.float32) * scale,
                              desc=np.asarray(desc, np.uint32),
                              corners=corners, object_id=object_id)


# ---------------------------------------------------------------------------
# Homography RANSAC (plane -> normalized image)
# ---------------------------------------------------------------------------

def _dlt_h(p_plane: torch.Tensor, p_img: torch.Tensor,
           w: torch.Tensor) -> torch.Tensor:
    """Weighted DLT homography [..., N, 2] plane -> [..., N, 2] normalized
    image, batched over leading axes, H[2, 2] normalized to 1."""
    x, y = p_plane[..., 0], p_plane[..., 1]
    u, v = p_img[..., 0], p_img[..., 1]
    z = torch.zeros_like(x)
    o = torch.ones_like(x)
    r1 = torch.stack([x, y, o, z, z, z, -u * x, -u * y, -u], -1)
    r2 = torch.stack([z, z, z, x, y, o, -v * x, -v * y, -v], -1)
    A = torch.cat([r1 * w[..., None], r2 * w[..., None]], -2)
    _, _, vt = torch.linalg.svd(A, full_matrices=A.shape[-2] < 9)
    H = vt[..., -1, :].reshape(vt.shape[:-2] + (3, 3))
    h22 = H[..., 2, 2]
    return H / torch.where(h22.abs() > 1e-12, h22, 1.0)[..., None, None]


def _h_reproj_err2(H: torch.Tensor, p_plane: torch.Tensor,
                   p_img: torch.Tensor) -> torch.Tensor:
    """Squared transfer errors of H [..., 3, 3] over [N] points: [..., N]."""
    ph = torch.cat([p_plane, torch.ones_like(p_plane[:, :1])], -1)
    q = ph @ H.transpose(-1, -2)
    qz = q[..., 2:]
    q = q[..., :2] / torch.where(qz.abs() > 1e-12, qz, 1e-12)
    return ((q - p_img) ** 2).sum(-1)


def ransac_plane_homography_from_samples(p_plane: torch.Tensor,
                                         p_img: torch.Tensor,
                                         valid: torch.Tensor, sigma2: float,
                                         samples: torch.Tensor):
    """Score the 4-point hypotheses of ``samples`` [n_hyp, 4], take the
    best, then two guided refits on its inliers (each kept if it loses no
    inlier). Returns (H [3, 3], inliers [N], n_inliers)."""
    samples = samples.long()
    # the gate in float32, as the JAX package computes it
    th = float(np.float32(CHI2_PLANE) * np.float32(sigma2))
    Hs = _dlt_h(p_plane[samples], p_img[samples],
                torch.ones(samples.shape, dtype=p_plane.dtype,
                           device=p_plane.device))
    err2 = _h_reproj_err2(Hs, p_plane, p_img)               # [n_hyp, N]
    inl = (err2 < th) & valid[None]
    best = torch.argmax(inl.sum(-1))
    inl_best = inl[best]
    H = Hs[best]
    for _ in range(2):
        H2 = _dlt_h(p_plane, p_img, inl_best.to(p_plane.dtype))
        inl2 = (_h_reproj_err2(H2, p_plane, p_img) < th) & valid
        better = inl2.sum() >= inl_best.sum()
        H = torch.where(better, H2, H)
        inl_best = torch.where(better, inl2, inl_best)
    return H, inl_best, inl_best.sum()


def draw_samples(valid: torch.Tensor, generator: torch.Generator,
                 n_hyp: int = RANSAC_HYPOTHESES) -> torch.Tensor:
    """[n_hyp, 4] indices, distinct within a row, weights the valid mask
    (at least 4 entries must be valid)."""
    probs = valid.to(torch.float32)
    probs = (probs / torch.clamp(probs.sum(), min=1.0)).expand(n_hyp, -1)
    return torch.multinomial(probs, 4, replacement=False, generator=generator)


def ransac_plane_homography(p_plane: torch.Tensor, p_img: torch.Tensor,
                            valid: torch.Tensor, sigma2: float,
                            generator: torch.Generator,
                            n_hyp: int = RANSAC_HYPOTHESES):
    """The plane RANSAC with samples from ``generator``."""
    return ransac_plane_homography_from_samples(
        p_plane, p_img, valid, sigma2, draw_samples(valid, generator, n_hyp))


def pose_from_plane_homography(H: torch.Tensor):
    """Planar pose from a plane -> normalized-image homography, H ~
    [r1 r2 t], [r1 r2 r1 x r2] re-orthonormalized. Returns (R_co, t_co),
    the object in the camera."""
    h1, h2, h3 = H[:, 0], H[:, 1], H[:, 2]
    s = torch.sqrt(torch.linalg.norm(h1) * torch.linalg.norm(h2))
    s = torch.where(s > 1e-12, s, 1.0)
    sign = torch.where(h3[2] < 0, -1.0, 1.0)  # object in front of camera
    r1 = sign * h1 / s
    r2 = sign * h2 / s
    r3 = torch.linalg.cross(r1, r2)
    R = lie.normalize_rotation(torch.stack([r1, r2, r3], 1))
    return R, sign * h3 / s


# ---------------------------------------------------------------------------
# Sim3 refinement against several keyframes
# ---------------------------------------------------------------------------

def refine_object_sim3(R_wo, t_wo, s_wo, plane_xy, kf_R, kf_t, fx, fy, cx,
                       cy, obs_uv, obs_mask, iters: int = 8):
    """Gauss-Newton over the object's Sim3 tangent (Huber-weighted, LM
    diagonal damping) against its observations: plane_xy [N, 2], kf_R /
    kf_t [K, 3, 3] / [K, 3] world-to-camera, obs_uv [K, N, 2] pixels,
    obs_mask [K, N]. Returns (R, t, s, n_inliers)."""
    dev, f32 = plane_xy.device, plane_xy.dtype
    p_obj = torch.cat([plane_xy, torch.zeros_like(plane_xy[:, :1])], -1)
    eye7 = torch.eye(7, dtype=f32, device=dev)

    def residuals(zeta):                    # zeta [B, 7] -> ([B, M], ok)
        dR, dt, ds = lie.sim3_exp(zeta)
        R, t, s = lie.sim3_compose(R_wo, t_wo, s_wo, dR, dt, ds)
        pw = s[:, None, None] * (p_obj @ R.transpose(-1, -2)) + t[:, None]
        pc = torch.einsum("kij,bnj->bkni", kf_R, pw) + kf_t[None, :, None]
        z = torch.clamp(pc[..., 2], min=1e-6)
        u = fx * pc[..., 0] / z + cx
        v = fy * pc[..., 1] / z + cy
        r = torch.stack([u, v], -1) - obs_uv
        ok = obs_mask & (pc[..., 2] > 1e-4)
        r = torch.where(ok[..., None], r, 0.0)
        return r.reshape(r.shape[0], -1), ok

    zeta = torch.zeros(7, dtype=f32, device=dev)
    for _ in range(iters):
        J = jacobian(lambda z: residuals(z)[0], zeta)     # [M, 7]
        r = residuals(zeta[None])[0][0]
        chi2 = (r.reshape(-1, 2) ** 2).sum(-1)
        w = robust.huber_weight(chi2, CHI2_PLANE).repeat_interleave(2)
        H = J.T @ (w[:, None] * J)
        H = H + 1e-3 * torch.diag(torch.diagonal(H)) + 1e-6 * eye7
        zeta = zeta - torch.linalg.solve_ex(H, J.T @ (w * r))[0]
    dR, dt, ds = lie.sim3_exp(zeta)
    R, t, s = lie.sim3_compose(R_wo, t_wo, s_wo, dR, dt, ds)
    r, ok = residuals(zeta[None])
    chi2 = (r[0].reshape(-1, 2) ** 2).sum(-1)
    return R, t, s, ((chi2 < CHI2_PLANE) & ok[0].reshape(-1)).sum()


# ---------------------------------------------------------------------------
# Store + detection driver
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ObjectRecord:
    template: ObjectTemplate
    R_wo: np.ndarray | None = None    # object -> world
    t_wo: np.ndarray | None = None
    s_wo: float = 1.0
    detected: bool = False
    n_inliers: int = 0
    # per keyframe: kf_id -> (uv [N, 2], mask [N])
    obs: dict = dataclasses.field(default_factory=dict)

    def corners_world(self) -> np.ndarray | None:
        """The template corners in the world (None before detection)."""
        if not self.detected:
            return None
        c = np.concatenate([self.template.corners,
                            np.zeros((4, 1), np.float32)], -1)
        return (self.s_wo * c @ self.R_wo.T) + self.t_wo


class ObjectStore:
    """Every planar object of the map, with the detection pass run at each
    keyframe and the refinement run in the backend."""

    def __init__(self, cam: cam_mod.Camera, nn_ratio: float = 0.8,
                 device: str | torch.device = "cuda"):
        self.cam = cam
        self.objects: list[ObjectRecord] = []
        self.nn_ratio = nn_ratio
        self.device = resolve_device(device)
        self._generator = torch.Generator(device=self.device).manual_seed(0)

    def _t(self, a) -> torch.Tensor:
        a = np.ascontiguousarray(a)
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        return torch.from_numpy(a).to(self.device)

    def add_template(self, tpl: ObjectTemplate) -> int:
        self.objects.append(ObjectRecord(template=tpl))
        return len(self.objects) - 1

    def detect_in_frame(self, kp_xy: np.ndarray, desc: np.ndarray,
                        kp_mask: np.ndarray, R_cw: np.ndarray,
                        t_cw: np.ndarray, kf_id: int | None = None,
                        sigma2: float = 1.0):
        """Try every object against the frame's keypoints (host arrays)
        at pose (R_cw, t_cw); a detection sets the object's world pose and,
        with ``kf_id``, records the keyframe's observation. Returns the ids
        of the objects detected."""
        hits = []
        kp_desc = self._t(desc)
        kp_m = self._t(kp_mask)
        fx, fy, cx, cy = (float(v) for v in self.cam.params[:4])
        for oid, rec in enumerate(self.objects):
            tpl = rec.template
            n_tpl = len(tpl.desc)
            idx, _ = matching.match_nn_ratio(
                self._t(tpl.desc), kp_desc,
                torch.ones(n_tpl, dtype=torch.bool, device=self.device),
                kp_m, ratio=self.nn_ratio)
            idx = idx.cpu().numpy()
            ok_np = idx >= 0
            if int(ok_np.sum()) < MIN_MATCHES:
                continue
            uv = kp_xy[idx]
            pn = np.stack([(uv[:, 0] - cx) / fx, (uv[:, 1] - cy) / fy],
                          -1).astype(np.float32)
            H, inl, n_inl = ransac_plane_homography(
                self._t(tpl.plane_xy), self._t(pn), self._t(ok_np),
                sigma2 / fx ** 2, self._generator)
            n_inl = int(n_inl)
            if n_inl < MIN_INLIERS:
                continue
            R_co, t_co = pose_from_plane_homography(H)
            R_co, t_co = R_co.cpu().numpy(), t_co.cpu().numpy()
            R_wc = R_cw.T
            t_wc = -R_cw.T @ t_cw
            rec.R_wo = R_wc @ R_co
            rec.t_wo = R_wc @ t_co + t_wc
            rec.s_wo = rec.s_wo if rec.detected else 1.0
            rec.detected = True
            rec.n_inliers = n_inl
            if kf_id is not None:
                inl_np = inl.cpu().numpy()
                uv_full = np.zeros((n_tpl, 2), np.float32)
                m_full = np.zeros(n_tpl, bool)
                uv_full[inl_np] = uv[inl_np]
                m_full[inl_np] = True
                rec.obs[int(kf_id)] = (uv_full, m_full)
            hits.append(oid)
        return hits

    def refine(self, store, max_kfs: int = 8):
        """Refine every detected object's Sim3 against its (at most
        ``max_kfs`` latest) live observing keyframes."""
        fx, fy, cx, cy = (float(v) for v in self.cam.params[:4])
        for rec in self.objects:
            if not rec.detected or len(rec.obs) == 0:
                continue
            kf_ids = [k for k in sorted(rec.obs)[-max_kfs:]
                      if store.kf_mask[k]]
            if not kf_ids:
                continue
            uv = np.stack([rec.obs[k][0] for k in kf_ids])
            mask = np.stack([rec.obs[k][1] for k in kf_ids])
            R, t, s, n_inl = refine_object_sim3(
                self._t(np.asarray(rec.R_wo, np.float32)),
                self._t(np.asarray(rec.t_wo, np.float32)),
                torch.tensor(rec.s_wo, dtype=torch.float32,
                             device=self.device),
                self._t(rec.template.plane_xy), self._t(store.kf_R[kf_ids]),
                self._t(store.kf_t[kf_ids]), fx, fy, cx, cy, self._t(uv),
                self._t(mask))
            if int(n_inl) >= MIN_INLIERS // 2:
                rec.R_wo = R.cpu().numpy()
                rec.t_wo = t.cpu().numpy()
                rec.s_wo = float(s)
