"""The comparison that decides ``correct``.

What the window produced is read after it closes and held against the
reference:

* each complete session's trajectory, as the port exports it, against the
  ground-truth camera centres the benchmark rendered (SE3 Umeyama alignment
  per session): ``ate_mm`` pooled over the sessions, ``ate_mm_max`` of the
  worst session;
* each complete session's live map points and line endpoints, carried into
  the ground-truth frame through the session's first frame (its exported
  pose and its true one), against the scene's surfaces (the wall plane, or
  the room's walls): the median and the 90th percentile of their
  distances, of the worst session (``points_p50_mm``, ``lines_p50_mm``;
  ``*_p90_mm`` beside them);
* the vertices of the last complete session's dense mesh, likewise
  (``mesh_p50_mm``, ``mesh_p90_mm``);
* K1 and K2 at the window's own inputs: a seeded sample of launches, their
  outputs against the plain versions of ``kernels.py``, compared exactly
  (``k1_wrong``, ``k2_wrong``: entries that differ);
* the line detector at the window's own images: a seeded sample of
  ``extract_lines`` calls, the segments against the frozen plain detector
  of ``lines.py``: the slots that hold a segment on one side only
  (``keyline_slots_differ``), and the endpoint gaps in pixels of the
  segments both hold (``keyline_gap_px`` the widest, ``keyline_gap_p50_px``
  the median).

Each number is held to its limit in ``limits/<cell>.json``; a number the
run could not read (no complete session) fails.
"""

from __future__ import annotations

import math

import numpy as np

from . import evaluation, kernels
from . import lines as ref_lines


def _pct_mm(dist: np.ndarray, q: float):
    return float(np.percentile(dist, q) * 1e3) if len(dist) else None


def session_readings(item: dict, session) -> dict:
    """The numbers of one complete session (mm, counts)."""
    gt = session.centres
    traj = item["traj"]
    out = {"frames": len(traj), "not_ok": item["not_ok"]}
    if len(traj) != len(gt):
        out["ate_err"] = None
        return out
    err, _ = evaluation.aligned_errors(traj[:, 1:4], gt)
    out["ate_err"] = err
    scene = session.scene
    R, t = evaluation.first_frame_transform(traj[0], *session.poses[0])

    def surf(pts):
        if pts is None or len(pts) == 0:
            return np.zeros(0)
        return scene.surface_distance(pts @ R.T + t)

    for key, pts in (("points", item["points"]), ("lines", item["lines"]),
                     ("mesh", item.get("mesh"))):
        if pts is None:
            continue
        d = surf(pts)
        out[key + "_p90_mm"] = _pct_mm(d, 90)
        out[key + "_p50_mm"] = _pct_mm(d, 50)
    out["ate_err_max_mm"] = float(err.max() * 1e3)
    out["n_points"] = len(item["points"])
    out["n_lines"] = len(item["lines"]) // 2
    return out


def kernel_wrong(samples: dict) -> dict:
    """Entries of the sampled launches' outputs that differ from the plain
    versions, and the line extractions' widest endpoint gap to the
    reference detector (None where nothing was sampled)."""
    out = {}
    k1 = samples.get("k1", [])
    out["k1_wrong"] = (sum(int((kernels.hamming(d1, d2) != got).sum())
                           for (d1, d2, got), _ in k1) if k1 else None)
    k2 = samples.get("k2", [])
    out["k2_wrong"] = (sum(int((kernels.cc_min_labels(
        init.cpu().numpy(), conn.cpu().numpy()) != got.cpu().numpy()).sum())
        for (init, conn, got), _ in k2) if k2 else None)
    ln = samples.get("lines", [])
    if ln:
        res = [ref_lines.compare(img, n, sp, ep, mask)
               for (img, sp, ep, mask), n in ln]
        gaps = np.concatenate([r[0] for r in res])
        out["keyline_gap_px"] = float(gaps.max()) if len(gaps) else 0.0
        out["keyline_gap_p50_px"] = (float(np.median(gaps)) if len(gaps)
                                     else 0.0)
        out["keyline_slots_differ"] = sum(r[1] for r in res)
    for kind in ("k1", "k2", "lines"):
        out[kind + "_sampled"] = len(samples.get(kind, []))
    return out


def readings(outputs: list, session, samples: dict) -> dict:
    """Every number the check compares, over the window's complete
    sessions."""
    per = [session_readings(item, session) for item in outputs]
    r = {"sessions": len(per)}
    errs = [p["ate_err"] for p in per if p.get("ate_err") is not None]
    if per and len(errs) == len(per):
        r["ate_mm"] = evaluation.pooled_rmse(errs) * 1e3
        r["ate_mm_max"] = max(float(np.sqrt((e ** 2).mean())) * 1e3
                              for e in errs)
    for key in ("points_p90_mm", "lines_p90_mm", "mesh_p90_mm",
                "points_p50_mm", "lines_p50_mm", "mesh_p50_mm",
                "ate_err_max_mm", "n_points", "n_lines"):
        vals = [p[key] for p in per if p.get(key) is not None]
        if vals:
            r[key] = max(vals)
    r["not_ok"] = sum(p["not_ok"] for p in per)
    r.update(kernel_wrong(samples))
    return r


def judge(read: dict, limits: dict):
    """(correct, checks): ``checks`` maps each compared number's name to
    its value and limit; a number over its limit, or missing, fails."""
    checks = {}
    ok = True
    for name, limit in limits.items():
        v = read.get(name)
        good = v is not None and math.isfinite(v) and v <= limit
        ok = ok and good
        checks[name] = {"value": v, "limit": limit}
    return ok, checks
