"""How well float32 resolves the bundle-adjustment windows the parity tests
compare, and where the CG loop stops.

    JAX_PLATFORMS=cpu python scripts/ba_conditioning.py

CPU only. Part 1 solves two synthetic windows (6 cameras along a 1.5 m
track, 2 fixed, 300 points each seen at least twice) with the port's
``bundle_adjust`` in float32 and in float64, one LM iteration of one CG
step, and prints the largest point difference: a mono window 4-10 m ahead
(tests/test_solvers.py's depths) and an RGB-D-like one 2-5 m ahead with
stereo rows. Part 2 runs the JAX System over tests/test_torch_local_mapping
.py's 16 frames with the keyframe backend and, for each local-BA problem
its mapper built, prints the JAX solver's result padded (as the mapper
pads it) against unpadded, the largest point and line-endpoint
differences, and the CG iterations the port's solver runs on it in float32
and in float64 at 5 LM x 14 CG. One JSON line.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _window(torch, tba, lie, depth, stereo, seed=0):
    rng = np.random.default_rng(seed)
    K, P = 6, 300
    X = np.stack([rng.uniform(-2, 2, P), rng.uniform(-1.5, 1.5, P),
                  rng.uniform(*depth, P)], -1).astype(np.float32)
    so3 = lambda s: lie.so3_exp(torch.from_numpy(  # noqa: E731
        (rng.normal(size=3) * s).astype(np.float32))).numpy()
    R = np.stack([so3(0.05) for _ in range(K)])
    t = (np.stack([[-0.3 * k, 0, 0] for k in range(K)])
         + rng.normal(size=(K, 3)) * 0.02).astype(np.float32)
    rows = []
    for k in range(K):
        Xc = X @ R[k].T + t[k]
        uv = Xc[:, :2] / Xc[:, 2:] * 520.0 + np.array([320.0, 240.0])
        for i in np.nonzero((uv[:, 0] >= 0) & (uv[:, 0] < 640)
                            & (uv[:, 1] >= 0) & (uv[:, 1] < 480)
                            & (rng.uniform(size=P) > 0.3))[0]:
            u = uv[i] + rng.normal(size=2) * 0.3
            rows.append((k, i, u[0], u[1],
                         u[0] - 40.0 / Xc[i, 2] if stereo else -1.0))
    rows = np.asarray(rows)
    rows = rows[np.bincount(rows[:, 1].astype(int), minlength=P)[
        rows[:, 1].astype(int)] >= 2]
    for k in range(2, K):
        R[k] = so3(0.01) @ R[k]
        t[k] += (rng.normal(size=3) * 0.03).astype(np.float32)

    def t_(a, dt=None):
        return torch.from_numpy(np.ascontiguousarray(a, dt))

    return tba.make_problem(
        t_(R), t_(t), t_(np.arange(K) < 2),
        t_(X + rng.normal(size=(P, 3)).astype(np.float32) * 0.05),
        t_(rows[:, 0], np.int64), t_(rows[:, 1], np.int64),
        t_(rows[:, 2:5], np.float32), t_(np.ones(len(rows), np.float32)),
        t_(np.ones(len(rows), bool)))


def _f64(prob):
    return type(prob)(*(a.double() if a.is_floating_point() else a
                        for a in prob))


def main() -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import torch

    from plvs_tpu.geometry import cameras as jcam
    from plvs_tpu.io import synthetic as jsyn
    from plvs_tpu.slam import System, SystemConfig
    from plvs_tpu.solvers import ba as jba
    from plvs_tpu_torch import convert
    from plvs_tpu_torch.geometry import cameras, lie
    from plvs_tpu_torch.solvers import ba as tba

    out = {}
    cam = cameras.pinhole(520.0, 520.0, 320.0, 240.0, width=640, height=480,
                          bf=40.0)
    for name, depth, stereo in (("mono_4_10m", (4.0, 10.0), False),
                                ("rgbd_2_5m", (2.0, 5.0), True)):
        prob = _window(torch, tba, lie, depth, stereo)
        p32 = tba.bundle_adjust(cam, prob, num_iters=1, cg_iters=1)[2]
        p64 = tba.bundle_adjust(cam, _f64(prob), num_iters=1, cg_iters=1)[2]
        out[name + "_f32_vs_f64_points_m"] = float(
            (p32.double() - p64).abs().max())

    # part 2: the local-BA problems of a JAX run with the backend on
    cam_args, cam_kw = (300.0, 300.0, 160.0, 120.0), dict(width=320,
                                                         height=240, bf=24.0)
    jc = jcam.pinhole(*cam_args, **cam_kw)
    system = System(jc, SystemConfig(
        num_features=512, n_levels=4, max_kf=64, max_pts=16384,
        use_lines=True, max_lines=64, local_ba=True, loop_closing=False,
        pipelined=False, depth_upload_decimation=2, backend_fixed_shapes=True,
        max_kf_interval=3))
    problems = []
    gather = system.local_mapper._gather_ba

    def keep(window):
        packed = gather(window)
        if packed is not None:
            problems.append(packed)
        return packed

    system.local_mapper._gather_ba = keep
    tex = jsyn.make_structured_texture(1024, rng=np.random.default_rng(7))
    scene = jsyn.SyntheticRGBD(jc, wall_z=3.0, texture=tex, tex_scale=220.0)
    for ts, g, d, _, _ in scene.sequence(jsyn.default_trajectory(36)[:16]):
        system.track_rgbd(g, d, ts)
    tcam = convert.camera_from_numpy(jc.kind, np.asarray(jc.params),
                                     jc.width, jc.height, jc.bf)
    rows = []
    for prob, cams, pts, lns, _, K in problems:
        f = {k: np.asarray(getattr(prob, k)) for k in prob._fields}
        n = dict(R=K, t=K, fixed_cam=K, cam_mask=K, points=len(pts),
                 point_mask=len(pts), lines_Xs=len(lns), lines_Xe=len(lns),
                 line_mask=len(lns))
        m, ml = int(f["obs_mask"].sum()), int(f["lobs_mask"].sum())
        cut = {k: f[k][: n.get(k, ml if k.startswith("lobs") else m)]
               for k in f}
        padded = jba.bundle_adjust_jit(jc, prob, num_iters=5, cg_iters=14,
                                       scatter_free=True)
        plain = jba.bundle_adjust_jit(
            jc, jba.make_problem(**{k: jnp.asarray(v) for k, v in
                                    cut.items()}),
            num_iters=5, cg_iters=14, scatter_free=True)
        tprob = convert.ba_problem_from_numpy(cut, device="cpu")
        cg = [int(tba.bundle_adjust(tcam, p, num_iters=5, cg_iters=14)[5][
            "cg_iters"]) for p in (tprob, _f64(tprob))]
        rows.append({
            "cameras": int(K), "points": len(pts), "lines": len(lns),
            "jax_padded_vs_unpadded_points_m": float(np.abs(
                np.asarray(padded[2])[: len(pts)]
                - np.asarray(plain[2])).max()),
            "jax_padded_vs_unpadded_line_ends_m": float(np.abs(
                np.asarray(padded[3])[: len(lns)]
                - np.asarray(plain[3])).max()) if len(lns) else 0.0,
            "port_cg_iters_f32": cg[0], "port_cg_iters_f64": cg[1]})
    out["local_ba_windows"] = rows
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
