"""One frame of the per-frame RGB-D program in both packages, against the
same map: the JAX System tracks the first frames and builds the map, the
map and camera are carried across with ``plvs_tpu_torch.convert``, and the
port's tracker (same state) tracks the next frame against it.

Two cases:

* the port is fed the JAX package's own ``Frame`` / ``FrameLines``, so the
  only difference is the matching + pose-solve program;
* the port builds its own frame from the same quantized planes (the whole
  ``_frame_track_rgbd_pl``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plvs_tpu.geometry import cameras as jcam
from plvs_tpu.slam import System as JSystem, SystemConfig as JConfig
from plvs_tpu.slam import system as jsystem
from plvs_tpu.slam import tracking as jtracking
from plvs_tpu_torch import convert
from plvs_tpu_torch.geometry import cameras as tcam
from plvs_tpu_torch.io import synthetic as tsyn
from plvs_tpu_torch.slam import system as tsystem
from plvs_tpu_torch.slam import tracking as ttracking

CAM_ARGS = (300.0, 300.0, 160.0, 120.0)
CAM_KW = dict(width=320, height=240, bf=24.0)
FLAGS = dict(num_features=512, n_levels=4, max_kf=64, max_pts=16384,
             use_lines=True, max_lines=64, local_ba=False,
             loop_closing=False, dense_mapping=False, pipelined=False,
             depth_upload_decimation=2)
N_WARM = 3   # frames the JAX System tracks before the compared frame

# tracker state that _assemble_fused and the fused program read
_STATE = ("state", "R", "t", "vel_R", "vel_t", "last_kp_pt_id", "ref_kf",
          "ref_kf_npts", "frames_since_kf", "frame_id", "scale", "n_levels",
          "max_keylines", "depth_decimation", "fixed_shapes",
          "check_rotation", "line_track_weight", "local_pts_cap",
          "local_lines_cap", "only_tracking")


def _to_torch(x):
    """JAX NamedTuple -> the port's NamedTuple of CPU tensors (descriptor
    words uint32 -> their int32 bit patterns)."""
    if isinstance(x, tuple):
        return type(x)(*(_to_torch(v) for v in x))
    a = np.array(x)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a)


def _port_types(jfr, jfl):
    from plvs_tpu_torch.features import lines, orb
    from plvs_tpu_torch.slam import frame

    kp = orb.Keypoints(*_to_torch(jfr.kp))
    fr = frame.Frame(kp, *(_to_torch(v) for v in jfr[1:]))
    kl = lines.KeyLines(*_to_torch(jfl.kl))
    fl = frame.FrameLines(kl, *(_to_torch(v) for v in jfl[1:]))
    return fr, fl


@pytest.fixture(scope="module")
def case():
    cam_j = jcam.pinhole(*CAM_ARGS, **CAM_KW)
    tex = tsyn.make_structured_texture(1024, rng=np.random.default_rng(7))
    scene = tsyn.SyntheticRGBD(tcam.pinhole(*CAM_ARGS, **CAM_KW), wall_z=3.0,
                               texture=tex, tex_scale=220.0)
    frames = list(scene.sequence(tsyn.default_trajectory(36)[:N_WARM + 1]))
    jsys = JSystem(cam_j, JConfig(**FLAGS))
    for ts, g, d, _, _ in frames[:N_WARM]:
        jsys.track_rgbd(g, d, ts)
    jtr = jsys.tracker
    assert jtr.state == jtracking.OK

    ts, g, d, _, _ = frames[N_WARM]
    h, w = g.shape
    dec = FLAGS["depth_upload_decimation"]
    ctx = jtr._prepare_fused_packed(jsystem._pack_rgbd(g, d, dec), h, w, ts)
    asm = ctx["asm"]
    out, jfr, jfl = jtracking._frame_track_rgbd_pl(
        cam_j, jnp.asarray(ctx["buf"][None]), 0, asm["pt_tbl"],
        asm["ln_tbl"], h=h, w=w, num_features=jtr.num_features,
        n_levels=jtr.n_levels, scale=jtr.scale, max_lines=jtr.max_keylines,
        icap=asm["icap"], lcap=asm["lcap"],
        line_weight=jtr.line_track_weight,
        check_rotation=jtr.check_rotation, prior_info=None, dec=dec)
    jres = jtracking._unpack_track_out(np.asarray(out), jtr.num_features,
                                       jtr.max_keylines)

    # the port's tracker over the carried-across map, in the same state
    cam_t = convert.camera_from_numpy(cam_j.kind, np.asarray(cam_j.params),
                                      cam_j.width, cam_j.height, cam_j.bf)
    store = convert.map_store_from_numpy(vars(jsys.store))
    ttr = ttracking.Tracker(cam_t, store, num_features=jtr.num_features,
                            use_lines=True, device="cpu")
    for name in _STATE:
        setattr(ttr, name, getattr(jtr, name))
    tasm = ttr._assemble_fused(True)
    return dict(jres=jres, asm=asm, tasm=tasm, ttr=ttr, jfr=jfr, jfl=jfl,
                planes=tsystem._pack_rgbd(g, d, dec))


def _run_port(case, own_frame: bool):
    ttr, tasm = case["ttr"], case["tasm"]
    meta = torch.from_numpy(tasm["meta"])
    if own_frame:
        g8, d16 = case["planes"]
        out, _, _ = ttracking._frame_track_rgbd_pl(
            ttr.cam, torch.from_numpy(g8), torch.from_numpy(
                d16.astype(np.int32)), meta, tasm["pt_tbl"], tasm["ln_tbl"],
            num_features=ttr.num_features, n_levels=ttr.n_levels,
            scale=ttr.scale, max_lines=ttr.max_keylines, icap=tasm["icap"],
            lcap=tasm["lcap"], line_weight=ttr.line_track_weight,
            check_rotation=ttr.check_rotation)
    else:
        fr, fl = _port_types(case["jfr"], case["jfl"])
        out = ttracking._track_frame_tables(
            ttr.cam, meta, tasm["pt_tbl"], tasm["ln_tbl"], fr, fl,
            tasm["icap"], tasm["lcap"], ttr.scale, ttr.line_track_weight,
            ttr.check_rotation)
    return ttracking._unpack_track_out(out.numpy(), ttr.num_features,
                                       ttr.max_keylines)


def test_carried_map_assembles_the_same_program_input(case):
    """Same map and state -> the same candidate ids, buckets and predicted
    pose bits (exact: host-side integer and float32 bookkeeping)."""
    asm, tasm = case["asm"], case["tasm"]
    assert (tasm["icap"], tasm["lcap"]) == (asm["icap"], asm["lcap"])
    np.testing.assert_array_equal(tasm["meta"], asm["meta"])
    for j, t in zip(asm["pt_tbl"], tasm["pt_tbl"]):
        a = np.asarray(j)
        np.testing.assert_array_equal(
            t.numpy(), a.view(np.int32) if a.dtype == np.uint32 else a)


@pytest.mark.parametrize("own_frame", [False, True])
def test_one_frame_pose_and_counts(case, own_frame):
    """Pose within 1e-4 rad / 1e-4 m and inlier counts within +-2 of the
    JAX program. Both solve the same normal equations in float32 with sums
    in another order (einsum vs XLA reductions), so the poses agree to a
    few ulps of the 6-vector steps, not bit for bit; a borderline chi2
    inlier may flip, hence the count slack. With its own frame the port's
    keyline endpoints differ by ~1e-3 px (see test_torch_features), which
    stays inside the same bounds."""
    R, t, n1, n2, kp, kl = _run_port(case, own_frame)
    Rj, tj, n1j, n2j, kpj, klj = case["jres"]
    cos = np.clip((np.trace(R @ Rj.T) - 1.0) / 2.0, -1.0, 1.0)
    assert np.arccos(cos) < 1e-4, (R, Rj)
    assert np.abs(t - tj).max() < 1e-4, (t, tj)
    assert abs(n1 - n1j) <= 2 and abs(n2 - n2j) <= 2, (n1, n1j, n2, n2j)
    assert n2j > 100
    # associations: the same keypoint -> candidate rows, up to the flips
    # the count slack allows
    assert (kp != kpj).sum() <= 2 and (kl != klj).sum() <= 2
