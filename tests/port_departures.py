"""The port's departures from the JAX package's line landmarks, given to
the JAX package at run time for the parity tests (functions wrapped,
nothing edited; each context manager restores on exit).

The port's stereo line builder matches left and right lines under a
disparity gate, a mutual check and a photometric check
(``frame.build_frame_lines_stereo``), and its backend makes a triangulated
line only where ``local_mapping._verify_lines`` passes it; their
docstrings say why. A parity test that runs both packages over the same
frames gives the JAX package the same departures, so that what it
compares is what the departures do not touch."""

import contextlib

import jax.numpy as jnp
import numpy as np
import torch

from plvs_tpu.geometry import cameras as jcam
from plvs_tpu.slam import frame as jframe
from plvs_tpu.slam import local_mapping as jlocal_mapping
from plvs_tpu_torch import convert
from plvs_tpu_torch.slam import frame as tframe
from plvs_tpu_torch.slam import local_mapping as tlocal_mapping


def _port_camera(cam):
    """The port's camera of a JAX camera."""
    return convert.camera_from_numpy(cam.kind, np.asarray(cam.params),
                                     cam.width, cam.height, cam.bf)


@contextlib.contextmanager
def port_stereo_line_depths():
    """The JAX package's stereo line builder with the port's endpoint
    depths: its own keylines, the depths of the port's builder on the same
    images, back-projected as the JAX builder back-projects its own."""
    build = jframe.build_frame_lines_stereo

    def build_frame_lines_stereo(gray_l, gray_r, cam, max_lines=128, **kw):
        fl = build(gray_l, gray_r, cam, max_lines, **kw)
        tl = tframe.build_frame_lines_stereo(
            torch.from_numpy(np.asarray(gray_l)),
            torch.from_numpy(np.asarray(gray_r)), _port_camera(cam),
            max_lines)
        ds, de = (jnp.asarray(d.numpy()) for d in (tl.depth_s, tl.depth_e))
        return fl._replace(depth_s=ds, depth_e=de,
                           Xs_cam=jcam.backproject(cam, fl.kl.sp, ds),
                           Xe_cam=jcam.backproject(cam, fl.kl.ep, de))

    jframe.build_frame_lines_stereo = build_frame_lines_stereo
    try:
        yield
    finally:
        jframe.build_frame_lines_stereo = build


@contextlib.contextmanager
def port_line_checks():
    """The JAX mapper with the port's line checks: each
    ``LocalMapper._apply_new_lines`` keeps only the triangulated lines the
    port's ``_verify_lines`` passes, computed from the JAX run's own
    matches, endpoints and store."""
    apply = jlocal_mapping.LocalMapper._apply_new_lines

    def _apply_new_lines(self, kf_id, ctx, fetched):
        idx_b, Xs_b, Xe_b, ok_b = (np.asarray(a) for a in fetched)
        st, nbs = self.store, ctx["nbs"]
        n = len(nbs)   # the JAX mapper pads to its neighbour count
        ic = np.maximum(idx_b[:n], 0)[..., None]
        t = torch.from_numpy
        ok = tlocal_mapping._verify_lines(
            _port_camera(self.cam), t(st.kf_R[nbs]), t(st.kf_t[nbs]),
            t(np.take_along_axis(st.kf_kl_sp[nbs], ic, 1)),
            t(np.take_along_axis(st.kf_kl_ep[nbs], ic, 1)),
            t(idx_b[:n].astype(np.int64)), t(Xs_b[:n]), t(Xe_b[:n]))
        ok_b = ok_b.copy()
        ok_b[:n] &= ok.numpy()
        return apply(self, kf_id, ctx, (idx_b, Xs_b, Xe_b, ok_b))

    jlocal_mapping.LocalMapper._apply_new_lines = _apply_new_lines
    try:
        yield
    finally:
        jlocal_mapping.LocalMapper._apply_new_lines = apply
