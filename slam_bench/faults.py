"""Faults planted in the timed path, to show that the check fails a broken
program (the CPU tests, and ``control.py --fault`` for the readings on the
card). Each patches a function of the program for the life of one run:
``install()`` before the run's own taps, ``remove()`` after it.

* ``pose_unchanged``: the pose solve returns its initial pose, a step that
  returns its state unchanged;
* ``k1_altered``: one entry of each K1 result is off by one, an answer
  altered where it is produced;
* ``k2_altered``: one cell of each K2 result carries another (valid)
  label;
* ``line_altered``: the start point of the first kept segment of each
  line extraction is moved by eight pixels;
* ``depth_scaled``: the RGB-D depth carries a 5% scale error (a unit slip)
  in the tracker's quantizer, where the map's points get their depth, and
  in the dense stage's insert, where the volume gets it.

A run has no batch whose mean the check takes and no exchange between
chips, so those two faults have no counterpart here.
"""

from __future__ import annotations

import numpy as np
import torch


class _Patch:
    module = ""
    attr = ""

    def _target(self):
        import importlib

        mod, _, cls = self.module.partition(":")
        target = importlib.import_module(mod)
        return getattr(target, cls) if cls else target

    def install(self):
        mod = self._target()
        self._orig = getattr(mod, self.attr)
        setattr(mod, self.attr, self.wrap(self._orig))

    def remove(self):
        setattr(self._target(), self.attr, self._orig)


class PoseUnchanged(_Patch):
    module = "plvs_tpu_torch.solvers.pose_opt"
    attr = "pose_optimize"

    def wrap(self, orig):
        def pose_optimize(cam, R0, t0, obs, *a, **kw):
            _, _, in_pts, in_lines, n = orig(cam, R0, t0, obs, *a, **kw)
            return R0, t0, in_pts, in_lines, n
        return pose_optimize


class K1Altered(_Patch):
    module = "plvs_tpu_torch.ops.hamming"
    attr = "hamming_matrix"

    def wrap(self, orig):
        def hamming_matrix(d1, d2):
            out = orig(d1, d2)
            if out.numel():
                out.view(-1)[0] += 1
            return out
        return hamming_matrix


class K2Altered(_Patch):
    module = "plvs_tpu_torch.ops.cc_labels"
    attr = "cc_min_labels"

    def wrap(self, orig):
        def cc_min_labels(init, conn_bits, *a, **kw):
            out = orig(init, conn_bits, *a, **kw)
            if out.numel():
                # cell 0 joins another component: label 0 or 1, both valid
                first = out.view(-1)[:1]
                first.copy_((first == 0).to(out.dtype))
            return out
        return cc_min_labels


class LineAltered(_Patch):
    module = "plvs_tpu_torch.features.lines"
    attr = "extract_lines"

    def wrap(self, orig):
        def extract_lines(img, max_lines=128, **kw):
            kl = orig(img, max_lines=max_lines, **kw)
            first = kl.mask.to(torch.int64).argmax()
            sp = kl.sp.clone()
            sp[first, 0] += 8.0
            return kl._replace(sp=sp)
        return extract_lines


class _QuantizerScaled(_Patch):
    module = "plvs_tpu_torch.slam.system"
    attr = "_quantize"

    def wrap(self, orig):
        def _quantize(gray, depth, dec=1):
            return orig(gray, np.asarray(depth, np.float32) * 1.05, dec)
        return _quantize


class _DenseScaled(_Patch):
    module = "plvs_tpu_torch.dense.mapping:DenseMapper"
    attr = "_insert_rgbd_core"

    def wrap(self, orig):
        def _insert_rgbd_core(mapper, kf_id, color, depth, Rcw, tcw):
            return orig(mapper, kf_id, color, depth * 1.05, Rcw, tcw)
        return _insert_rgbd_core


class DepthScaled:
    def __init__(self):
        self.parts = [_QuantizerScaled(), _DenseScaled()]

    def install(self):
        for p in self.parts:
            p.install()

    def remove(self):
        for p in reversed(self.parts):
            p.remove()


FAULTS = {"pose_unchanged": PoseUnchanged, "k1_altered": K1Altered,
          "k2_altered": K2Altered, "line_altered": LineAltered,
          "depth_scaled": DepthScaled}
