"""The line detector on the images the benchmark's cells feed it, held to
the benchmark's frozen plain detector (``slam_bench/reference/lines.py``).

The RGB-D cell's frames reach ``features.lines.extract_lines`` as
``System.track_rgbd`` sends them: gray quantised to u8 by
``slam/system._quantize`` and made float32 on the device
(``tracking._decompress_packed``). The stereo cell's left and right images
reach it float32 as rendered, at EuRoC's 752x480. Program and reference
run the same float32 operations on the same device (the CPU here), so no
slot may hold a segment on one side only and every endpoint agrees within
1e-3 px: a change to the detector's arithmetic, or to how the RGB-D gray
reaches it, shows here before a card reads the cells' line check.
"""

import numpy as np
import pytest
import torch

from plvs_tpu_torch.features import lines
from plvs_tpu_torch.slam.system import _quantize
from plvs_tpu_torch.slam.tracking import _decompress_packed
from slam_bench import registry, traffic
from slam_bench.reference import lines as ref_lines

MAX_LINES = 100      # Line.nLineFeatures of both configurations
GAP_PX = 1e-3
SEED = 646008436     # the read-noise draw of a benchmark run
RGBD_FRAMES = (0, 13, 27, 39)
STEREO_FRAME = 20


@pytest.fixture(scope="module")
def rgbd_session():
    cfg = registry.load_config(registry.HERE, "tum2_rgbd")
    return traffic.build_session(registry.load_traffic(registry.HERE,
                                                       "wall_sweep"),
                                 cfg, SEED)


@pytest.fixture(scope="module")
def stereo_pair():
    """One pair of the stereo cell's room orbit, rendered as
    ``traffic.build_session`` renders it (read noise left out)."""
    cfg = registry.load_config(registry.HERE, "euroc_stereo")
    mix = registry.load_traffic(registry.HERE, "room_orbit")
    cam = traffic.camera(cfg)
    scene = traffic.make_scene(mix["scene"], cam)
    R, t = traffic.make_trajectory(mix["trajectory"],
                                   int(cfg["Sequence.frames"]))[STEREO_FRAME]
    left, _ = scene.render(R, t)
    right, _ = scene.render(R, t - np.array([cam.baseline, 0, 0],
                                            np.float32))
    return left, right


def _held_to_reference(img: torch.Tensor):
    kl = lines.extract_lines(img, max_lines=MAX_LINES)
    gaps, differ = ref_lines.compare(img, MAX_LINES, kl.sp, kl.ep, kl.mask)
    assert int(kl.mask.sum()) >= 10
    assert differ == 0
    assert len(gaps) and gaps.max() < GAP_PX, np.sort(gaps)[-5:]


@pytest.mark.parametrize("i", RGBD_FRAMES)
def test_rgbd_gray_as_track_rgbd_sends_it(rgbd_session, i):
    _, gray, depth = rgbd_session.frames[i]
    g8, d16 = _quantize(gray, depth)
    img, _ = _decompress_packed(torch.from_numpy(g8),
                                torch.from_numpy(d16.astype(np.int32)))
    assert img.dtype == torch.float32 and img.shape == (480, 640)
    _held_to_reference(img)


@pytest.mark.parametrize("side", [0, 1])
def test_stereo_images_at_euroc_width(stereo_pair, side):
    img = torch.from_numpy(np.ascontiguousarray(stereo_pair[side],
                                                np.float32))
    assert img.shape == (480, 752)
    _held_to_reference(img)
