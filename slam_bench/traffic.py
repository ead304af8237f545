"""The one traffic generator: a mix's parameters, a configuration's camera
and a seed give a session of frames with their ground truth.

A mix (``traffic/<mix>.json``) names a scene, a trajectory, the mode, the
feed and the read noise; the configuration gives the camera and the
session's length (``Sequence.frames``, a cut of the deployment's sequence
length that its ``Bench.reduced`` lists). The session is the trajectory's
frames, rendered once at set-up.

The scene, its texture and the trajectory are the mix's and the same for
every seed, so every seed gets the same work; the seed draws the read noise
added to each image (``noise.gray_sigma`` grey levels).

Scenes: ``wall`` (a textured wall at ``wall_z``, bench.py's structured
texture drawn with ``default_rng(tex_seed)``) and ``room`` (four textured
walls at +-``half``, textures from ``default_rng(tex_seed + i)``).
Trajectories: ``sweep`` (``default_trajectory``) and ``orbit``
(``orbit_loop_trajectory``). A stereo configuration gets a rectified pair:
the left image at the pose, the right one baseline along the camera's x
axis.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from . import scenes

MODES = ("mapping",)
FEEDS = ("closed",)


@dataclasses.dataclass
class Session:
    """One session's frames: ``frames[i]`` = (timestamp, a, b) where (a, b)
    is (gray, depth metres) for RGB-D and (left, right) for stereo;
    ``poses[i]`` = the ground-truth world-to-camera (R, t)."""

    sensor: str
    frames: list
    poses: list
    scene: object
    fps: float

    @property
    def centres(self) -> np.ndarray:
        """[N, 3] ground-truth camera centres."""
        return np.stack([-R.T @ t for R, t in self.poses]).astype(np.float64)


def camera(config: dict) -> scenes.Pinhole:
    return scenes.Pinhole(
        fx=float(config["Camera.fx"]), fy=float(config["Camera.fy"]),
        cx=float(config["Camera.cx"]), cy=float(config["Camera.cy"]),
        width=int(config["Camera.width"]), height=int(config["Camera.height"]),
        bf=float(config.get("Camera.bf", 0.0)))


def make_scene(spec: dict, cam: scenes.Pinhole):
    kind = spec["kind"]
    tex_seed = int(spec["tex_seed"])
    if kind == "wall":
        tex = scenes.make_structured_texture(
            int(spec["tex_size"]), rng=np.random.default_rng(tex_seed))
        return scenes.SyntheticRGBD(cam, tex, wall_z=float(spec["wall_z"]),
                                    tex_scale=float(spec["tex_scale"]))
    if kind == "room":
        return scenes.SyntheticRoom(cam, half=float(spec["half"]),
                                    tex_size=int(spec["tex_size"]),
                                    seed=tex_seed)
    raise ValueError(f"unknown scene kind {kind!r}")


def make_trajectory(spec: dict, frames: int):
    kind = spec["kind"]
    if kind == "sweep":
        return scenes.default_trajectory(frames)
    if kind == "orbit":
        return scenes.orbit_loop_trajectory(
            frames, radius=float(spec["radius"]),
            wobble=float(spec.get("wobble", 0.05)),
            laps=float(spec.get("laps", 1.0)))
    raise ValueError(f"unknown trajectory kind {kind!r}")


def build_session(traffic: dict, config: dict, seed: int) -> Session:
    if traffic.get("mode") not in MODES:
        raise ValueError(f"unknown mode {traffic.get('mode')!r}")
    if traffic.get("feed") not in FEEDS:
        raise ValueError(f"unknown feed {traffic.get('feed')!r}")
    sensor = config["Bench.sensor"]
    cam = camera(config)
    scene = make_scene(traffic["scene"], cam)
    poses = make_trajectory(traffic["trajectory"],
                            int(config["Sequence.frames"]))
    fps = float(config.get("Camera.fps", 30.0))
    shift = np.array([cam.baseline, 0.0, 0.0], np.float32)
    rng = np.random.default_rng(abs(int(seed)))
    sigma = float(traffic.get("noise", {}).get("gray_sigma", 0.0))

    def noisy(img):
        if sigma <= 0:
            return img
        return img + rng.normal(0.0, sigma, img.shape).astype(np.float32)

    frames = []
    for i, (R, t) in enumerate(poses):
        if sensor == "rgbd":
            gray, depth = scene.render(R, t)
            frames.append((i / fps, noisy(gray), depth))
        elif sensor == "stereo":
            left, _ = scene.render(R, t)
            right, _ = scene.render(R, t - shift)
            frames.append((i / fps, noisy(left), noisy(right)))
        else:
            raise ValueError(f"unknown sensor {sensor!r}")
    return Session(sensor=sensor, frames=frames, poses=poses, scene=scene,
                   fps=fps)
