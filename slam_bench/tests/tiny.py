"""A tiny copy of a cell for the CPU tests: the same files and keys at
320x240 with few features and a short session, in a directory of its
own (its own BENCHMARK.json, configs/, traffic/, metrics/ and limits/)."""

from __future__ import annotations

import json
import os
import shutil

from slam_bench import registry

BENCH = registry.HERE
ROOT = os.path.dirname(BENCH)

SMALL = {
    "Camera.fx": 260.45431, "Camera.fy": 260.503664, "Camera.cx": 162.570721,
    "Camera.cy": 124.850882, "Camera.width": 320, "Camera.height": 240,
    "Camera.bf": 20.0, "ORBextractor.nFeatures": 400,
    "ORBextractor.nLevels": 4, "Line.nLineFeatures": 32,
}


def _yaml_value(v):
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, str):
        return f'"{v}"'
    if isinstance(v, list):
        return "[" + ", ".join(_yaml_value(x) for x in v) + "]"
    return repr(v)


def write_yaml(path: str, d: dict):
    with open(path, "w") as f:
        f.write("%YAML:1.0\n")
        for k, v in d.items():
            f.write(f"{k}: {_yaml_value(v)}\n")


def make(tmp: str, cell: str = "tum2_rgbd.mapping", frames: int = 8,
         config_over: dict | None = None, limits: dict | None = None) -> str:
    """A tiny benchmark directory under ``tmp`` holding ``cell`` alone;
    returns its root (the bench directory is ``<root>/slam_bench``)."""
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    w = next(x for x in bench["workloads"] if x["name"] == cell)
    root = os.path.join(tmp, "root")
    bd = os.path.join(root, "slam_bench")
    for sub in ("configs", "traffic", "limits"):
        os.makedirs(os.path.join(bd, sub), exist_ok=True)
    shutil.copytree(os.path.join(BENCH, "metrics"), os.path.join(bd, "metrics"),
                    ignore=shutil.ignore_patterns("__pycache__"),
                    dirs_exist_ok=True)
    cfg = registry.load_config(BENCH, w["config"])
    n0 = cfg["Sequence.frames"]
    cfg.update(SMALL, **{"Sequence.frames": frames})
    cfg.update(config_over or {})
    write_yaml(os.path.join(bd, "configs", w["config"] + ".yaml"), cfg)
    tr = registry.load_traffic(BENCH, w["traffic"])
    if "laps" in tr["trajectory"]:
        # the same motion a frame as the cell's orbit
        tr["trajectory"]["laps"] *= frames / n0
    tr["scene"] = dict(tr["scene"], tex_size=1024)
    if "tex_scale" in tr["scene"]:
        tr["scene"]["tex_scale"] = 210.0
    tr["warmup_frames"] = min(tr["warmup_frames"], frames // 2)
    tr["profile_frames"] = [frames // 2, frames // 2 + 2]
    with open(os.path.join(bd, "traffic", w["traffic"] + ".json"), "w") as f:
        json.dump(tr, f)
    lim = registry.load_limits(BENCH, cell) if limits is None else limits
    with open(os.path.join(bd, "limits", cell + ".json"), "w") as f:
        json.dump(lim, f)
    bench["workloads"] = [w]
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root
