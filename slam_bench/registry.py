"""Find a cell's pieces by name: its configuration, its traffic mix, its
per-layer metric readers and its limits.

Everything that belongs to one configuration, one traffic mix or one
per-layer metric sits in a file of its own, found here by the name that
``BENCHMARK.json`` gives it, so a later change adds a cell by adding files:

* ``configs/<config>.yaml``: the PLVS settings keys copied from the source
  (the System is built from this file as ``run_slam --settings`` builds
  it), ``SystemConfig.<field>`` runtime settings the settings format cannot
  state, and ``Bench.*`` keys (source, reduced, assumed, sensor, precision);
* ``traffic/<mix>.json``: scene, trajectory, session length, mode, feed;
* ``metrics/<metric>.py``: one reader per per-layer metric;
* ``limits/<cell>.json``: the limits of the cell's correctness check.

This module imports only the standard library.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import re

HERE = os.path.dirname(os.path.abspath(__file__))


def _scalar(v: str):
    v = v.strip()
    if len(v) >= 2 and v[0] == v[-1] and v[0] in "\"'":
        return v[1:-1]
    if re.fullmatch(r"[-+]?\d+", v):
        return int(v)
    try:
        return float(v)
    except ValueError:
        pass
    low = v.lower()
    if low in ("true", "on", "yes"):
        return True
    if low in ("false", "off", "no"):
        return False
    return v


def read_flat_yaml(path: str) -> dict:
    """The flat ``Key.Sub: value`` subset of OpenCV FileStorage YAML that
    the settings files use: scalars, quoted strings and one-line
    ``[a, b]`` lists; comments and the ``%YAML:1.0`` header are skipped."""
    out = {}
    with open(path) as f:
        for raw in f:
            line = raw.rstrip("\n")
            if not line.strip() or line.lstrip().startswith(("#", "%", "---")):
                continue
            m = re.match(r"\s*([A-Za-z0-9_.]+)\s*:\s*(.*)$", line)
            if not m:
                raise ValueError(f"{path}: cannot read line {line!r}")
            key, val = m.group(1), m.group(2).strip()
            if val.startswith("["):
                if not val.endswith("]"):
                    raise ValueError(f"{path}: {key}: a list ends on its line")
                items = re.findall(r'"[^"]*"|\'[^\']*\'|[^,\s][^,]*',
                                   val[1:-1])
                out[key] = [_scalar(x) for x in items]
            else:
                if " #" in val and not val.startswith(("\"", "'")):
                    val = val.split(" #", 1)[0]
                out[key] = _scalar(val)
    return out


@dataclasses.dataclass
class Metric:
    """A per-layer metric: its entry in BENCHMARK.json and its reader."""

    name: str
    unit: str
    layer: str
    source: str
    moves: str
    read: object  # fn(ctx) -> float | None


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    config_path: str
    config: dict
    traffic_name: str
    traffic: dict
    chips: int
    end_to_end: list
    metrics: list
    limits: dict


def load_benchmark(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def config_path(bench_dir: str, name: str) -> str:
    return os.path.join(bench_dir, "configs", name + ".yaml")


def load_config(bench_dir: str, name: str) -> dict:
    return read_flat_yaml(config_path(bench_dir, name))


def load_traffic(bench_dir: str, name: str) -> dict:
    with open(os.path.join(bench_dir, "traffic", name + ".json")) as f:
        return json.load(f)


def load_limits(bench_dir: str, cell: str) -> dict:
    with open(os.path.join(bench_dir, "limits", cell + ".json")) as f:
        return json.load(f)


def load_reader(bench_dir: str, name: str):
    """The module ``metrics/<name>.py``: it defines ``UNIT``, ``LAYER``,
    ``SOURCE``, ``MOVES`` and ``read(ctx)``."""
    path = os.path.join(bench_dir, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "slam_bench_metric_" + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _applies(entry: dict, cell: str, end_to_end: list) -> bool:
    if "workloads" in entry:
        return cell in entry["workloads"]
    return entry["moves"] in end_to_end


def load_cell(root: str, cell: str, bench_dir: str = HERE) -> Cell:
    """The cell ``cell`` of ``root``/BENCHMARK.json with its files from
    ``bench_dir``. Raises KeyError for a cell the file does not name."""
    bench = load_benchmark(root)
    work = {w["name"]: w for w in bench["workloads"]}
    if cell not in work:
        raise KeyError(f"no workload {cell!r} in BENCHMARK.json "
                       f"(has {sorted(work)})")
    w = work[cell]
    e2e = [m["name"] for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    metrics = []
    for m in bench["per_layer"]:
        if not _applies(m, cell, e2e):
            continue
        mod = load_reader(bench_dir, m["name"])
        for key, attr in (("unit", "UNIT"), ("layer", "LAYER"),
                          ("source", "SOURCE"), ("moves", "MOVES")):
            if getattr(mod, attr) != m[key]:
                raise ValueError(f"metrics/{m['name']}.py: {attr} "
                                 f"{getattr(mod, attr)!r} differs from "
                                 f"BENCHMARK.json's {m[key]!r}")
        metrics.append(Metric(m["name"], m["unit"], m["layer"], m["source"],
                              m["moves"], mod.read))
    return Cell(name=cell, config_name=w["config"],
                config_path=config_path(bench_dir, w["config"]),
                config=load_config(bench_dir, w["config"]),
                traffic_name=w["traffic"],
                traffic=load_traffic(bench_dir, w["traffic"]),
                chips=int(w["chips"]),
                end_to_end=[m for m in bench["end_to_end"]
                            if m["name"] in e2e],
                metrics=metrics, limits=load_limits(bench_dir, cell))
