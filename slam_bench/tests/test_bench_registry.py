"""The benchmark finds every piece of a cell by name, and picks up new
files with no other file edited."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from slam_bench import registry
from slam_bench.tests import tiny

ROOT = tiny.ROOT


def _bench():
    return registry.load_benchmark(ROOT)


@pytest.mark.parametrize("cell", [w["name"] for w in _bench()["workloads"]])
def test_every_cell_loads_by_name(cell):
    c = registry.load_cell(ROOT, cell)
    entry = next(w for w in _bench()["workloads"] if w["name"] == cell)
    assert c.config_name == entry["config"]
    assert c.traffic_name == entry["traffic"]
    assert c.config["Bench.sensor"] in ("rgbd", "stereo")
    assert c.traffic["mode"] == "mapping"
    assert c.limits
    names = {m["name"] for m in _bench()["per_layer"]
             if cell in m.get("workloads", [cell])}
    assert {m.name for m in c.metrics} == names
    assert all(callable(m.read) for m in c.metrics)


def test_configs_files_match_benchmark_entries():
    for cfg in _bench()["configs"]:
        d = registry.read_flat_yaml(os.path.join(ROOT, cfg["file"]))
        assert d["Bench.source"] == cfg["source"]
        assert d["Bench.reduced"] == cfg["reduced"]
        for key in d["Bench.reduced"]:
            # a dropped camera key is gone; a cut of scale holds its value
            assert (key not in d) == key.startswith("Camera."), key


def test_new_files_are_picked_up_by_name(tmp_path):
    """A configuration, a mix, a metric and limits dropped into a copy of
    the folders, with one BENCHMARK.json entry naming them."""
    root = tiny.make(str(tmp_path))
    bd = os.path.join(root, "slam_bench")
    cfg = registry.load_config(bd, "tum2_rgbd")
    cfg["Sequence.frames"] = 6
    tiny.write_yaml(os.path.join(bd, "configs", "new_cfg.yaml"), cfg)
    tr = registry.load_traffic(bd, "wall_sweep")
    tr["scene"]["tex_seed"] = 8
    with open(os.path.join(bd, "traffic", "new_mix.json"), "w") as f:
        json.dump(tr, f)
    with open(os.path.join(bd, "metrics", "new_metric.py"), "w") as f:
        f.write('UNIT = "ms"\nLAYER = "x"\nSOURCE = "host_clock"\n'
                'MOVES = "frames_per_s"\n\n\ndef read(ctx):\n'
                '    return 1.0\n')
    with open(os.path.join(bd, "limits", "new_cfg.new_mix.json"), "w") as f:
        json.dump({"k1_wrong": 0}, f)
    bench = registry.load_benchmark(root)
    bench["workloads"].append({"name": "new_cfg.new_mix", "config": "new_cfg",
                               "traffic": "new_mix", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "new_metric", "unit": "ms",
                               "better": "lower", "source": "host_clock",
                               "layer": "x", "moves": "frames_per_s",
                               "workloads": ["new_cfg.new_mix"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    c = registry.load_cell(root, "new_cfg.new_mix", bd)
    assert c.config["Sequence.frames"] == 6
    assert c.traffic["scene"]["tex_seed"] == 8
    assert [m.name for m in c.metrics if m.name == "new_metric"]
    assert c.metrics[-1].read({}) == 1.0
    old = registry.load_cell(root, "tum2_rgbd.mapping", bd)
    assert "new_metric" not in {m.name for m in old.metrics}


def test_reader_declarations_must_match_benchmark(tmp_path):
    root = tiny.make(str(tmp_path))
    bd = os.path.join(root, "slam_bench")
    path = os.path.join(bd, "metrics", "frame_ms_p50.py")
    src = open(path).read().replace('UNIT = "ms"', 'UNIT = "s"')
    open(path, "w").write(src)
    with pytest.raises(ValueError):
        registry.load_cell(root, "tum2_rgbd.mapping", bd)


def test_flat_yaml_reader_matches_the_program_settings_reader():
    from plvs_tpu_torch.slam.settings import load_yaml_flat

    for cfg in _bench()["configs"]:
        path = os.path.join(ROOT, cfg["file"])
        mine = registry.read_flat_yaml(path)
        theirs = load_yaml_flat(path)
        assert mine == theirs


def test_loader_imports_no_jax_and_no_jax_package():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from slam_bench import registry, harness, run, trace, traffic\n"
        "from slam_bench.reference import check, lines\n"
        "registry.load_cell(%r, 'tum2_rgbd.mapping')\n"
        "bad = sorted({m.split('.')[0] for m in sys.modules}\n"
        "             & {'jax', 'jaxlib', 'flax', 'plvs_tpu'})\n"
        "print(bad)\n" % (ROOT, ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_reference_imports_nothing_of_the_program():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import slam_bench.reference.check, slam_bench.reference.lines\n"
        "print(sorted(m for m in sys.modules\n"
        "             if m.split('.')[0].startswith('plvs_tpu')))\n" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_exits_nonzero_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the run would measure")
    out = subprocess.run(
        [sys.executable, "slam_bench/run.py", "--workload",
         "tum2_rgbd.mapping", "--seed", "1", "--seconds", "1", "--trace",
         "0"], capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr
