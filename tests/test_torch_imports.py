"""The port imports neither jax nor anything of plvs_tpu: every module of
plvs_tpu_torch/, chip_smoke.py and the port's scripts, read with ``ast``
(the CPU tests would not notice such an import, since this machine has
jax; the card's machine does not)."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
FILES = sorted(
    [p for p in (ROOT / "plvs_tpu_torch").rglob("*.py")]
    + [ROOT / "chip_smoke.py", ROOT / "scripts" / "profile_port_frame.py",
       ROOT / "scripts" / "probe_k1_design.py",
       ROOT / "scripts" / "count_ba_ops.py",
       ROOT / "scripts" / "count_imu_ops.py",
       ROOT / "scripts" / "count_orb_ops.py"])
FORBIDDEN = ("jax", "jaxlib", "plvs_tpu")


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


def _imports(tree):
    """Absolute module names imported by the tree: import statements and
    constant-string ``__import__`` / ``importlib.import_module`` calls."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif isinstance(node, ast.Call) and node.args:
            f = node.func
            name = f.attr if isinstance(f, ast.Attribute) else getattr(
                f, "id", "")
            arg = node.args[0]
            if name in ("__import__", "import_module") and isinstance(
                    arg, ast.Constant) and isinstance(arg.value, str):
                yield arg.value


def test_the_walk_covers_the_port():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    assert "plvs_tpu_torch/ops/stereo.py" in names
    assert "plvs_tpu_torch/dense/mapping.py" in names
    assert "plvs_tpu_torch/vocab/bow.py" in names
    assert "plvs_tpu_torch/slam/keyframe_database.py" in names
    assert "plvs_tpu_torch/slam/async_runtime.py" in names
    assert "plvs_tpu_torch/utils/fetch.py" in names
    for mod in ("imu/preintegration.py", "imu/initialization.py",
                "solvers/vi_ba.py", "slam/inertial.py"):
        assert f"plvs_tpu_torch/{mod}" in names, mod
    assert "scripts/count_imu_ops.py" in names
    for mod in ("geometry/rectify.py", "dense/esdf.py", "dense/labels.py",
                "utils/depth_model.py"):
        assert f"plvs_tpu_torch/{mod}" in names, mod
    for mod in ("solvers/two_view.py", "solvers/pnp.py",
                "solvers/autodiff.py", "slam/map_objects.py"):
        assert f"plvs_tpu_torch/{mod}" in names, mod
    assert len(names) > 30
    for src in ("import jax.numpy as jnp", "from plvs_tpu.ops import stereo",
                "import importlib\nimportlib.import_module('jax')",
                "__import__('plvs_tpu')"):
        assert any(_forbidden(m) for m in _imports(ast.parse(src))), src
    for src in ("from . import jax_like", "import plvs_tpu_torch.ops"):
        assert not any(_forbidden(m) for m in _imports(ast.parse(src))), src


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_plvs_tpu_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [m for m in _imports(tree) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_vocabulary_files_are_the_ports_own():
    """The shipped vocabularies are copies inside the port, and no module
    of the port builds a path into plvs_tpu/: no string constant outside a
    docstring is "plvs_tpu" or starts with "plvs_tpu/"."""
    data = ROOT / "plvs_tpu_torch" / "vocab" / "data"
    for name in ("voc_100k.npz", "voc_10k.npz"):
        assert (data / name).is_file(), name
        assert (data / name).read_bytes() == (
            ROOT / "plvs_tpu" / "vocab" / "data" / name).read_bytes()
    from plvs_tpu_torch.slam import keyframe_database

    default = pathlib.Path(keyframe_database._DEFAULT_VOCAB).resolve()
    assert default.parent == data.resolve()
    for path in (ROOT / "plvs_tpu_torch").rglob("*.py"):
        tree = ast.parse(path.read_text())
        docs = {id(n.body[0].value) for n in ast.walk(tree)
                if isinstance(n, (ast.Module, ast.ClassDef, ast.FunctionDef))
                and n.body and isinstance(n.body[0], ast.Expr)}
        for node in ast.walk(tree):
            if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                    and id(node) not in docs):
                v = node.value.replace("\\", "/")
                assert v != "plvs_tpu" and not v.startswith("plvs_tpu/"), (
                    path, node.value)
