"""Static GL objects: pre-loaded PLY clouds and meshes overlaid on the map.

Counterpart of plvs_tpu/viz/gl_objects.py, line for line (the reference's
GlObject / GlObjectList, include/GlObject.h:37-56 and
src/GlObjectList.cc:30-70: the ``GlObjects.on`` / ``GlObjects.list`` yaml
block of ``{filename, type, pose}`` entries). Objects load into numpy
arrays for the map renderer and the PLY export; the 6-dof ``pose`` ([tx ty
tz roll pitch yaw], radians) is applied to the vertices, as the JAX
package does.
"""

from __future__ import annotations

import dataclasses
import os
import re
import struct

import numpy as np

_PLY_TYPES = {
    "char": ("b", 1), "int8": ("b", 1),
    "uchar": ("B", 1), "uint8": ("B", 1),
    "short": ("h", 2), "int16": ("h", 2),
    "ushort": ("H", 2), "uint16": ("H", 2),
    "int": ("i", 4), "int32": ("i", 4),
    "uint": ("I", 4), "uint32": ("I", 4),
    "float": ("f", 4), "float32": ("f", 4),
    "double": ("d", 8), "float64": ("d", 8),
}


def load_ply(path: str):
    """Read an ascii or binary_little_endian PLY file.

    Returns (vertices [N,3] float32, colors [N,3] uint8 or None,
    faces [M,3] int32 or None). Properties beyond x/y/z/red/green/blue are
    skipped. (reference: the GlPointCloud/GlMesh loaders consume the same
    ply subset, src/GlPointCloud.cc / src/GlObject.cc)
    """
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        elements = []  # (name, count, [(prop_name, type, list_index_type)])
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: unterminated PLY header")
            tok = line.decode("ascii", "replace").split()
            if not tok or tok[0] == "comment":
                continue
            if tok[0] == "format":
                fmt = tok[1]
            elif tok[0] == "element":
                elements.append((tok[1], int(tok[2]), []))
            elif tok[0] == "property":
                if tok[1] == "list":
                    elements[-1][2].append((tok[4], tok[3], tok[2]))
                else:
                    elements[-1][2].append((tok[2], tok[1], None))
            elif tok[0] == "end_header":
                break
        if fmt not in ("ascii", "binary_little_endian"):
            raise ValueError(f"{path}: unsupported PLY format {fmt}")

        verts = colors = faces = None
        for name, count, props in elements:
            if fmt == "ascii":
                rows = []
                for _ in range(count):
                    rows.append(f.readline().split())
                if name == "vertex":
                    names = [p[0] for p in props]
                    arr = np.asarray(rows, np.float64)
                    ix = [names.index(c) for c in ("x", "y", "z")]
                    verts = arr[:, ix].astype(np.float32)
                    if all(c in names for c in ("red", "green", "blue")):
                        ic = [names.index(c) for c in ("red", "green", "blue")]
                        colors = arr[:, ic].astype(np.uint8)
                elif name == "face" and count:
                    faces = np.asarray(
                        [[int(x) for x in r[1:4]] for r in rows], np.int32)
            else:
                if name == "vertex":
                    names = [p[0] for p in props]
                    fmt_s = "<" + "".join(_PLY_TYPES[p[1]][0] for p in props)
                    size = struct.calcsize(fmt_s)
                    raw = f.read(size * count)
                    arr = np.asarray(
                        [struct.unpack_from(fmt_s, raw, i * size)
                         for i in range(count)], np.float64)
                    ix = [names.index(c) for c in ("x", "y", "z")]
                    verts = arr[:, ix].astype(np.float32)
                    if all(c in names for c in ("red", "green", "blue")):
                        ic = [names.index(c) for c in ("red", "green", "blue")]
                        colors = arr[:, ic].astype(np.uint8)
                elif name == "face":
                    out = []
                    for _ in range(count):
                        (idx_t, cnt_t) = (props[0][1], props[0][2])
                        c_fmt, c_sz = _PLY_TYPES[cnt_t]
                        n = struct.unpack("<" + c_fmt, f.read(c_sz))[0]
                        i_fmt, i_sz = _PLY_TYPES[idx_t]
                        vals = struct.unpack("<" + i_fmt * n, f.read(i_sz * n))
                        out.append(vals[:3])
                    faces = np.asarray(out, np.int32) if out else None
                else:
                    # skip unknown fixed-size element
                    fmt_s = "<" + "".join(_PLY_TYPES[p[1]][0] for p in props
                                          if p[2] is None)
                    f.read(struct.calcsize(fmt_s) * count)
    return verts, colors, faces


def _euler_to_R(roll: float, pitch: float, yaw: float) -> np.ndarray:
    cr, sr = np.cos(roll), np.sin(roll)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cy, sy = np.cos(yaw), np.sin(yaw)
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return (Rz @ Ry @ Rx).astype(np.float32)


@dataclasses.dataclass
class GlObject:
    """One static overlay object (reference: include/GlObject.h:37)."""

    filename: str
    type: str = "cloudmesh"
    points: np.ndarray | None = None      # [N,3] in object frame
    colors: np.ndarray | None = None      # [N,3] uint8
    faces: np.ndarray | None = None       # [M,3] int32
    R: np.ndarray = dataclasses.field(
        default_factory=lambda: np.eye(3, dtype=np.float32))
    t: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, np.float32))
    enabled: bool = True

    @staticmethod
    def create(type: str, filename: str, pose=None) -> "GlObject":
        """reference: GlObject::CreateObject(strType, filename),
        include/GlObject.h:56; pose = [tx ty tz roll pitch yaw]."""
        verts, colors, faces = load_ply(filename)
        obj = GlObject(filename=filename, type=type, points=verts,
                       colors=colors, faces=faces)
        if pose is not None and len(pose) >= 6:
            obj.t = np.asarray(pose[:3], np.float32)
            obj.R = _euler_to_R(*[float(x) for x in pose[3:6]])
        return obj

    def world_points(self) -> np.ndarray:
        if self.points is None or not len(self.points):
            return np.zeros((0, 3), np.float32)
        return self.points @ self.R.T + self.t


_ENTRY_RE = re.compile(
    r"-\s*\{\s*filename\s*:\s*\"?([^,\"}]+)\"?\s*,\s*type\s*:\s*"
    r"\"?([^,\"}]+)\"?\s*(?:,\s*pose\s*:\s*\[([^\]]*)\])?\s*\}")


class GlObjectList:
    """Ordered list of static objects (reference: include/GlObjectList.h)."""

    def __init__(self):
        self.objects: list[GlObject] = []

    def __len__(self):
        return len(self.objects)

    def __getitem__(self, i):
        return self.objects[i]

    def load(self, yaml_path: str) -> bool:
        """Parse the `GlObjects.on` / `GlObjects.list` block (reference:
        GlObjectList::Load, src/GlObjectList.cc:30-70). Filenames are
        resolved relative to the yaml file's directory."""
        with open(yaml_path) as f:
            text = f.read()
        on = re.search(r"GlObjects\.on\s*:\s*(\S+)", text)
        if not on or on.group(1).split("#")[0].strip() in ("0", "false",
                                                           "off", ""):
            return False
        base = os.path.dirname(os.path.abspath(yaml_path))
        block = text.split("GlObjects.list", 1)
        if len(block) < 2:
            return False
        for m in _ENTRY_RE.finditer(block[1]):
            fname, typ, pose_s = m.groups()
            # entries may be commented out in the reference presets
            line_start = block[1].rfind("\n", 0, m.start()) + 1
            if block[1][line_start:m.start()].lstrip().startswith("#"):
                continue
            pose = ([float(x) for x in pose_s.split(",") if x.strip()]
                    if pose_s else None)
            path = fname.strip()
            if not os.path.isabs(path):
                path = os.path.join(base, path)
            if not os.path.exists(path):
                continue
            self.objects.append(GlObject.create(typ.strip(), path, pose))
        return len(self.objects) > 0

    def all_world_points(self):
        """Concatenated world-frame points + colors of the enabled objects
        (consumed by viz.map_drawer.render_map_png's dense_cloud slot)."""
        pts = [o.world_points() for o in self.objects if o.enabled]
        cols = [o.colors if o.colors is not None
                else np.full((len(o.world_points()), 3), 200, np.uint8)
                for o in self.objects if o.enabled]
        if not pts:
            return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.uint8)
        return np.concatenate(pts, 0), np.concatenate(cols, 0)
