"""Host-side OBJ loading into numpy arrays (port of
goblin_tpu/geometry/mesh.py's loader).

Parity with the reference parser (src/GoblinPolygonMesh.cpp:58-262):
v/vn/vt records, triangle and quad faces (quads split 0-1-2 / 0-2-3),
negative indices, the four face formats, and vertex dedup on the
(v, t, n) index triple.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .. import native


@dataclass
class TriangleMesh:
    """Indexed triangle mesh (host, numpy)."""

    positions: np.ndarray  # (V, 3) float32
    normals: np.ndarray | None  # (V, 3) float32 or None
    uvs: np.ndarray | None  # (V, 2) float32 or None
    faces: np.ndarray  # (F, 3) int32


def _resolve_index(raw: int, count: int) -> int:
    """OBJ indices are 1-based; negative indices count back from the end."""
    return raw - 1 if raw > 0 else count + raw


def load_obj(path: str) -> TriangleMesh:
    """Parse an OBJ file into a deduplicated TriangleMesh: the native
    parser when the library loads, the Python parser otherwise."""
    res = native.load_obj(path)
    if res is not None:
        return TriangleMesh(*res)
    return _load_obj_python(path)


def _load_obj_python(path: str) -> TriangleMesh:
    positions: list[tuple] = []
    normals: list[tuple] = []
    uvs: list[tuple] = []
    vert_map: dict[tuple, int] = {}  # (vi, ti, ni) -> output vertex
    out_pos: list[tuple] = []
    out_nrm: list[tuple] = []
    out_uv: list[tuple] = []
    faces: list[tuple] = []
    any_normal = False
    any_uv = False

    def corner(token: str) -> int:
        nonlocal any_normal, any_uv
        parts = token.split("/")
        vi = _resolve_index(int(parts[0]), len(positions))
        ti = ni = -1
        if len(parts) >= 2 and parts[1]:
            ti = _resolve_index(int(parts[1]), len(uvs))
            any_uv = True
        if len(parts) >= 3 and parts[2]:
            ni = _resolve_index(int(parts[2]), len(normals))
            any_normal = True
        key = (vi, ti, ni)
        idx = vert_map.get(key)
        if idx is None:
            idx = len(out_pos)
            vert_map[key] = idx
            out_pos.append(positions[vi])
            out_uv.append(uvs[ti] if ti >= 0 else (0.0, 0.0))
            out_nrm.append(normals[ni] if ni >= 0 else (0.0, 0.0, 0.0))
        return idx

    with open(path, "r", errors="replace") as f:
        for line in f:
            tokens = line.split()
            if not tokens or tokens[0].startswith("#"):
                continue
            tag = tokens[0]
            if tag == "v":
                positions.append(tuple(float(x) for x in tokens[1:4]))
            elif tag == "vn":
                normals.append(tuple(float(x) for x in tokens[1:4]))
            elif tag == "vt":
                uvs.append(tuple(float(x) for x in tokens[1:3]))
            elif tag == "f":
                corners = [corner(t) for t in tokens[1:]]
                if len(corners) >= 3:
                    faces.append((corners[0], corners[1], corners[2]))
                if len(corners) == 4:  # quad -> second triangle 0-2-3
                    faces.append((corners[0], corners[2], corners[3]))

    if not faces:
        raise ValueError(f"no faces parsed from OBJ: {path}")
    return TriangleMesh(
        positions=np.asarray(out_pos, dtype=np.float32),
        normals=np.asarray(out_nrm, dtype=np.float32) if any_normal else None,
        uvs=np.asarray(out_uv, dtype=np.float32) if any_uv else None,
        faces=np.asarray(faces, dtype=np.int32),
    )
