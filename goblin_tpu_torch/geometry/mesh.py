"""Host-side OBJ loading and writing, numpy arrays (port of
goblin_tpu/geometry/mesh.py).

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

    @property
    def num_faces(self) -> int:
        return int(self.faces.shape[0])

    @property
    def has_normals(self) -> bool:
        return self.normals is not None

    @property
    def has_uvs(self) -> bool:
        return self.uvs is not None


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


def make_sphere_mesh(radius: float, n_theta: int = 32,
                     n_phi: int = 64) -> TriangleMesh:
    """A UV sphere of n_theta x n_phi cells about the origin, z the pole
    axis; the pole cells keep one triangle each (for tests)."""
    th = np.linspace(0.0, np.pi, n_theta + 1)
    ph = np.linspace(0.0, 2 * np.pi, n_phi + 1)
    T, P = np.meshgrid(th, ph, indexing="ij")
    pos = np.stack([radius * np.sin(T) * np.cos(P),
                    radius * np.sin(T) * np.sin(P), radius * np.cos(T)],
                   axis=-1).reshape(-1, 3).astype(np.float32)
    uv = np.stack([P / (2 * np.pi), T / np.pi], axis=-1).reshape(-1, 2)
    i, j = np.meshgrid(np.arange(n_theta), np.arange(n_phi), indexing="ij")
    a, b = i * (n_phi + 1) + j, (i + 1) * (n_phi + 1) + j
    c, d = b + 1, a + 1
    # (a, b, c) degenerates at the south pole and (a, c, d) at the north:
    # each cell row keeps the triangles that do not, in goblin_tpu's order
    tris = np.stack([np.stack([a, b, c], -1), np.stack([a, c, d], -1)], 2)
    keep = np.stack([i < n_theta - 1, i > 0], -1)
    return TriangleMesh(positions=pos,
                        normals=(pos / max(radius, 1e-9)).astype(np.float32),
                        uvs=uv.astype(np.float32),
                        faces=tris[keep].astype(np.int32))


def write_obj(path: str, mesh: TriangleMesh) -> None:
    """A minimal OBJ: v, vn and vt records as the mesh has them (6 and 6
    decimals), one index a corner shared by all three."""
    with open(path, "w") as f:
        for p in mesh.positions:
            f.write(f"v {p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")
        if mesh.normals is not None:
            for n in mesh.normals:
                f.write(f"vn {n[0]:.6f} {n[1]:.6f} {n[2]:.6f}\n")
        if mesh.uvs is not None:
            for t in mesh.uvs:
                f.write(f"vt {t[0]:.6f} {t[1]:.6f}\n")
        form = {(True, True): "{0}/{0}/{0}", (True, False): "{0}//{0}",
                (False, True): "{0}/{0}", (False, False): "{0}"}[
                    (mesh.normals is not None, mesh.uvs is not None)]
        for face in mesh.faces:
            f.write("f " + " ".join(form.format(int(k) + 1) for k in face)
                    + "\n")
