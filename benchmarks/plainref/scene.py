"""The scene files, read without the program: the part of the reference
renderer's JSON schema that the benchmark's scenes use.

Meshes from OBJ files placed by instances (M = T R S), Lambert and
transparent materials over constant colour textures, spot and point
lights, a pinhole perspective camera and a Gaussian film filter. Anything
else in a scene raises ValueError: the reference renders only what it
implements.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np

LAMBERT, TRANSPARENT = "lambert", "transparent"


@dataclass
class Camera:
    position: np.ndarray  # (3,) float32
    rot: np.ndarray  # (3, 3) float32, columns right, up, look
    p00: float  # projection's x and y scales
    p11: float
    x_res: int
    y_res: int


@dataclass
class Scene:
    v0: np.ndarray  # (T, 3) float32 world-space first vertex
    e1: np.ndarray  # (T, 3) v1 - v0
    e2: np.ndarray  # (T, 3) v2 - v0
    normals: np.ndarray  # (T, 3, 3) unit vertex normals
    uvs: np.ndarray  # (T, 3, 2)
    mat: np.ndarray  # (T,) int32 index into materials
    materials: list  # dicts: kind, c0, c1 (3,) float32, eta
    lights: list  # dicts: kind, position, color, direction, cos_max, cos_start
    camera: Camera
    filter_width: tuple  # (x, y) of the Gaussian
    filter_falloff: float
    settings: dict  # render_setting with the overrides

    @property
    def n_tris(self) -> int:
        return int(self.v0.shape[0])


def read_obj(path):
    """OBJ v / vt / vn records and triangle or quad faces (quads split
    0-1-2, 0-2-3), 1-based or negative indices -> per-corner arrays
    (F, 3, 3) positions, (F, 3, 3) normals or None, (F, 3, 2) uvs or
    None."""
    pos, nrm, tex = [], [], []
    faces = []  # each corner (vi, ti, ni), -1 where absent
    with open(path, errors="replace") as f:
        for line in f:
            tok = line.split()
            if not tok or tok[0].startswith("#"):
                continue
            if tok[0] == "v":
                pos.append([float(x) for x in tok[1:4]])
            elif tok[0] == "vn":
                nrm.append([float(x) for x in tok[1:4]])
            elif tok[0] == "vt":
                tex.append([float(x) for x in tok[1:3]])
            elif tok[0] == "f":
                corners = []
                for c in tok[1:]:
                    parts = (c.split("/") + ["", ""])[:3]
                    idx = []
                    for part, count in zip(parts, (len(pos), len(tex),
                                                   len(nrm))):
                        if not part:
                            idx.append(-1)
                            continue
                        k = int(part)
                        idx.append(k - 1 if k > 0 else count + k)
                    corners.append(idx)
                if len(corners) >= 3:
                    faces.append(corners[:3])
                if len(corners) == 4:
                    faces.append([corners[0], corners[2], corners[3]])
    if not faces:
        raise ValueError(f"{path}: no faces")
    fi = np.asarray(faces, np.int64)  # (F, 3, 3)
    p = np.asarray(pos, np.float32)[fi[..., 0]]
    n = (np.asarray(nrm, np.float32)[np.maximum(fi[..., 2], 0)]
         if (fi[..., 2] >= 0).all() and nrm else None)
    t = (np.asarray(tex, np.float32)[np.maximum(fi[..., 1], 0)]
         if (fi[..., 1] >= 0).all() and tex else None)
    return p, n, t


def quat_matrix(q):
    """wxyz quaternion -> (3, 3) float32 rotation applied as M @ v."""
    w, x, y, z = (float(v) for v in q)
    return np.array([
        [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * z * w,
         2 * x * z + 2 * y * w],
        [2 * x * y + 2 * z * w, 1 - 2 * x * x - 2 * z * z,
         2 * y * z - 2 * x * w],
        [2 * x * z - 2 * y * w, 2 * y * z + 2 * x * w,
         1 - 2 * x * x - 2 * y * y],
    ], np.float32)


def _vec(raw, key, default, n=3):
    v = np.asarray(raw.get(key, default), np.float32).reshape(-1)
    return np.full(n, v[0], np.float32) if v.size == 1 else v


def _transform(raw):
    m = np.eye(4, dtype=np.float32)
    q = _vec(raw, "orientation", (1.0, 0.0, 0.0, 0.0), 4)
    m[:3, :3] = quat_matrix(q) * _vec(raw, "scale", (1.0, 1.0, 1.0))[None]
    m[:3, 3] = _vec(raw, "position", (0.0, 0.0, 0.0))
    return m


def _unsupported(what):
    raise ValueError(f"the plain reference does not render {what}")


def load(path, overrides=None, film=None) -> Scene:
    """Read the scene file at path; overrides patch render_setting, film
    (x_res, y_res) resizes the film."""
    with open(path) as f:
        doc = json.load(f)
    base = os.path.dirname(os.path.abspath(path))
    settings = dict(doc.get("render_setting", {}))
    settings.update(overrides or {})
    if settings.get("render_method", "path_tracing") not in (
            "path_tracing", "path"):
        _unsupported(f"render_method {settings.get('render_method')!r}")
    for key in ("volume",):
        if doc.get(key):
            _unsupported(key)

    cam = doc.get("camera", {})
    if cam.get("type", "perspective") != "perspective":
        _unsupported("an orthographic camera")
    if float(cam.get("lens_radius", 0.0)) > 0.0:
        _unsupported("a thin lens")
    filt = cam.get("filter", {})
    if filt.get("type", "gaussian") != "gaussian":
        _unsupported(f"the {filt.get('type')!r} filter")
    res = _vec(cam.get("film", {}), "resolution", (512.0, 512.0), 2)
    x_res, y_res = (int(res[0]), int(res[1])) if film is None else film
    fov = float(np.radians(float(cam.get("fov", 60.0))))
    y_scale = 1.0 / np.tan(fov / 2.0)
    camera = Camera(
        position=_vec(cam, "position", (0.0, 0.0, 0.0)),
        rot=quat_matrix(_vec(cam, "orientation", (1.0, 0.0, 0.0, 0.0), 4)),
        p00=float(np.float32(y_scale / (x_res / y_res))),
        p11=float(np.float32(y_scale)), x_res=x_res, y_res=y_res)
    fw = _vec(filt, "width", (1.0, 1.0), 2)

    colors = {}
    for t in doc.get("textures", []) or []:
        if t.get("format", "color") != "color":
            continue
        if t.get("type", "constant") != "constant":
            continue  # only constant textures can be named by a material
        colors[t["name"]] = _vec(t, "color", (0.5, 0.5, 0.5))

    def color(m, key):
        if m.get(key) not in colors:
            _unsupported(f"texture {m.get(key)!r}")
        return colors[m[key]]

    materials, mat_ids = [], {}
    for m in doc.get("materials", []) or []:
        if "bumpmap" in m or "normalmap" in m:
            _unsupported("bump or normal maps")
        kind = m.get("type", "lambert")
        if kind == LAMBERT:
            rec = {"kind": LAMBERT, "c0": color(m, "Kd"),
                   "c1": np.zeros(3, np.float32), "eta": 1.0}
        elif kind == TRANSPARENT:
            rec = {"kind": TRANSPARENT, "c0": color(m, "Kr"),
                   "c1": color(m, "Kt"), "eta": float(m.get("index", 1.5))}
        else:
            _unsupported(f"{kind!r} materials")
        mat_ids[m["name"]] = len(materials)
        materials.append(rec)

    lights = []
    for li in doc.get("lights", []) or []:
        kind = li.get("type", "point")
        if kind not in ("spot", "point"):
            _unsupported(f"{kind!r} lights")
        pos = _vec(li, "position", (0.0, 0.0, 0.0))
        d = (_vec(li, "target", (0.0, 0.0, 0.0)) - pos if "target" in li
             else _vec(li, "direction", (0.0, 0.0, 1.0)))
        d = d / np.linalg.norm(d)
        spot = kind == "spot"
        lights.append({
            "kind": kind, "position": pos,
            "color": _vec(li, "intensity", (1.0, 1.0, 1.0)),
            "direction": d.astype(np.float32),
            "cos_max": float(np.cos(np.radians(
                float(li.get("theta_max", 30.0))))) if spot else -1.0,
            "cos_start": float(np.cos(np.radians(
                float(li.get("falloff_start", 25.0))))) if spot else -1.0})
    if not lights:
        _unsupported("a scene without lights")

    geometries = {}
    for g in doc.get("geometries", []) or []:
        geometries[g["name"]] = g
    models, parts = {}, []
    for p in doc.get("primitives", []) or []:
        if p.get("type", "model") == "model":
            models[p["name"]] = p
            continue
        model = models[p["model"]]
        g = geometries[model["geometry"]]
        if g.get("type") != "mesh":
            _unsupported(f"{g.get('type')!r} geometry")
        pos, nrm, uv = read_obj(os.path.join(base, g["file"]))
        m = _transform(p)
        v = pos @ m[:3, :3].T + m[:3, 3]
        if nrm is not None:
            n = nrm @ np.linalg.inv(m[:3, :3])
            n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True),
                               1e-20)
        else:
            gn = np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
            gn = gn / np.maximum(np.linalg.norm(gn, axis=-1, keepdims=True),
                                 1e-20)
            n = np.repeat(gn[:, None], 3, axis=1)
        if uv is None:
            uv = np.broadcast_to(np.float32([[0, 0], [1, 0], [0, 1]]),
                                 (v.shape[0], 3, 2))
        if model["material"] not in mat_ids:
            _unsupported(f"material {model['material']!r}")
        parts.append((v.astype(np.float32), n.astype(np.float32),
                      np.asarray(uv, np.float32),
                      np.full(v.shape[0], mat_ids[model["material"]],
                              np.int32)))
    v = np.concatenate([q[0] for q in parts])
    return Scene(
        v0=v[:, 0].copy(), e1=(v[:, 1] - v[:, 0]).astype(np.float32),
        e2=(v[:, 2] - v[:, 0]).astype(np.float32),
        normals=np.concatenate([q[1] for q in parts]),
        uvs=np.concatenate([q[2] for q in parts]),
        mat=np.concatenate([q[3] for q in parts]),
        materials=materials, lights=lights, camera=camera,
        filter_width=(float(fw[0]), float(fw[1])),
        filter_falloff=float(filt.get("falloff", 2.0)), settings=settings)
