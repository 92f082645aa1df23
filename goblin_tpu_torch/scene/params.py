"""ParamSet: typed key-value view over parsed JSON scene sections (port of
goblin_tpu/scene/params.py, numpy only).

Reference semantics (src/GoblinParamSet.{h,cpp}): JSON arrays of length
2/3/4 become vectors, lookups fall back to typed defaults.
"""

from __future__ import annotations

import numpy as np

from ..core.vecmath import quat_to_matrix_np


class ParamSet:
    def __init__(self, raw: dict | None = None):
        self.raw = dict(raw or {})

    def has(self, key) -> bool:
        return key in self.raw

    def get_bool(self, key, default=False) -> bool:
        return bool(self.raw.get(key, default))

    def get_int(self, key, default=0) -> int:
        return int(self.raw.get(key, default))

    def get_float(self, key, default=0.0) -> float:
        v = self.raw.get(key, default)
        if isinstance(v, (list, tuple)):
            v = v[0]
        return float(v)

    def get_string(self, key, default="") -> str:
        return str(self.raw.get(key, default))

    def _get_vec(self, key, default, n):
        v = self.raw.get(key, None)
        if v is None:
            v = default
        arr = np.asarray(v, dtype=np.float32).reshape(-1)
        if arr.size == 1:
            arr = np.full(n, float(arr[0]), np.float32)
        if arr.size != n:
            raise ValueError(f"param {key}: expected {n} components, got {arr.size}")
        return arr

    def get_vec2(self, key, default=(0.0, 0.0)):
        return self._get_vec(key, default, 2)

    def get_vec3(self, key, default=(0.0, 0.0, 0.0)):
        return self._get_vec(key, default, 3)

    def get_vec4(self, key, default=(0.0, 0.0, 0.0, 0.0)):
        return self._get_vec(key, default, 4)


def _quat_axis_angle(axis, angle):
    half = np.float32(0.5) * angle
    return np.concatenate([[np.cos(half)], np.sin(half) * axis]).astype(np.float32)


def _quat_mul(q1, q2):
    """Hamilton product q1 * q2 (q2's rotation applies first)."""
    w1, x1, y1, z1 = q1
    w2, x2, y2, z2 = q2
    return np.array([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], dtype=np.float32)


def euler_to_quat(xyz_degrees, order="xyz") -> np.ndarray:
    """Euler angles in degrees -> wxyz quaternion; order "abc" applies
    rotation a first: q = qc * qb * qa (reference eulerToQuaternion)."""
    xyz = np.asarray(xyz_degrees, np.float32) * np.float32(np.pi / 180.0)
    named = {
        "x": _quat_axis_angle(np.float32([1, 0, 0]), xyz[0]),
        "y": _quat_axis_angle(np.float32([0, 1, 0]), xyz[1]),
        "z": _quat_axis_angle(np.float32([0, 0, 1]), xyz[2]),
    }
    if order not in ("xyz", "xzy", "yxz", "yzx", "zxy", "zyx"):
        order = "xyz"
    a, b, c = order
    return _quat_mul(named[c], _quat_mul(named[b], named[a]))


def get_quaternion(params: ParamSet) -> np.ndarray:
    """orientation (wxyz), or euler + rotation_order, -> quaternion
    (reference getQuaternion, src/GoblinUtils.cpp:71-82)."""
    if params.has("euler"):
        return euler_to_quat(params.get_vec3("euler"),
                             params.get_string("rotation_order", "xyz"))
    return params.get_vec4("orientation", (1.0, 0.0, 0.0, 0.0))


def get_transform(params: ParamSet) -> np.ndarray:
    """position/orientation/scale -> 4x4 world matrix, M = T R S
    (reference getTransform, src/GoblinUtils.cpp:84-91)."""
    pos = params.get_vec3("position", (0.0, 0.0, 0.0))
    scale = params.get_vec3("scale", (1.0, 1.0, 1.0))
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = quat_to_matrix_np(get_quaternion(params)) * scale[None, :]
    m[:3, 3] = pos
    return m
