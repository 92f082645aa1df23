"""Batched vector math over a trailing axis of size 3 (port of the parts of
goblin_tpu/core/vecmath.py the path-tracing slice uses).

Products are summed left to right (x, then y, then z), the order the
CUDA kernel and goblin_tpu's three-term sums use.
"""

from __future__ import annotations

import math

import numpy as np
import torch

INV_PI = 1.0 / math.pi
TWO_PI = 2.0 * math.pi
INV_TWO_PI = 1.0 / TWO_PI


def dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def dotn(a, b):
    """dot with the reduced axis kept (for broadcasting)."""
    return dot(a, b)[..., None]


def absdot(a, b):
    return dot(a, b).abs()


def squared_length(a):
    return dot(a, a)


def cross(a, b):
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1
    )


def normalize(a, eps=0.0):
    """Normalize over the trailing axis. eps > 0 maps 0-length to 0s."""
    sq = squared_length(a)[..., None]
    if eps > 0.0:
        return a * torch.where(
            sq > eps, 1.0 / torch.sqrt(torch.clamp(sq, min=eps)), 0.0
        )
    return a / torch.sqrt(sq)


def coordinate_system(a1):
    """Two unit vectors completing an orthonormal frame with unit a1
    (reference coordinateAxises: branch on |x| > |y|, a3 = a1 x a2)."""
    x, y, z = a1[..., 0], a1[..., 1], a1[..., 2]
    zero = torch.zeros_like(x)
    cond = x.abs() > y.abs()
    inv_a = 1.0 / torch.sqrt(torch.clamp(x * x + z * z, min=1e-30))
    a2_a = torch.stack([-z * inv_a, zero, x * inv_a], dim=-1)
    inv_b = 1.0 / torch.sqrt(torch.clamp(y * y + z * z, min=1e-30))
    a2_b = torch.stack([zero, -z * inv_b, y * inv_b], dim=-1)
    a2 = torch.where(cond[..., None], a2_a, a2_b)
    return a2, cross(a1, a2)


def spherical_theta(v):
    return torch.acos(torch.clamp(v[..., 2], -1.0, 1.0))


def spherical_phi(v):
    """phi in [0, 2 pi) (reference src/GoblinUtils.h sphericalPhi)."""
    p = torch.atan2(v[..., 1], v[..., 0])
    return torch.where(p < 0.0, p + TWO_PI, p)


def quadratic(A, B, C):
    """Numerically stable quadratic roots (reference
    src/GoblinUtils.cpp:93-113) -> (has_roots, t1, t2) with t1 <= t2; where
    has_roots is False the roots are garbage and the caller masks them."""
    disc = B * B - 4.0 * A * C
    root = torch.sqrt(torch.clamp(disc, min=0.0))
    q = torch.where(B < 0.0, -0.5 * (B - root), -0.5 * (B + root))
    t1 = q / A
    t2 = C / torch.where(q == 0.0, 1e-30, q)
    return disc >= 0.0, torch.minimum(t1, t2), torch.maximum(t1, t2)


def mat3_apply(m, v):
    """(3, 3) @ (..., 3) -> (..., 3), one row dot per component; m may be
    nested Python lists of floats."""
    return torch.stack(
        [m[i][0] * v[..., 0] + m[i][1] * v[..., 1] + m[i][2] * v[..., 2]
         for i in range(3)], dim=-1)


def quat_to_matrix_np(q) -> np.ndarray:
    """(4,) wxyz quaternion -> (3, 3) float32 rotation, applied M @ v
    (reference Quaternion::toMatrix)."""
    w, x, y, z = (float(v) for v in q)
    x2, y2, z2 = 2 * x, 2 * y, 2 * z
    return np.array(
        [
            [1 - y2 * y - z2 * z, x2 * y - z2 * w, x2 * z + y2 * w],
            [x2 * y + z2 * w, 1 - x2 * x - z2 * z, y2 * z - x2 * w],
            [x2 * z - y2 * w, y2 * z + x2 * w, 1 - x2 * x - y2 * y],
        ],
        dtype=np.float32,
    )


def perspective_lh_d3d(fov_y, aspect, zn, zf) -> np.ndarray:
    """Left-handed D3D perspective projection (z in [0, 1]), host numpy."""
    y_scale = 1.0 / np.tan(fov_y / 2.0)
    x_scale = y_scale / aspect
    m = np.zeros((4, 4), dtype=np.float32)
    m[0, 0] = x_scale
    m[1, 1] = y_scale
    m[2, 2] = zf / (zf - zn)
    m[2, 3] = -zn * zf / (zf - zn)
    m[3, 2] = 1.0
    return m


def ortho_lh_d3d(w, h, zn, zf) -> np.ndarray:
    """Left-handed D3D orthographic projection (z in [0, 1]), host numpy."""
    m = np.zeros((4, 4), dtype=np.float32)
    m[0, 0] = 2.0 / w
    m[1, 1] = 2.0 / h
    m[2, 2] = 1.0 / (zf - zn)
    m[2, 3] = zn / (zn - zf)
    m[3, 3] = 1.0
    return m
