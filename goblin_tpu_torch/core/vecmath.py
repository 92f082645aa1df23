"""Batched vector, quaternion and transform math over a trailing axis of
size 3 (port of goblin_tpu/core/vecmath.py).

Products are summed left to right (x, then y, then z), the order the
CUDA kernel and goblin_tpu's three-term sums use. Quaternions are (..., 4)
in (w, x, y, z) order; matrices are row-major, applied as M @ v. The
loader builds its transforms on the host in numpy (scene/params.py); the
tensor forms here serve callers that hold tensors.
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


def length(a):
    return torch.sqrt(dot(a, a))


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


def safe_normalize(a):
    return normalize(a, eps=1e-30)


def lerp(t, a, b):
    return a + t * (b - a)


def reflect(w, n):
    """Mirror w about n (both pointing away from the surface)."""
    return 2.0 * dotn(w, n) * n - w


def face_forward(n, v):
    """Flip n into the hemisphere of v."""
    return torch.where(dotn(n, v) < 0.0, -n, n)


def sqrt0(x):
    """sqrt(max(x, 0)) with a zero slope where x <= 0: the lanes a where
    drops would otherwise send 0 * inf (sqrt's slope at 0) into the
    gradient. Its values are sqrt(clamp(x, min=0))'s."""
    pos = x > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, 1.0)), 0.0)


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


def spherical_direction(sin_theta, cos_theta, phi):
    return torch.stack([sin_theta * torch.cos(phi),
                        sin_theta * torch.sin(phi), cos_theta], dim=-1)


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
    root = sqrt0(disc)
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


def mat3_apply_t(m, v):
    """The transpose of m (3, 3) applied to v (..., 3): columns times the
    components, summed in goblin_tpu's order."""
    return (m[0] * v[..., 0:1] + m[1] * v[..., 1:2] + m[2] * v[..., 2:3])


def _f32(x, like=None):
    dev = None if like is None else like.device
    return torch.as_tensor(x, dtype=torch.float32, device=dev)


def quat_identity():
    return torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=torch.float32)


def quat_from_axis_angle(axis, angle):
    """Unit quaternion rotating by angle (radians) about the unit axis."""
    axis = _f32(axis)
    half = 0.5 * _f32(angle, axis)
    return torch.cat([torch.cos(half)[..., None],
                      torch.sin(half)[..., None] * axis], dim=-1)


def quat_mul(q1, q2):
    """Hamilton product q1 * q2 (q2's rotation applies first)."""
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], dim=-1)


def quat_rotate(q, v):
    """Rotate v (..., 3) by the quaternion q (..., 4)."""
    qv = q[..., 1:]
    t = 2.0 * cross(qv, v)
    return v + q[..., 0:1] * t + cross(qv, t)


def quat_to_matrix(q):
    """(..., 4) wxyz -> (..., 3, 3) rotation, applied M @ v (reference
    Quaternion::toMatrix)."""
    w, x, y, z = q.unbind(-1)
    x2, y2, z2 = 2 * x, 2 * y, 2 * z
    xx2, yy2, zz2 = x2 * x, y2 * y, z2 * z
    xy2, xz2, yz2 = x2 * y, x2 * z, y2 * z
    xw2, yw2, zw2 = x2 * w, y2 * w, z2 * w
    one = torch.ones_like(w)
    return torch.stack([
        torch.stack([one - yy2 - zz2, xy2 - zw2, xz2 + yw2], dim=-1),
        torch.stack([xy2 + zw2, one - xx2 - zz2, yz2 - xw2], dim=-1),
        torch.stack([xz2 - yw2, yz2 + xw2, one - xx2 - yy2], dim=-1),
    ], dim=-2)


def euler_to_quat(xyz_degrees, order="xyz"):
    """Euler angles in degrees (..., 3) -> quaternion; order "abc" applies
    rotation a first: q = qc * qb * qa (reference eulerToQuaternion). An
    unknown order is "xyz"."""
    xyz = _f32(xyz_degrees) * (math.pi / 180.0)
    named = {c: quat_from_axis_angle(torch.eye(3, device=xyz.device)[i],
                                      xyz[..., i])
             for i, c in enumerate("xyz")}
    if order not in ("xyz", "xzy", "yxz", "yzx", "zxy", "zyx"):
        order = "xyz"
    a, b, c = order
    return quat_mul(named[c], quat_mul(named[b], named[a]))


def compose_matrix(position, quat, scale):
    """Position, quaternion and scale -> 4 x 4, M = T R S (scale first;
    reference Transform::getMatrix)."""
    rs = quat_to_matrix(_f32(quat)) * _f32(scale)[..., None, :]
    p = _f32(position)
    top = torch.cat([rs, p[..., :, None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], device=top.device).expand(
        top.shape[:-2] + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def _mat3_rows(m, v):
    """(..., 3, 3) @ (..., 3): a row dot a component."""
    return torch.stack([dot(m[..., i, :], v) for i in range(3)], dim=-1)


def transform_point(m, p):
    """The 4 x 4 m applied to points (..., 3)."""
    return _mat3_rows(m[..., :3, :3], p) + m[..., :3, 3]


def transform_vector(m, v):
    return _mat3_rows(m[..., :3, :3], v)


def transform_normal(m_inv, n):
    """Normals take the inverse transpose: n' = (M^-1)^T n."""
    r = m_inv[..., :3, :3]
    return (r[..., 0, :] * n[..., 0:1] + r[..., 1, :] * n[..., 1:2]
            + r[..., 2, :] * n[..., 2:3])


def matrix_inverse(m):
    return torch.linalg.inv(m)


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


def solve_2x2(a00, a01, a10, a11, b0, b1):
    """Solve [[a00, a01], [a10, a11]] x = [b0, b1] -> (ok, x0, x1); ok is
    False where |det| < 1e-10 (x is then garbage)."""
    det = a00 * a11 - a01 * a10
    ok = det.abs() >= 1e-10
    inv = 1.0 / torch.where(ok, det, 1.0)
    return ok, (a11 * b0 - a01 * b1) * inv, (a00 * b1 - a10 * b0) * inv
