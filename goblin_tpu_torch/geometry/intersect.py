"""Batched ray / primitive intersection (port of
goblin_tpu/geometry/intersect.py).

World space, uniform scale: the bake turns an instance into a centre, a
radius and (for a disk) a frame. The traversal's own triangle and slab
tests live with the BVH walk (ops/trace.py); moller_trumbore, the dense
brute-force oracles and intersect_aabb here are the tests' references.
"""

from __future__ import annotations

import torch

from ..core import vecmath as vm

TRI_EPS = 1e-7  # barycentric tolerance (src/GoblinTriangle.cpp:38-125)
BIG_T = 3.0e38  # "no hit" distance (finite, so arithmetic stays finite)


def moller_trumbore(o, d, v0, e1, e2, mint, maxt):
    """Ray / triangle, all arguments broadcast -> (hit, t, b1, b2). o, d:
    (..., 3) rays; v0, e1, e2: (..., 3) a triangle's first vertex and edges;
    mint, maxt: (...) the t range."""
    s1 = vm.cross(d, e2)
    divisor = vm.dot(s1, e1)
    inv = 1.0 / torch.where(divisor == 0.0, 1e-30, divisor)
    s = o - v0
    b1 = vm.dot(s, s1) * inv
    s2 = vm.cross(s, e1)
    b2 = vm.dot(d, s2) * inv
    t = vm.dot(e2, s2) * inv
    hit = ((divisor != 0.0) & (b1 + TRI_EPS >= 0.0) & (b1 - TRI_EPS <= 1.0)
           & (b2 + TRI_EPS >= 0.0) & (b1 + b2 - TRI_EPS <= 1.0)
           & (t >= mint) & (t <= maxt))
    return hit, t, b1, b2


def _dense(o, d, v0, e1, e2, mint, maxt):
    """Every ray (R, 3) against every triangle (T, 3): (R, T) results."""
    return moller_trumbore(o[:, None], d[:, None], v0[None], e1[None],
                           e2[None], mint[:, None], maxt[:, None])


def brute_force_closest(o, d, v0, e1, e2, mint, maxt):
    """Dense closest-hit oracle over (R, 3) rays and (T, 3) triangles ->
    (hit, t, tri, b1, b2), each (R,); the first triangle of a tie. Memory
    is O(R T): for tests and small scenes."""
    hit, t, b1, b2 = _dense(o, d, v0, e1, e2, mint, maxt)
    t_masked = torch.where(hit, t, BIG_T)
    best = torch.argmin(t_masked, dim=1)
    r = torch.arange(o.shape[0], device=o.device)
    best_t = t_masked[r, best]
    return best_t < BIG_T, best_t, best, b1[r, best], b2[r, best]


def brute_force_occluded(o, d, v0, e1, e2, mint, maxt):
    """Dense any-hit oracle: True where [mint, maxt] is blocked."""
    return _dense(o, d, v0, e1, e2, mint, maxt)[0].any(dim=1)


def intersect_sphere(o, d, center, radius, mint, maxt):
    """Ray / sphere by the stable quadratic (src/GoblinSphere.cpp:12-80)
    -> (hit, t): the nearer root inside [mint, maxt], else the farther."""
    co = o - center
    A = vm.dot(d, d)
    B = 2.0 * vm.dot(co, d)
    C = vm.dot(co, co) - radius * radius
    has, t1, t2 = vm.quadratic(A, B, C)
    t1_ok = (t1 >= mint) & (t1 <= maxt)
    t2_ok = (t2 >= mint) & (t2 <= maxt)
    hit = has & (t1_ok | t2_ok)
    return hit, torch.where(hit, torch.where(t1_ok, t1, t2), BIG_T)


def intersect_disk(o, d, center, normal, radius, mint, maxt):
    """Ray / disk (the plane through center with `normal`, within radius)
    -> (hit, t)."""
    denom = vm.dot(d, normal)
    t = vm.dot(center - o, normal) / torch.where(denom == 0.0, 1e-30, denom)
    p = o + t[..., None] * d
    in_disk = vm.squared_length(p - center) <= radius * radius
    hit = (denom != 0.0) & (t >= mint) & (t <= maxt) & in_disk
    return hit, torch.where(hit, t, BIG_T)


def intersect_aabb(o, inv_d, bmin, bmax, mint, maxt):
    """Slab test, all arguments broadcast (reference src/GoblinBBox.cpp:57-77)
    -> (hit, t_near). o, inv_d, bmin, bmax: (..., 3)."""
    t0 = (bmin - o) * inv_d
    t1 = (bmax - o) * inv_d
    t_near = torch.maximum(torch.minimum(t0, t1).amax(dim=-1),
                           torch.as_tensor(mint, dtype=t0.dtype))
    t_far = torch.minimum(torch.maximum(t0, t1).amin(dim=-1),
                          torch.as_tensor(maxt, dtype=t0.dtype))
    return t_near <= t_far, t_near
