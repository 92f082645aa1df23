"""Batched ray / analytic-primitive intersection (port of intersect_sphere
and intersect_disk of goblin_tpu/geometry/intersect.py).

World space, uniform scale: the bake turns an instance into a centre, a
radius and (for a disk) a frame. The triangle test lives with the BVH
traversal (ops/trace.py).
"""

from __future__ import annotations

import torch

from ..core import vecmath as vm

BIG_T = 3.0e38  # "no hit" distance (finite, so arithmetic stays finite)


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
