"""Wavefront scene intersection: BVH trace + hit refinement into a
fragment (port of goblin_tpu/scene/intersect.py for triangle scenes).

    frag = {hit, t, p, ns, ng, uv, dpdu, dpdv, mat, light, eps, wo,
            duv4, duv}

Epsilon convention: hit eps = 1e-3 * t (src/GoblinTriangle.cpp:84).
"""

from __future__ import annotations

import torch

from ..core import vecmath as vm
from ..ops.trace import TraceResult, trace, trace_bin

HIT_EPS_SCALE = 1e-3


def trace_rays(scene, meta, o, d, mint, maxt, any_hit=False) -> TraceResult:
    """Trace a wavefront through the scene's BVH at meta.trace_wide: 8 walks
    the BVH8 (ops.trace.trace), 1 the binary tree (ops.trace.trace_bin);
    each the CUDA kernel on the card and its plain version on the CPU."""
    if meta.trace_wide == 8:
        fn = trace
    elif meta.trace_wide == 1:
        fn = trace_bin
    else:
        raise ValueError(f"trace width {meta.trace_wide!r} has no kernel")
    return fn(scene, o.contiguous(), d.contiguous(), mint.contiguous(),
              maxt.contiguous(), any_hit=any_hit)


def intersect(scene, meta, o, d, mint, maxt, dxd=None, dyd=None):
    """Closest hit over the scene -> fragment dict.

    The traversal picks the triangle; t and the barycentrics are then
    recomputed by Moller-Trumbore on the gathered triangle (goblin_tpu's
    differentiable-recompute form, kept so values match). dxd/dyd: camera
    ray-differential directions; when given, the fragment carries uv
    differentials duv4 = [dudx, dvdx, dudy, dvdy] and widths duv.
    """
    res = trace_rays(scene, meta, o, d, mint, maxt)
    hit, tri = res.hit, res.tri
    tri_c = torch.clamp(tri, min=0).long()
    soup = scene["tri_rows"][tri_c]
    v0, e1, e2 = soup[..., 0:3], soup[..., 3:6], soup[..., 6:9]

    pvec = vm.cross(d, e2)
    det_mt = vm.dot(e1, pvec)
    inv_mt = 1.0 / torch.where(det_mt.abs() < 1e-20, 1.0, det_mt)
    tvec = o - v0
    b1_d = vm.dot(tvec, pvec) * inv_mt
    qvec = vm.cross(tvec, e1)
    b2_d = vm.dot(d, qvec) * inv_mt
    t_d = vm.dot(e2, qvec) * inv_mt
    tri_hit = hit & (det_mt.abs() >= 1e-20)
    t = torch.where(tri_hit, t_d, res.t)
    b1 = torch.where(tri_hit, b1_d, res.b1)
    b2 = torch.where(tri_hit, b2_d, res.b2)

    # miss lanes keep t = BIG_T; the shading point uses t = 1 there
    p = o + torch.where(hit, t, 1.0)[..., None] * d
    b0 = 1.0 - b1 - b2
    n_rows = scene["tri_n"][tri_c]  # (R, 3, 3)
    ns = vm.normalize(
        b0[..., None] * n_rows[..., 0, :] + b1[..., None] * n_rows[..., 1, :]
        + b2[..., None] * n_rows[..., 2, :],
        eps=1e-30,
    )
    ng = vm.normalize(vm.cross(e1, e2), eps=1e-30)
    uv_rows = scene["tri_uv"][tri_c]  # (R, 3, 2)
    uv = (b0[..., None] * uv_rows[..., 0, :] + b1[..., None] * uv_rows[..., 1, :]
          + b2[..., None] * uv_rows[..., 2, :])
    # dpdu / dpdv from the uv edge matrix (src/GoblinTriangle.cpp:107-122)
    du1 = uv_rows[..., 1, 0] - uv_rows[..., 0, 0]
    dv1 = uv_rows[..., 1, 1] - uv_rows[..., 0, 1]
    du2 = uv_rows[..., 2, 0] - uv_rows[..., 0, 0]
    dv2 = uv_rows[..., 2, 1] - uv_rows[..., 0, 1]
    det = du1 * dv2 - dv1 * du2
    degenerate = det.abs() < 1e-20
    inv_det = 1.0 / torch.where(degenerate, 1.0, det)
    dpdu = inv_det[..., None] * (dv2[..., None] * e1 - dv1[..., None] * e2)
    dpdv = inv_det[..., None] * (-du2[..., None] * e1 + du1[..., None] * e2)
    fallback_u, fallback_v = vm.coordinate_system(ns)
    dpdu = torch.where(degenerate[..., None], fallback_u, dpdu)
    dpdv = torch.where(degenerate[..., None], fallback_v, dpdv)

    frag = {
        "hit": hit,
        "t": t,
        "p": p,
        "ns": ns,
        "ng": ng,
        "uv": uv,
        "dpdu": dpdu,
        "dpdv": dpdv,
        "mat": torch.where(hit, scene["tri_mat"][tri_c], 0),
        "light": torch.where(hit, scene["tri_light"][tri_c], -1),
        "eps": HIT_EPS_SCALE * torch.where(hit, t, 1.0),
        "wo": -d,
    }
    if dxd is not None:
        frag["duv4"], frag["duv"] = _uv_differentials(
            o, dxd, dyd, p, ng, dpdu, dpdv, hit
        )
    else:
        frag["duv4"] = torch.zeros(t.shape + (4,), dtype=t.dtype, device=t.device)
        frag["duv"] = torch.zeros(t.shape + (2,), dtype=t.dtype, device=t.device)
    return frag


def _uv_differentials(o, dxd, dyd, p, n, dpdu, dpdv, hit):
    """Solve dpdx = dudx * dpdu + dvdx * dpdv (and for y) on the two axes
    that drop n's dominant one (reference computeUVDifferential). Aux rays
    share the primary origin. Returns (duv4 (R, 4), duv (R, 2))."""
    pon = vm.dot(p - o, n)

    def plane_hit(dd):
        den = vm.dot(dd, n)
        ok = den.abs() > 1e-12
        tt = pon / torch.where(ok, den, 1.0)
        return o + tt[..., None] * dd - p, ok & (tt > 0.0)

    dpdx, okx = plane_hit(dxd)
    dpdy, oky = plane_hit(dyd)
    an = n.abs()
    ax_x = torch.where(an[..., 0] > torch.maximum(an[..., 1], an[..., 2]), 1, 0)
    ax_y = torch.where(an[..., 2] > torch.maximum(an[..., 0], an[..., 1]), 1, 2)

    def pick(v, ax):
        return torch.gather(v, -1, ax[..., None])[..., 0]

    a11, a12 = pick(dpdu, ax_x), pick(dpdv, ax_x)
    a21, a22 = pick(dpdu, ax_y), pick(dpdv, ax_y)
    det = a11 * a22 - a12 * a21
    ok_det = det.abs() > 1e-16
    inv = 1.0 / torch.where(ok_det, det, 1.0)

    def solve(dp, ok):
        q1, q2 = pick(dp, ax_x), pick(dp, ax_y)
        du = (a22 * q1 - a12 * q2) * inv
        dv = (a11 * q2 - a21 * q1) * inv
        valid = ok & ok_det & hit
        return torch.where(valid, du, 0.0), torch.where(valid, dv, 0.0)

    dudx, dvdx = solve(dpdx, okx)
    dudy, dvdy = solve(dpdy, oky)
    duv4 = torch.stack([dudx, dvdx, dudy, dvdy], dim=-1)
    duv = torch.stack([torch.maximum(dudx.abs(), dudy.abs()),
                       torch.maximum(dvdx.abs(), dvdy.abs())], dim=-1)
    return duv4, duv


def occluded(scene, meta, o, d, mint, maxt):
    """Any-hit shadow query: True where the segment [mint, maxt] is
    blocked."""
    return trace_rays(scene, meta, o, d, mint, maxt, any_hit=True).hit


def occluded_attenuated(scene, meta, o, d, mint, maxt):
    """Shadow query with its attenuation (R, 3). Without mask (null-lobe)
    materials, which this port does not load yet, nothing attenuates: the
    plain any-hit query and a transmittance of one."""
    occ = occluded(scene, meta, o, d, mint, maxt)
    return occ, torch.ones(o.shape[:-1] + (3,), dtype=o.dtype, device=o.device)
