"""Wavefront scene intersection: BVH trace, analytic spheres and disks,
and hit refinement into a fragment (port of goblin_tpu/scene/intersect.py).

    frag = {is_lens, hit, t, p, ns, ng, uv, dpdu, dpdv, mat, light, eps,
            wo, duv4, duv}

The triangles go through the BVH; the scene's few spheres and disks are
tested densely after it, in that order, and a primitive wins a lane only
where it is strictly nearer than what the lane holds (so of equal t the
triangle stays, then the sphere, and of two spheres the first).
Epsilon convention: hit eps = 1e-3 * t (src/GoblinTriangle.cpp:84).
"""

from __future__ import annotations

import math

import torch

from ..core import vecmath as vm
from ..geometry.intersect import BIG_T, intersect_sphere
from ..integrators.materials import COL_TYPE, _pick, gather_material
from ..ops.trace import TraceResult, trace, trace_bin
from ..shading.bsdf import MAT_MASK

HIT_EPS_SCALE = 1e-3


def trace_rays(scene, meta, o, d, mint, maxt, any_hit=False) -> TraceResult:
    """Trace a wavefront through the scene's BVH at meta.trace_wide: 8 and
    4 walk the collapsed tree of that width (ops.trace.trace), 1 the binary
    tree (ops.trace.trace_bin); each the CUDA kernel on the card and its
    plain version on the CPU."""
    rays = (o.contiguous(), d.contiguous(), mint.contiguous(),
            maxt.contiguous())
    if meta.trace_wide in (4, 8):
        return trace(scene, *rays, any_hit=any_hit, width=meta.trace_wide)
    if meta.trace_wide == 1:
        return trace_bin(scene, *rays, any_hit=any_hit)
    raise ValueError(f"trace width {meta.trace_wide!r} has no kernel")


def _sphere_pass(scene, o, d, mint, cur_t):
    """Dense test against the analytic spheres -> (id, t): id = -1 where no
    sphere beats cur_t."""
    best_t = cur_t
    best = torch.full(o.shape[:-1], -1, dtype=torch.int32, device=o.device)
    for s in range(scene["sph_center"].shape[0]):  # a few
        hit, t = intersect_sphere(o, d, scene["sph_center"][s],
                                  scene["sph_radius"][s], mint, best_t)
        upd = hit & (t < best_t)
        best_t = torch.where(upd, t, best_t)
        best = torch.where(upd, s, best)
    return best, best_t


def _disk_pass(scene, o, d, mint, cur_t):
    """Dense test against the analytic z = 0 disks in their world-space
    plane form (reference GoblinDisk.cpp:12-56) -> (id, t)."""
    best_t = cur_t
    best = torch.full(o.shape[:-1], -1, dtype=torch.int32, device=o.device)
    for k in range(scene["dsk_center"].shape[0]):  # a few
        c = scene["dsk_center"][k]
        n = scene["dsk_n"][k]
        r = scene["dsk_radius"][k]
        den = vm.dot(d, n)
        ok_den = den.abs() > 1e-7
        t = vm.dot(c - o, n) / torch.where(ok_den, den, 1.0)
        q = o + t[..., None] * d - c
        upd = (ok_den & (vm.squared_length(q) <= r * r) & (t >= mint)
               & (t < best_t))
        best_t = torch.where(upd, t, best_t)
        best = torch.where(upd, k, best)
    return best, best_t


def intersect(scene, meta, o, d, mint, maxt, dxd=None, dyd=None):
    """Closest hit over the scene -> fragment dict.

    The traversal picks the triangle; t and the barycentrics are then
    recomputed by Moller-Trumbore on the gathered triangle (goblin_tpu's
    differentiable-recompute form, kept so values match). Spheres and disks
    that are nearer take the lane with their own shading frame. dxd/dyd: camera
    ray-differential directions; when given, the fragment carries uv
    differentials duv4 = [dudx, dvdx, dudy, dvdy] and widths duv.
    """
    res = trace_rays(scene, meta, o, d, mint, maxt)
    hit, tri, t = res.hit, res.tri, res.t
    sph_hit = dsk_hit = torch.zeros_like(hit)
    if meta.n_spheres > 0:
        sph_id, t2 = _sphere_pass(scene, o, d, mint, t)
        sph_hit = sph_id >= 0
        hit = hit | sph_hit
        t = torch.where(sph_hit, t2, t)
    if meta.n_disks > 0:
        dsk_id, t3 = _disk_pass(scene, o, d, mint, t)
        dsk_hit = dsk_id >= 0
        hit = hit | dsk_hit
        t = torch.where(dsk_hit, t3, t)
        sph_hit = sph_hit & ~dsk_hit  # a closer disk wins the lane

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
    tri_hit = (hit & ~sph_hit & ~dsk_hit & (tri >= 0)
               & (det_mt.abs() >= 1e-20))
    t = torch.where(tri_hit, t_d, t)
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

    mat = scene["tri_mat"][tri_c]
    light = scene["tri_light"][tri_c]
    dpdu_deriv = dpdu  # the derivative of p by u, which duv solves with

    if meta.n_spheres > 0:
        sid = torch.clamp(sph_id, min=0).long()
        sr = scene["sph_radius"][sid]
        ns_s = vm.normalize(p - scene["sph_center"][sid], eps=1e-30)
        # spherical uv (phi / 2 pi, theta / pi), dpdu along the longitude
        phi = vm.spherical_phi(ns_s)
        theta = vm.spherical_theta(ns_s)
        uv_s = torch.stack([phi / (2 * math.pi), theta / math.pi], dim=-1)
        dpdu_s = torch.stack([-ns_s[..., 1], ns_s[..., 0],
                              torch.zeros_like(phi)], dim=-1)
        dpdu_s = torch.where(vm.squared_length(dpdu_s)[..., None] < 1e-12,
                             vm.coordinate_system(ns_s)[0], dpdu_s)
        # dpdv along the latitude, scaled to v = theta / pi (reference
        # src/GoblinSphere.cpp:61-75)
        st, ct = torch.sin(theta), torch.cos(theta)
        dpdv_s = (math.pi * sr)[..., None] * torch.stack(
            [ct * torch.cos(phi), ct * torch.sin(phi), -st], dim=-1)
        m = sph_hit[..., None]
        ns = torch.where(m, ns_s, ns)
        ng = torch.where(m, ns_s, ng)
        uv = torch.where(m, uv_s, uv)
        dpdu_deriv = torch.where(m, (2 * math.pi) * sr[..., None] * dpdu_s,
                                 dpdu)
        dpdu = torch.where(m, dpdu_s, dpdu)
        dpdv = torch.where(m, dpdv_s, dpdv)
        mat = torch.where(sph_hit, scene["sph_mat"][sid], mat)
        light = torch.where(sph_hit, scene["sph_light"][sid], light)

    is_lens = torch.zeros_like(hit)
    if meta.n_disks > 0:
        # the disk's frame (reference GoblinDisk.cpp:31-61): uv = (phi / 2 pi,
        # r / R), dpdu = [-2 pi y, 2 pi x], dpdv = R [x, y] / r in its local
        # axes; the normal is its local +z
        did = torch.clamp(dsk_id, min=0).long()
        dn = scene["dsk_n"][did]
        du_ax = scene["dsk_u"][did]
        dr = scene["dsk_radius"][did]
        dv_ax = vm.cross(dn, du_ax)
        q = p - scene["dsk_center"][did]
        xl = vm.dot(q, du_ax)
        yl = vm.dot(q, dv_ax)
        rl = torch.sqrt(torch.clamp(xl * xl + yl * yl, min=1e-20))
        phi = torch.atan2(yl, xl)
        phi = torch.where(phi < 0.0, phi + 2.0 * math.pi, phi)
        uv_d = torch.stack([phi / (2.0 * math.pi),
                            rl / torch.clamp(dr, min=1e-20)], dim=-1)
        dpdu_d = (2.0 * math.pi) * (-yl[..., None] * du_ax
                                    + xl[..., None] * dv_ax)
        dpdv_d = (dr / rl)[..., None] * (xl[..., None] * du_ax
                                         + yl[..., None] * dv_ax)
        m = dsk_hit[..., None]
        ns = torch.where(m, dn, ns)
        ng = torch.where(m, dn, ng)
        uv = torch.where(m, uv_d, uv)
        dpdu = torch.where(m, dpdu_d, dpdu)
        dpdv = torch.where(m, dpdv_d, dpdv)
        dpdu_deriv = torch.where(m, dpdu_d, dpdu_deriv)
        mat = torch.where(dsk_hit, scene["dsk_mat"][did], mat)
        light = torch.where(dsk_hit, scene["dsk_light"][did], light)
        is_lens = dsk_hit & scene["dsk_lens"][did]

    frag = {
        "is_lens": is_lens,
        "hit": hit,
        "t": t,
        "p": p,
        "ns": ns,
        "ng": ng,
        "uv": uv,
        "dpdu": dpdu,
        "dpdv": dpdv,
        "mat": torch.where(hit, mat, 0),
        "light": torch.where(hit, light, -1),
        "eps": HIT_EPS_SCALE * torch.where(hit, t, 1.0),
        "wo": -d,
    }
    if dxd is not None:
        frag["duv4"], frag["duv"] = _uv_differentials(
            o, dxd, dyd, p, ng, dpdu_deriv, dpdv, hit
        )
    else:
        frag["duv4"] = torch.zeros(t.shape + (4,), dtype=t.dtype, device=t.device)
        frag["duv"] = torch.zeros(t.shape + (2,), dtype=t.dtype, device=t.device)
    if meta.has_perturb:
        frag = _perturb(scene, meta, frag)
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


def _perturb(scene, meta, frag):
    """Bump- and normal-map perturbation of the shading normal at hit time
    (reference Material::perturb called from Scene::intersect,
    src/GoblinMaterial.cpp:221-283, src/GoblinScene.cpp:75-83). Bump: a
    forward difference of the height map along u and v, over the lane's uv
    footprint but at least 5e-4 (a continuation fragment has no footprint),
    tilts dpdu and dpdv. Normal map: a tangent-space normal decoded from
    the color texture. Lanes whose material has neither stay as they are."""
    uv, ns, dpdu, dpdv = frag["uv"], frag["ns"], frag["dpdu"], frag["dpdv"]
    bump_id = scene["mat_bump"][frag["mat"]]
    norm_id = scene["mat_normal"][frag["mat"]]
    du = torch.clamp(frag["duv"][..., 0], min=5e-4)
    dv = torch.clamp(frag["duv"][..., 1], min=5e-4)
    zero = torch.zeros_like(du)
    bump_row = torch.clamp(bump_id, min=0).long()

    def height(uv_q):
        stack = meta.float_texture_system.eval_all(
            uv_q, scene["ftex_atlas"], scene["ftex_const"], p=frag["p"])
        return _pick(stack, bump_row)[..., 0]

    h0 = height(uv)
    dhdu = (height(uv + torch.stack([du, zero], dim=-1)) - h0) / du
    dhdv = (height(uv + torch.stack([zero, dv], dim=-1)) - h0) / dv
    bu = dpdu + dhdu[..., None] * ns
    bv = dpdv + dhdv[..., None] * ns
    n_bump = vm.normalize(vm.cross(bu, bv), eps=1e-30)
    # keep the side of the original shading normal
    n_bump = torch.where(vm.dotn(n_bump, ns) < 0.0, -n_bump, n_bump)
    has_bump = (bump_id >= 0)[..., None]
    ns = torch.where(has_bump, n_bump, ns)
    dpdu = torch.where(has_bump, bu, dpdu)
    dpdv = torch.where(has_bump, bv, dpdv)

    tex_stack = meta.texture_system.eval_all(
        uv, scene["tex_atlas"], scene["tex_const"], p=frag["p"])
    n_ts = 2.0 * _pick(tex_stack, torch.clamp(norm_id, min=0).long()) - 1.0
    t_ = vm.normalize(dpdu - vm.dotn(dpdu, ns) * ns, eps=1e-30)
    b_ = vm.cross(ns, t_)
    n_map = vm.normalize(
        n_ts[..., 0:1] * t_ + n_ts[..., 1:2] * b_ + n_ts[..., 2:3] * ns,
        eps=1e-30)
    ns = torch.where((norm_id >= 0)[..., None], n_map, ns)
    return dict(frag, ns=ns, dpdu=dpdu, dpdv=dpdv)


def occluded(scene, meta, o, d, mint, maxt):
    """Any-hit shadow query over triangles, spheres and disks (every disk,
    the camera lens included, as in goblin_tpu): True where the segment
    [mint, maxt] is blocked."""
    occ = trace_rays(scene, meta, o, d, mint, maxt, any_hit=True).hit
    if meta.n_spheres > 0:
        occ = occ | (_sphere_pass(scene, o, d, mint, maxt)[0] >= 0)
    if meta.n_disks > 0:
        occ = occ | (_disk_pass(scene, o, d, mint, maxt)[0] >= 0)
    return occ


def occluded_attenuated(scene, meta, o, d, mint, maxt, max_punch: int = 4):
    """Shadow query with punch-through of null-capable (mask) surfaces,
    which consumes no path depth: a mask surface never occludes, it
    attenuates by its null lobe (1 - alpha) * transparent_color, while any
    other hit blocks (reference occluded(ray, &isOpaque) and
    PathTracer::evalAttenuation, src/GoblinPathtracer.cpp:5-48, 95-113).
    Returns (occ, tr) with tr (R, 3).

    A scene without mask materials takes the plain any-hit query and a
    transmittance of one. With them, each of up to max_punch rounds is a
    closest-hit intersect of the lanes still open, from just past the
    last mask surface; a lane still open after the last round counts as
    occluded (the reference loops without bound)."""
    tr = torch.ones(o.shape[:-1] + (3,), dtype=o.dtype, device=o.device)
    if not meta.has_null:
        return occluded(scene, meta, o, d, mint, maxt), tr
    occ = torch.zeros_like(mint, dtype=torch.bool)
    done = maxt <= mint  # dead lanes start done
    cur_mint = mint
    for _ in range(max_punch):
        frag = intersect(scene, meta, o, d, torch.where(done, BIG_T, cur_mint),
                         torch.where(done, 0.0, maxt))
        hit = frag["hit"] & ~done
        is_mask = scene["mat_rows"][frag["mat"], COL_TYPE] == MAT_MASK
        blocked = hit & ~is_mask
        punch = hit & is_mask
        occ = occ | blocked
        mat = gather_material(scene, meta, frag)
        tr = torch.where(punch[..., None],
                         tr * (1.0 - mat["mask_alpha"])[..., None] * mat["c1"],
                         tr)
        cur_mint = torch.where(punch, frag["t"] + frag["eps"], cur_mint)
        done = (done | blocked | ~frag["hit"]
                | (punch & (tr <= 0.0).all(dim=-1)))
    return occ | ~done, tr
