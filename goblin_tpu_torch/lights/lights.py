"""Light table: batched sampling and evaluation of point, spot,
directional and area lights (port of goblin_tpu/lights/lights.py).

Semantics of the reference (src/GoblinLight.{h,cpp}): point Li = I / r^2;
spot adds the cone falloff ((cos - cosMax) / (cosStart - cosMax))^4;
directional is parallel radiance; these three are delta lights: sample_li
returns pdf 1 and is_delta, and MIS is skipped for them. An area light
emits one-sided Le (dot(n, w) > 0) from world-space triangles, picked by
an area CDF inside the light's segment of the emissive-triangle table and
sampled uniformly (solid-angle pdf r^2 / (|cos| A)), or from one analytic
sphere, cone-sampled from outside and area-sampled from inside (reference
GoblinSphere.cpp:108-150). The emission side (sample_emission,
eval_emission, pdf_emission_*) starts and weighs light walks. Rows are
plain gathers by light id. Environment lights are refused by the loader
(ROADMAP Queue 1 item 12), so their arms are absent.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..core import sampling as sp
from ..core import vecmath as vm

LIGHT_POINT = 0
LIGHT_DIRECTIONAL = 1
LIGHT_SPOT = 2
LIGHT_AREA = 3
LIGHT_IBL = 4
DELTA_LIGHTS = (LIGHT_POINT, LIGHT_DIRECTIONAL, LIGHT_SPOT)


@dataclass
class LightsBuild:
    """Host-side accumulation during the scene load."""

    types: list = field(default_factory=list)
    colors: list = field(default_factory=list)  # intensity / radiance / Le
    positions: list = field(default_factory=list)
    directions: list = field(default_factory=list)
    cos_theta_max: list = field(default_factory=list)
    cos_falloff_start: list = field(default_factory=list)
    sample_nums: list = field(default_factory=list)
    areas: list = field(default_factory=list)  # world area (area lights)

    def add(self, ltype, color, position=(0, 0, 0), direction=(0, 0, 1),
            cos_theta_max=-1.0, cos_falloff_start=-1.0, sample_num=1,
            area=0.0) -> int:
        self.types.append(ltype)
        self.colors.append(np.asarray(color, np.float32))
        self.positions.append(np.asarray(position, np.float32))
        d = np.asarray(direction, np.float32)
        n = np.linalg.norm(d)
        self.directions.append(d / n if n > 0 else np.float32([0, 0, 1]))
        self.cos_theta_max.append(cos_theta_max)
        self.cos_falloff_start.append(cos_falloff_start)
        self.sample_nums.append(sample_num)
        self.areas.append(area)
        return len(self.types) - 1


def bake_lights(build: LightsBuild, em_tri_light, em_tri_area, world_center,
                world_radius: float, device, sph_center=None, sph_radius=None,
                is_sphere=None) -> dict:
    """-> the light table, a dict of tensors on device. Light powers feed
    the pick CDF (reference Scene ctor, luminance of power()); the world's
    bounding sphere places directional emission.

    em_tri_light (E,): light id of each emissive triangle, in light order,
    so each light's triangles are one segment; em_tri_area (E,): their
    world areas. sph_center (L, 3), sph_radius (L,), is_sphere (L,): the
    analytic sphere emitter of each light that has one. The entry
    "static" holds what the sampling code branches on without reading the
    device: the non-empty segments and whether any sphere emits.
    """
    for t in build.types:
        if t not in DELTA_LIGHTS and t != LIGHT_AREA:
            raise NotImplementedError(
                f"light type {t} is not in goblin_tpu_torch yet (ROADMAP "
                "Queue 1 item 12)")
    L = max(1, len(build.types))
    types = np.asarray(build.types or [LIGHT_POINT], np.int32)
    colors = np.asarray(build.colors or [np.zeros(3)], np.float32).reshape(L, 3)
    areas = np.asarray(build.areas or [0.0], np.float32)
    lum = 0.212671 * colors[:, 0] + 0.715160 * colors[:, 1] + 0.072169 * colors[:, 2]
    power = np.zeros(L, np.float32)
    for i, t in enumerate(types):
        if t == LIGHT_POINT:
            power[i] = 4.0 * np.pi * lum[i]
        elif t == LIGHT_DIRECTIONAL:
            power[i] = np.pi * world_radius ** 2 * lum[i]
        elif t == LIGHT_SPOT:
            ctm = build.cos_theta_max[i]
            cfs = build.cos_falloff_start[i]
            power[i] = lum[i] * 2.0 * np.pi * (1.0 - 0.5 * (ctm + cfs))
        elif t == LIGHT_AREA:
            power[i] = lum[i] * np.pi * areas[i]
    if power.sum() <= 0.0:
        power[:] = 1.0

    # per-light segments of emissive triangles, an area CDF inside each
    E = len(em_tri_light)
    em_light = np.asarray(em_tri_light, np.int32) if E else np.zeros(0, np.int32)
    em_area = np.asarray(em_tri_area, np.float32) if E else np.zeros(0, np.float32)
    seg_start = np.zeros(L + 1, np.int32)
    for i in range(L):
        seg_start[i + 1] = seg_start[i] + int((em_light == i).sum())
    em_cdf = np.zeros(E, np.float32)
    for i in range(L):
        s, e = seg_start[i], seg_start[i + 1]
        if e > s:
            c = np.cumsum(em_area[s:e])
            em_cdf[s:e] = c / c[-1]
    if is_sphere is None:
        sph_center = np.zeros((L, 3), np.float32)
        sph_radius = np.zeros(L, np.float32)
        is_sphere = np.zeros(L, bool)
    tables = {
        "type": types,
        "color": colors,
        "position": np.asarray(build.positions or [np.zeros(3)],
                               np.float32).reshape(L, 3),
        "direction": np.asarray(build.directions or [np.float32([0, 0, 1])],
                                np.float32).reshape(L, 3),
        "cos_theta_max": np.asarray(build.cos_theta_max or [-1.0], np.float32),
        "cos_falloff_start": np.asarray(build.cos_falloff_start or [-1.0],
                                        np.float32),
        "area": areas,
        "power": power,
        "power_cdf": np.cumsum(power) / power.sum(),
        "seg_start": seg_start,
        "em_cdf": em_cdf,
        "em_light": em_light,
        "world_center": np.asarray(world_center, np.float32),
        "world_radius": np.float32(world_radius),
        "sph_center": np.asarray(sph_center, np.float32),
        "sph_radius": np.asarray(sph_radius, np.float32),
        "is_sphere": np.asarray(is_sphere, bool),
    }
    lights = {k: torch.as_tensor(v, device=device) for k, v in tables.items()}
    lights["static"] = {
        "segments": tuple((i, int(seg_start[i]), int(seg_start[i + 1]))
                          for i in range(L) if seg_start[i + 1] > seg_start[i]),
        "has_sphere": bool(np.any(is_sphere)),
        "has_area": bool(np.any(types == LIGHT_AREA)),
    }
    return lights


def pick_light(lights, u):
    """Power-weighted light pick (reference Scene::sampleLight).
    Returns (light_id (R,), pick_pdf (R,))."""
    cdf = lights["power_cdf"]
    idx = (cdf[None, :] <= u[:, None]).sum(dim=-1)
    idx = torch.clamp(idx, 0, cdf.shape[0] - 1)
    return idx, lights["power"][idx] / lights["power"].sum()


def spot_falloff(lights, lid, w):
    """Spot cone falloff for world direction w leaving the light."""
    cos_t = vm.dot(w, lights["direction"][lid])
    ctm = lights["cos_theta_max"][lid]
    cfs = lights["cos_falloff_start"][lid]
    delta = torch.clamp((cos_t - ctm) / torch.clamp(cfs - ctm, min=1e-12),
                        0.0, 1.0)
    f = (delta * delta) * (delta * delta)
    return torch.where(cos_t < ctm, 0.0, torch.where(cos_t > cfs, 1.0, f))


def _rescale_cdf_u(em_cdf, tri, seg0, u):
    """Remap u into [0, 1) within its chosen cdf cell: (u - lo) / (hi - lo)
    with lo = cdf[tri - 1] (0 at the segment start) and hi = cdf[tri].
    Given that u fell into cell tri it is uniform on [lo, hi), so the remap
    is uniform on [0, 1), as a nonlinear warp needs."""
    hi = em_cdf[tri]
    lo = torch.where(tri > seg0, em_cdf[torch.clamp(tri - 1, min=0)], 0.0)
    return torch.clamp((u - lo) / torch.clamp(hi - lo, min=1e-12),
                       0.0, 1.0 - 1e-7)


def _pick_emissive_triangle(lights, lid, u):
    """The triangle of light lid's segment that u picks by area: the
    segment's start plus the count of its entries with em_cdf < u (strict),
    clipped to the table -> (tri (R,) int64, u rescaled within the cell).
    Each non-empty segment is searched for every lane (its cdf is sorted)
    and the lanes of its light keep the answer, which is goblin_tpu's
    count over all E entries without the R x E compare."""
    em_cdf = lights["em_cdf"]
    seg0 = lights["seg_start"][lid].long()
    below = torch.zeros_like(seg0)
    for light, s, e in lights["static"]["segments"]:
        n = torch.searchsorted(em_cdf[s:e], u)  # entries < u
        below = torch.where(lid == light, n, below)
    tri = torch.clamp(seg0 + below, 0, em_cdf.shape[0] - 1)
    return tri, _rescale_cdf_u(em_cdf, tri, seg0, u)


def _sphere_cos_max(sr, sd2):
    """Cosine of the cone a sphere of radius sr subtends at squared distance
    sd2, kept below 1 (a zero-radius row would give a cone pdf of 1 / 0)."""
    cm2 = 1.0 - torch.clamp(sr * sr / sd2, 0.0, 1.0)
    cos_max = torch.where(cm2 > 1e-12, torch.sqrt(torch.clamp(cm2, min=0.0)),
                          0.0)
    return torch.clamp(cos_max, max=1.0 - 1e-7)


def sample_li(lights, tri_data, lid, p, eps, u1, u2):
    """Sample incident illumination at p from light lid (all (R,) batched).

    tri_data: {"em_rows": (E, 12)} emissive triangles [v0, e1, e2, n] in
    segment order. Returns dict: Li (R, 3), wi (R, 3), pdf (R,),
    shadow_maxt (R,), is_delta (R,), dist (R,).
    """
    static = lights["static"]
    ltype = lights["type"][lid]
    lcolor = lights["color"][lid]

    # point / spot: direction to the position
    to_l = lights["position"][lid] - p
    dist2 = torch.clamp(vm.squared_length(to_l), min=1e-20)
    dist = torch.sqrt(dist2)
    wi_pos = to_l / dist[..., None]
    li_point = lcolor / dist2[..., None]
    li_spot = li_point * spot_falloff(lights, lid, -wi_pos)[..., None]

    is_point = ltype == LIGHT_POINT
    is_dir = ltype == LIGHT_DIRECTIONAL
    is_spot = ltype == LIGHT_SPOT
    is_sphere = lights["is_sphere"][lid]
    is_area = (ltype == LIGHT_AREA) & ~is_sphere

    wi = torch.where(is_dir[..., None], -lights["direction"][lid], wi_pos)
    Li = torch.where(
        is_point[..., None], li_point,
        torch.where(is_spot[..., None], li_spot,
                    torch.where(is_dir[..., None], lcolor, 0.0)))
    pdf = torch.ones_like(dist)
    shadow_maxt = torch.where(is_dir, 3.0e37, dist - eps)
    dist_out = dist

    # area: a triangle of the light's segment by its area cdf, a uniform
    # point on it (an area light without triangles or sphere keeps Li = 0)
    if lights["em_cdf"].shape[0] > 0:
        tri, u1r = _pick_emissive_triangle(lights, lid, u1)
        erows = tri_data["em_rows"][tri]
        v0, e1, e2, n = (erows[..., 0:3], erows[..., 3:6], erows[..., 6:9],
                         erows[..., 9:12])
        bu, bv = sp.uniform_sample_triangle(u1r, u2)
        to_s = v0 + bu[..., None] * e1 + bv[..., None] * e2 - p
        d2 = torch.clamp(vm.squared_length(to_s), min=1e-20)
        dist_a = torch.sqrt(d2)
        wi_area = to_s / dist_a[..., None]
        cos_l = vm.dot(n, -wi_area)
        # solid-angle pdf r^2 / (|cos| A) (reference Geometry::pdf)
        pdf_area = d2 / torch.clamp(cos_l.abs() * lights["area"][lid],
                                    min=1e-12)
        a = is_area[..., None]
        wi = torch.where(a, wi_area, wi)
        Li = torch.where(a, torch.where((cos_l > 0.0)[..., None], lcolor, 0.0),
                         Li)
        pdf = torch.where(is_area, pdf_area, pdf)
        shadow_maxt = torch.where(is_area, dist_a - eps, shadow_maxt)
        dist_out = torch.where(is_area, dist_a, dist_out)

    # sphere: a direction in the cone the sphere subtends, its near hit
    # (reference Sphere::sample(p, u1, u2)); from inside, a uniform point on
    # the surface with the area pdf
    if static["has_sphere"]:
        sc = lights["sph_center"][lid]
        sr = torch.where(is_sphere,
                         torch.clamp(lights["sph_radius"][lid], min=1e-6), 1.0)
        v = p - sc
        far = torch.tensor([0.0, 0.0, 4.0], dtype=v.dtype, device=v.device)
        v = torch.where(
            (is_sphere & (vm.squared_length(v) > 1e-12))[..., None], v, far)
        sd2 = torch.clamp(vm.squared_length(v), min=1e-20)
        outside = (sd2 - sr * sr) > 1e-4
        z_ax = vm.normalize(-v, eps=1e-30)
        x_ax, y_ax = vm.coordinate_system(z_ax)
        cos_max = _sphere_cos_max(sr, sd2)
        cone = sp.uniform_sample_cone(u1, u2, cos_max)
        w_cone = (cone[..., 0:1] * x_ax + cone[..., 1:2] * y_ax
                  + cone[..., 2:3] * z_ax)
        # rays that graze past take t = d cos(theta_max), like the reference
        b_q = vm.dot(w_cone, -v)
        disc = b_q * b_q - (sd2 - sr * sr)
        d_ok = disc > 1e-12
        t_hit = torch.where(d_ok,
                            b_q - torch.sqrt(torch.where(d_ok, disc, 1.0)),
                            torch.sqrt(sd2) * cos_max)
        ps_out = p + t_hit[..., None] * w_cone
        ps_in = sc + sr[..., None] * sp.uniform_sample_sphere(u1, u2)
        ps_s = torch.where(outside[..., None], ps_out, ps_in)
        ns_s = vm.normalize(ps_s - sc, eps=1e-30)
        to_ss = ps_s - p
        sdist2 = torch.clamp(vm.squared_length(to_ss), min=1e-20)
        sdist = torch.sqrt(sdist2)
        wi_sph = to_ss / sdist[..., None]
        cos_sl = vm.dot(ns_s, -wi_sph)
        pdf_sph = torch.where(
            outside, sp.uniform_cone_pdf(cos_max),
            sdist2 / torch.clamp(cos_sl.abs() * lights["area"][lid],
                                 min=1e-12))
        a = is_sphere[..., None]
        wi = torch.where(a, wi_sph, wi)
        Li = torch.where(a, torch.where((cos_sl > 0.0)[..., None], lcolor, 0.0),
                         Li)
        pdf = torch.where(is_sphere, pdf_sph, pdf)
        shadow_maxt = torch.where(is_sphere, sdist - eps, shadow_maxt)
        dist_out = torch.where(is_sphere, sdist, dist_out)

    return {
        "Li": Li,
        "wi": wi,
        "pdf": pdf,
        "shadow_maxt": shadow_maxt,
        "is_delta": is_point | is_dir | is_spot,
        "dist": dist_out,
    }


def pdf_li(lights, lid, p, wi, hit_t, hit_cos, hit_light):
    """Solid-angle pdf that light lid generates direction wi from p, given
    the BSDF ray's hit (t, cosine at the light, hit light id), for MIS on
    the BSDF-sampling side: r^2 / (|cos| A) for a triangle light, the cone
    pdf for a sphere seen from outside (reference Sphere::pdf), 0 where the
    hit is not this light, and 0 for delta lights, which no ray hits."""
    static = lights["static"]
    if not static["has_area"]:
        return torch.zeros_like(hit_t)
    is_sphere = lights["is_sphere"][lid]
    is_area = (lights["type"][lid] == LIGHT_AREA) & ~is_sphere
    ok = (is_area | is_sphere) & (hit_light == lid)
    # miss lanes carry t = 3e38, whose square is inf
    t_ok = torch.where(ok, hit_t, 1.0)
    pdf = (t_ok * t_ok) / torch.clamp(hit_cos.abs() * lights["area"][lid],
                                      min=1e-12)
    if static["has_sphere"]:
        v = p - lights["sph_center"][lid]
        sd2 = torch.clamp(vm.squared_length(v), min=1e-20)
        sr = lights["sph_radius"][lid]
        outside = (sd2 - sr * sr) > 1e-4
        pdf = torch.where(
            is_sphere & outside,
            sp.uniform_cone_pdf(_sphere_cos_max(sr, sd2)), pdf)
    return torch.where(ok, pdf, 0.0)


def sample_emission(lights, tri_data, lid, u_p1, u_p2, u_d1, u_d2):
    """Photon emission (the light walk's start), reference
    samplePosition / sampleDirection: point -> uniform sphere; spot ->
    uniform cone; directional -> a point on the disk of the world's
    bounding sphere, fixed direction; area -> an area-uniform point of the
    light's triangles (or of its sphere) and a cosine-weighted direction
    about the normal there.

    tri_data: {"em_rows": (E, 12)} emissive triangles in segment order.
    Returns dict: p (R, 3), n (R, 3) (zeros for delta positions), dir
    (R, 3), pdf_pos (R,), pdf_dir (R,), is_delta (R,).
    """
    static = lights["static"]
    ltype = lights["type"][lid]
    lpos = lights["position"][lid]
    ldir = lights["direction"][lid]
    wc = lights["world_center"]
    wr = lights["world_radius"]
    ctm = lights["cos_theta_max"][lid]
    is_point = ltype == LIGHT_POINT
    is_dir = ltype == LIGHT_DIRECTIONAL
    is_spot = ltype == LIGHT_SPOT
    is_area = ltype == LIGHT_AREA

    x_ax, y_ax = vm.coordinate_system(ldir)
    disk = sp.uniform_sample_disk(u_p1, u_p2)
    p_dir = (wc + wr * (disk[..., 0:1] * x_ax + disk[..., 1:2] * y_ax)
             - ldir * wr)
    p = torch.where(is_dir[..., None], p_dir, lpos)
    pdf_pos = torch.where(is_dir, 1.0 / (np.pi * wr * wr), 1.0)

    d_sphere = sp.uniform_sample_sphere(u_d1, u_d2)
    cone = sp.uniform_sample_cone(u_d1, u_d2, ctm)
    d_cone = (cone[..., 0:1] * x_ax + cone[..., 1:2] * y_ax
              + cone[..., 2:3] * ldir)
    d = torch.where(is_dir[..., None], ldir,
                    torch.where(is_spot[..., None], d_cone, d_sphere))
    pdf_dir = torch.where(
        is_point, sp.uniform_sphere_pdf(),
        torch.where(is_spot, sp.uniform_cone_pdf(ctm), 1.0))
    n = torch.zeros_like(p)

    if static["has_area"]:
        # without triangles the position falls back to the light's own
        p_area, n_area = lpos, ldir
        if lights["em_cdf"].shape[0] > 0:
            tri, u1r = _pick_emissive_triangle(lights, lid, u_p1)
            erows = tri_data["em_rows"][tri]
            bu, bv = sp.uniform_sample_triangle(u1r, u_p2)
            p_area = (erows[..., 0:3] + bu[..., None] * erows[..., 3:6]
                      + bv[..., None] * erows[..., 6:9])
            n_area = erows[..., 9:12]
        if static["has_sphere"]:
            # uniform surface position (reference Sphere::sample(u1, u2))
            is_sph = lights["is_sphere"][lid][..., None]
            sph_n = sp.uniform_sample_sphere(u_p1, u_p2)
            p_sph = (lights["sph_center"][lid]
                     + lights["sph_radius"][lid][..., None] * sph_n)
            p_area = torch.where(is_sph, p_sph, p_area)
            n_area = torch.where(is_sph, sph_n, n_area)
        cos_local = sp.cosine_sample_hemisphere(u_d1, u_d2)
        ax, ay = vm.coordinate_system(n_area)
        d_cos = (cos_local[..., 0:1] * ax + cos_local[..., 1:2] * ay
                 + cos_local[..., 2:3] * n_area)
        a = is_area[..., None]
        p = torch.where(a, p_area, p)
        n = torch.where(a, n_area, n)
        d = torch.where(a, d_cos, d)
        pdf_pos = torch.where(
            is_area, 1.0 / torch.clamp(lights["area"][lid], min=1e-20),
            pdf_pos)
        pdf_dir = torch.where(
            is_area,
            torch.clamp(cos_local[..., 2], min=0.0) * (1.0 / np.pi), pdf_dir)
    return {
        "p": p, "n": n, "dir": d,
        "pdf_pos": pdf_pos, "pdf_dir": pdf_dir,
        "is_delta": is_point | is_dir | is_spot,
    }


def eval_emission(lights, lid, n_light, wo, env_le=None):
    """Emitted intensity / radiance toward wo (reference Light::eval):
    point -> I; spot -> I times the cone falloff; directional -> L only
    along its own direction; area -> Le on the side of n_light. env_le, the
    environment's radiance, belongs to image-based lights, which are
    refused (ROADMAP Queue 1 item 12)."""
    if env_le is not None:
        raise NotImplementedError("image-based light emission is not in "
                                  "goblin_tpu_torch yet (ROADMAP Queue 1 "
                                  "item 12)")
    ltype = lights["type"][lid]
    lcolor = lights["color"][lid]
    spot = spot_falloff(lights, lid, wo)[..., None] * lcolor
    parallel = (vm.dot(wo, lights["direction"][lid]) - 1.0).abs() < 1e-5
    dir_e = torch.where(parallel[..., None], lcolor, 0.0)
    area_e = torch.where((vm.dot(n_light, wo) > 0.0)[..., None], lcolor, 0.0)
    return torch.where(
        (ltype == LIGHT_POINT)[..., None], lcolor,
        torch.where((ltype == LIGHT_SPOT)[..., None], spot,
                    torch.where((ltype == LIGHT_DIRECTIONAL)[..., None], dir_e,
                                torch.where((ltype == LIGHT_AREA)[..., None],
                                            area_e, 0.0))))


def pdf_emission_direction(lights, lid, n_light, w):
    """Light::pdfDirection, the solid-angle pdf of emitting direction w:
    point -> 1 / 4 pi; spot -> the cone pdf (the falloff is ignored, as in
    the reference); directional -> 0; area -> cos / pi, one-sided."""
    ltype = lights["type"][lid]
    cone = sp.uniform_cone_pdf(lights["cos_theta_max"][lid])
    area_cos = vm.dot(n_light, w)
    return torch.where(
        ltype == LIGHT_POINT, sp.uniform_sphere_pdf(),
        torch.where(ltype == LIGHT_SPOT, cone,
                    torch.where(ltype == LIGHT_AREA,
                                torch.clamp(area_cos, min=0.0) * (1.0 / np.pi),
                                0.0)))


def pdf_emission_position(lights, lid):
    """Light::pdfPosition, the area pdf of the emission position:
    directional -> 1 / (pi r^2) on the world's disk; area -> 1 / A; a
    delta position -> 0."""
    ltype = lights["type"][lid]
    wr = lights["world_radius"]
    return torch.where(
        ltype == LIGHT_DIRECTIONAL, 1.0 / (np.pi * wr * wr),
        torch.where(ltype == LIGHT_AREA,
                    1.0 / torch.clamp(lights["area"][lid], min=1e-20), 0.0))
