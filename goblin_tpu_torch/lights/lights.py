"""Light table for delta lights: point, spot and directional (port of the
matching parts of goblin_tpu/lights/lights.py).

Semantics of the reference (src/GoblinLight.{h,cpp}): point Li = I / r^2;
spot adds the cone falloff ((cos - cosMax) / (cosStart - cosMax))^4;
directional is parallel radiance. All three are delta lights: sample_li
returns pdf 1 and is_delta, and MIS is skipped for them. The emission side
(sample_emission, eval_emission) starts the light walks of SPPM. Area and
environment lights are not in this port yet: the loader and bake_lights
refuse them (ROADMAP Queue 1 items 6b and 12), so their arms are absent.
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
DELTA_LIGHTS = (LIGHT_POINT, LIGHT_DIRECTIONAL, LIGHT_SPOT)


@dataclass
class LightsBuild:
    """Host-side accumulation during the scene load."""

    types: list = field(default_factory=list)
    colors: list = field(default_factory=list)  # intensity / radiance
    positions: list = field(default_factory=list)
    directions: list = field(default_factory=list)
    cos_theta_max: list = field(default_factory=list)
    cos_falloff_start: list = field(default_factory=list)

    def add(self, ltype, color, position=(0, 0, 0), direction=(0, 0, 1),
            cos_theta_max=-1.0, cos_falloff_start=-1.0) -> int:
        self.types.append(ltype)
        self.colors.append(np.asarray(color, np.float32))
        self.positions.append(np.asarray(position, np.float32))
        d = np.asarray(direction, np.float32)
        n = np.linalg.norm(d)
        self.directions.append(d / n if n > 0 else np.float32([0, 0, 1]))
        self.cos_theta_max.append(cos_theta_max)
        self.cos_falloff_start.append(cos_falloff_start)
        return len(self.types) - 1


def bake_lights(build: LightsBuild, world_center, world_radius: float,
                device) -> dict:
    """-> the light table, a dict of tensors on device. Light powers feed
    the pick CDF (reference Scene ctor, luminance of power()); the world's
    bounding sphere places directional emission."""
    for t in build.types:
        if t not in DELTA_LIGHTS:
            raise NotImplementedError(
                f"light type {t} is not in goblin_tpu_torch yet (ROADMAP "
                "Queue 1 items 6b and 12)")
    L = max(1, len(build.types))
    types = np.asarray(build.types or [LIGHT_POINT], np.int32)
    colors = np.asarray(build.colors or [np.zeros(3)], np.float32).reshape(L, 3)
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
    if power.sum() <= 0.0:
        power[:] = 1.0
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
        "power": power,
        "power_cdf": np.cumsum(power) / power.sum(),
        "world_center": np.asarray(world_center, np.float32),
        "world_radius": np.float32(world_radius),
    }
    return {k: torch.as_tensor(v, device=device) for k, v in tables.items()}


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


def sample_li(lights, lid, p, eps):
    """Sample incident illumination at p from light lid (all (R,) batched).

    Returns dict: Li (R, 3), wi (R, 3), pdf (R,), shadow_maxt (R,),
    is_delta (R,), dist (R,).
    """
    ltype = lights["type"][lid]
    lcolor = lights["color"][lid]
    to_l = lights["position"][lid] - p
    dist2 = torch.clamp(vm.squared_length(to_l), min=1e-20)
    dist = torch.sqrt(dist2)
    wi_pos = to_l / dist[..., None]
    li_point = lcolor / dist2[..., None]
    li_spot = li_point * spot_falloff(lights, lid, -wi_pos)[..., None]

    is_point = ltype == LIGHT_POINT
    is_dir = ltype == LIGHT_DIRECTIONAL
    is_spot = ltype == LIGHT_SPOT
    wi = torch.where(is_dir[..., None], -lights["direction"][lid], wi_pos)
    Li = torch.where(
        is_point[..., None], li_point,
        torch.where(is_spot[..., None], li_spot,
                    torch.where(is_dir[..., None], lcolor, 0.0)),
    )
    return {
        "Li": Li,
        "wi": wi,
        "pdf": torch.ones_like(dist),
        "shadow_maxt": torch.where(is_dir, 3.0e37, dist - eps),
        "is_delta": is_point | is_dir | is_spot,
        "dist": dist,
    }


def pdf_li(lights, lid, p, wi, hit_t, hit_cos, hit_light):
    """Solid-angle pdf that light lid generates direction wi from p, given
    the BSDF ray's hit (t, cosine at the light, hit light id), for MIS on
    the BSDF-sampling side. A BSDF ray never hits a delta light, so for
    every light this port loads it is 0 (goblin_tpu's area and sphere arms
    come with area lights)."""
    return torch.zeros_like(hit_t)


def sample_emission(lights, tri_data, lid, u_p1, u_p2, u_d1, u_d2):
    """Photon emission (the light walk's start), reference
    samplePosition / sampleDirection: point -> uniform sphere; spot ->
    uniform cone; directional -> a point on the disk of the world's
    bounding sphere, fixed direction.

    tri_data: {"em_rows": (E, 12)} emissive triangles; refused unless empty.
    Returns dict: p (R, 3), n (R, 3) (zeros: delta positions), dir (R, 3),
    pdf_pos (R,), pdf_dir (R,), is_delta (R,).
    """
    if tri_data["em_rows"].shape[0]:
        raise NotImplementedError("area-light emission is not in "
                                  "goblin_tpu_torch yet (ROADMAP Queue 1 "
                                  "item 6b)")
    ltype = lights["type"][lid]
    lpos = lights["position"][lid]
    ldir = lights["direction"][lid]
    wc = lights["world_center"]
    wr = lights["world_radius"]
    ctm = lights["cos_theta_max"][lid]
    is_point = ltype == LIGHT_POINT
    is_dir = ltype == LIGHT_DIRECTIONAL
    is_spot = ltype == LIGHT_SPOT

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
    return {
        "p": p, "n": torch.zeros_like(p), "dir": d,
        "pdf_pos": pdf_pos, "pdf_dir": pdf_dir,
        "is_delta": is_point | is_dir | is_spot,
    }


def eval_emission(lights, lid, n_light, wo, env_le=None):
    """Emitted intensity / radiance toward wo (reference Light::eval):
    point -> I; spot -> I times the cone falloff; directional -> L only
    along its own direction. env_le, the environment's radiance, belongs
    to image-based lights, which are refused (ROADMAP Queue 1 item 12)."""
    if env_le is not None:
        raise NotImplementedError("image-based light emission is not in "
                                  "goblin_tpu_torch yet (ROADMAP Queue 1 "
                                  "item 12)")
    ltype = lights["type"][lid]
    lcolor = lights["color"][lid]
    spot = spot_falloff(lights, lid, wo)[..., None] * lcolor
    parallel = (vm.dot(wo, lights["direction"][lid]) - 1.0).abs() < 1e-5
    dir_e = torch.where(parallel[..., None], lcolor, 0.0)
    return torch.where(
        (ltype == LIGHT_POINT)[..., None], lcolor,
        torch.where((ltype == LIGHT_SPOT)[..., None], spot,
                    torch.where((ltype == LIGHT_DIRECTIONAL)[..., None],
                                dir_e, 0.0)))
