"""Light table for delta lights: point, spot and directional (port of the
matching parts of goblin_tpu/lights/lights.py).

Semantics of the reference (src/GoblinLight.{h,cpp}): point Li = I / r^2;
spot adds the cone falloff ((cos - cosMax) / (cosStart - cosMax))^4;
directional is parallel radiance. All three are delta lights: sample_li
returns pdf 1 and is_delta, and MIS is skipped for them. Area and
environment lights are not in this port yet; the loader refuses them.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

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


def bake_lights(build: LightsBuild, world_radius: float, device) -> dict:
    """-> the light table, a dict of tensors on device. Light powers feed
    the pick CDF (reference Scene ctor, luminance of power())."""
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


def pdf_li(lights, lid, hit_t):
    """Solid-angle pdf that light lid generates the BSDF ray that hit at
    hit_t, for MIS on the BSDF-sampling side. A BSDF ray never hits a delta
    light, so for every light this port loads it is 0 (goblin_tpu's area
    and sphere arms come with area lights)."""
    return torch.zeros_like(hit_t)
