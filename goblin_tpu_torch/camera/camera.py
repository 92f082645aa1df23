"""Perspective (pinhole or thin-lens) and orthographic cameras (port of
goblin_tpu/camera/camera.py's CameraSpec and generate_ray).

Reference conventions (src/GoblinCamera.cpp): left-handed view space
looking down +z, orientation quaternion columns give (right, up, look),
LH D3D projection with z in [0, 1], thin-lens depth of field when
lens_radius > 0 and lens samples are given, ray differentials at +1 pixel,
mint = 1e-3.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import cached_property

import numpy as np
import torch

from ..core import sampling as sp
from ..core import vecmath as vm
from .film import FilmSpec


@dataclass(frozen=True)
class CameraSpec:
    kind: str = "perspective"  # or "orthographic"
    position: tuple = (0.0, 0.0, 0.0)
    orientation: tuple = (1.0, 0.0, 0.0, 0.0)  # wxyz
    fov: float = float(np.radians(60.0))  # vertical, radians
    z_near: float = 0.1
    z_far: float = 1000.0
    lens_radius: float = 0.0
    focal_distance: float = 1.0
    film_width: float = 35.0  # orthographic
    film: FilmSpec = field(default_factory=FilmSpec)

    @cached_property
    def _rot(self) -> np.ndarray:
        return vm.quat_to_matrix_np(self.orientation)

    @cached_property
    def proj(self) -> np.ndarray:
        if self.kind == "perspective":
            return vm.perspective_lh_d3d(self.fov, self.film.aspect_ratio,
                                         self.z_near, self.z_far)
        h = self.film_width / self.film.aspect_ratio
        return vm.ortho_lh_d3d(self.film_width, h, self.z_near, self.z_far)

    @property
    def is_delta(self) -> bool:
        return self.kind == "orthographic" or self.lens_radius == 0.0

    def generate_ray(self, image_x, image_y, lens_u1=None, lens_u2=None):
        """(R,) continuous image coords -> ray dict {o, d, dxd, dyd, mint,
        maxt}; dxd/dyd are the +1 pixel differential directions. lens_u1 /
        lens_u2: the lens samples of a thin-lens camera; without them (or
        with lens_radius 0) a perspective camera is a pinhole."""
        dev = image_x.device
        n = image_x.shape[0]
        inv_x = 1.0 / self.film.x_res
        inv_y = 1.0 / self.film.y_res
        x_ndc = 2.0 * image_x * inv_x - 1.0
        y_ndc = -2.0 * image_y * inv_y + 1.0
        dx_ndc = 2.0 * (image_x + 1.0) * inv_x - 1.0
        dy_ndc = -2.0 * (image_y + 1.0) * inv_y + 1.0
        rot = self._rot.tolist()
        pos = torch.stack([torch.full((n,), float(c), device=dev)
                           for c in np.float32(self.position)], dim=-1)

        if self.kind == "perspective":
            p00, p11 = float(self.proj[0, 0]), float(self.proj[1, 1])
            one = torch.ones_like(x_ndc)
            view_dir = torch.stack([x_ndc / p00, y_ndc / p11, one], dim=-1)
            dxv = torch.stack([dx_ndc / p00, y_ndc / p11, one], dim=-1)
            dyv = torch.stack([x_ndc / p00, dy_ndc / p11, one], dim=-1)
            if self.lens_radius > 0.0 and lens_u1 is not None:
                fd = self.focal_distance
                p_focus = view_dir * (fd / view_dir[..., 2])[..., None]
                pdx_focus = dxv * (fd / dxv[..., 2])[..., None]
                pdy_focus = dyv * (fd / dyv[..., 2])[..., None]
                lens = self.lens_radius * sp.uniform_sample_disk(lens_u1,
                                                                 lens_u2)
                view_o = torch.cat([lens, torch.zeros_like(lens[..., :1])],
                                   dim=-1)
                o = vm.mat3_apply(rot, view_o) + pos
                d = vm.mat3_apply(rot, vm.normalize(p_focus - view_o))
                dxd = vm.mat3_apply(rot, vm.normalize(pdx_focus - view_o))
                dyd = vm.mat3_apply(rot, vm.normalize(pdy_focus - view_o))
            else:
                o = pos
                d = vm.mat3_apply(rot, vm.normalize(view_dir))
                dxd = vm.mat3_apply(rot, vm.normalize(dxv))
                dyd = vm.mat3_apply(rot, vm.normalize(dyv))
        else:  # orthographic: parallel rays through the film plane
            w = self.film_width
            h = w / self.film.aspect_ratio
            view_o = torch.stack([0.5 * w * x_ndc, 0.5 * h * y_ndc,
                                  torch.zeros_like(x_ndc)], dim=-1)
            o = vm.mat3_apply(rot, view_o) + pos
            d = torch.stack([torch.full((n,), float(c), device=dev)
                             for c in self._rot[:, 2]], dim=-1)
            dxd = dyd = d
        return {
            "o": o,
            "d": d,
            "dxd": dxd,
            "dyd": dyd,
            "mint": torch.full((n,), 1e-3, dtype=torch.float32, device=dev),
            "maxt": torch.full((n,), 3.0e38, dtype=torch.float32, device=dev),
        }
