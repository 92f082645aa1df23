"""Pinhole perspective camera (port of goblin_tpu/camera/camera.py's
CameraSpec and generate_ray).

Reference conventions (src/GoblinCamera.cpp): left-handed view space
looking down +z, orientation quaternion columns give (right, up, look),
LH D3D projection with z in [0, 1], ray differentials at +1 pixel,
mint = 1e-3.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import cached_property

import numpy as np
import torch

from ..core import vecmath as vm
from .film import FilmSpec


@dataclass(frozen=True)
class CameraSpec:
    position: tuple = (0.0, 0.0, 0.0)
    orientation: tuple = (1.0, 0.0, 0.0, 0.0)  # wxyz
    fov: float = float(np.radians(60.0))  # vertical, radians
    z_near: float = 0.1
    z_far: float = 1000.0
    film: FilmSpec = field(default_factory=FilmSpec)

    @cached_property
    def _rot(self) -> np.ndarray:
        return vm.quat_to_matrix_np(self.orientation)

    @cached_property
    def proj(self) -> np.ndarray:
        return vm.perspective_lh_d3d(self.fov, self.film.aspect_ratio,
                                     self.z_near, self.z_far)

    def generate_ray(self, image_x, image_y):
        """(R,) continuous image coords -> ray dict {o, d, dxd, dyd, mint,
        maxt}; dxd/dyd are the +1 pixel differential directions."""
        dev = image_x.device
        inv_x = 1.0 / self.film.x_res
        inv_y = 1.0 / self.film.y_res
        x_ndc = 2.0 * image_x * inv_x - 1.0
        y_ndc = -2.0 * image_y * inv_y + 1.0
        dx_ndc = 2.0 * (image_x + 1.0) * inv_x - 1.0
        dy_ndc = -2.0 * (image_y + 1.0) * inv_y + 1.0
        rot = self._rot.tolist()
        p00, p11 = float(self.proj[0, 0]), float(self.proj[1, 1])
        one = torch.ones_like(x_ndc)
        view_dir = torch.stack([x_ndc / p00, y_ndc / p11, one], dim=-1)
        dxv = torch.stack([dx_ndc / p00, y_ndc / p11, one], dim=-1)
        dyv = torch.stack([x_ndc / p00, dy_ndc / p11, one], dim=-1)
        d = vm.mat3_apply(rot, vm.normalize(view_dir))
        n = image_x.shape[0]
        return {
            "o": torch.stack([torch.full((n,), float(c), device=dev)
                              for c in np.float32(self.position)], dim=-1),
            "d": d,
            "dxd": vm.mat3_apply(rot, vm.normalize(dxv)),
            "dyd": vm.mat3_apply(rot, vm.normalize(dyv)),
            "mint": torch.full((n,), 1e-3, dtype=torch.float32, device=dev),
            "maxt": torch.full((n,), 3.0e38, dtype=torch.float32, device=dev),
        }
