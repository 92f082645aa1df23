"""Perspective (pinhole or thin-lens) and orthographic cameras (port of
goblin_tpu/camera/camera.py's CameraSpec: generate_ray, world_to_screen
and the importance side that light tracing reads).

Reference conventions (src/GoblinCamera.cpp): left-handed view space
looking down +z, orientation quaternion columns give (right, up, look),
LH D3D projection with z in [0, 1], screen = ((ndc.x + 1) / 2 * x_res,
(1 - ndc.y) / 2 * y_res), thin-lens depth of field when lens_radius > 0
and lens samples are given, ray differentials at +1 pixel, mint = 1e-3.
The importance side (sample_position, sample_direction, eval_we,
pdf_position, pdf_direction; src/GoblinCamera.cpp:150-288) is the
perspective camera's, with and without a lens. The movement helpers
(rotate, translate, roll, pitch, yaw, rotate_x / _y / _z; reference
src/GoblinCamera.h:110-185) return a new CameraSpec: the spec is frozen,
so a render takes the moved camera by being handed the new one.
"""

from __future__ import annotations

import dataclasses
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

    @cached_property
    def look(self) -> np.ndarray:
        return self._rot[:, 2]

    @cached_property
    def right(self) -> np.ndarray:
        return self._rot[:, 0]

    @cached_property
    def up(self) -> np.ndarray:
        return self._rot[:, 1]

    @cached_property
    def view(self) -> np.ndarray:
        """World -> view, (4, 4) float32."""
        p = np.asarray(self.position, dtype=np.float32)
        m = np.eye(4, dtype=np.float32)
        for i in range(3):
            m[i, :3] = self._rot[:, i]
            m[i, 3] = -p @ self._rot[:, i]
        return m

    @cached_property
    def film_area(self) -> float:
        """World-space area of the film at the focal plane (perspective) or
        of the orthographic film plate (reference constructors)."""
        if self.kind == "perspective":
            h = 2.0 * self.focal_distance * np.tan(0.5 * self.fov)
            return float(h * h * self.film.aspect_ratio)
        return float(self.film_width * self.film_width / self.film.aspect_ratio)

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

    def _to_view(self, p_world):
        view = self.view.tolist()
        return vm.mat3_apply(view, p_world) + p_world.new_tensor(
            [row[3] for row in view[:3]])

    def world_to_screen(self, p_world, p_lens=None):
        """-> (screen_x, screen_y, view_z, valid): the film position where
        the ray from p_lens (the pinhole when None) toward p_world lands.
        Points behind the camera, lens points off the lens and positions off
        the film's sample range are flagged invalid (reference
        src/GoblinCamera.cpp:256-288)."""
        p_view = self._to_view(p_world)
        p_lens_view = (torch.zeros_like(p_view) if p_lens is None
                       else self._to_view(p_lens))
        valid = p_view[..., 2] >= 0.0
        if self.lens_radius > 0.0:
            r2 = p_lens_view[..., 0] ** 2 + p_lens_view[..., 1] ** 2
            valid = valid & (r2 <= self.lens_radius ** 2)
        dirv = p_view - p_lens_view
        dz = dirv[..., 2]
        valid = valid & (dz.abs() >= 1e-7)
        if self.kind == "perspective":
            p_focus = p_lens_view + dirv * (
                self.focal_distance / torch.where(dz == 0.0, 1e-7, dz)
            )[..., None]
        else:
            p_focus = p_view
        ph = torch.cat([p_focus, torch.ones_like(p_focus[..., :1])], dim=-1)
        proj = self.proj.tolist()
        ndc = torch.stack(
            [sum(proj[i][k] * ph[..., k] for k in range(4) if proj[i][k] != 0.0)
             for i in range(4)], dim=-1)
        ndc = ndc / torch.where(ndc[..., 3:4] == 0.0, 1e-12, ndc[..., 3:4])
        sx = (ndc[..., 0] + 1.0) * 0.5 * self.film.x_res
        sy = (1.0 - ndc[..., 1]) * 0.5 * self.film.y_res
        xs, xe, ys, ye = self.film.sample_range()
        valid = valid & (sx >= xs) & (sx <= xe) & (sy >= ys) & (sy <= ye)
        return sx, sy, p_view[..., 2], valid

    # ---- the importance side, for the light tracer ----

    def sample_position(self, u1, u2):
        """-> (p (R, 3), n (R, 3), pdf_area (R,)): a point on the lens disk
        when lens_radius > 0, else the pinhole (a delta, pdf 1)."""
        dev = u1.device
        pos = u1.new_tensor(np.float32(self.position).tolist()).expand(
            u1.shape + (3,))
        if self.lens_radius > 0.0:
            lens = self.lens_radius * sp.uniform_sample_disk(u1, u2)
            view_o = torch.cat([lens, torch.zeros_like(lens[..., :1])], dim=-1)
            p = vm.mat3_apply(self._rot.tolist(), view_o) + pos
            pdf = torch.full(u1.shape, 1.0 / (np.pi * self.lens_radius ** 2),
                             dtype=torch.float32, device=dev)
        else:
            p = pos
            pdf = torch.ones(u1.shape, dtype=torch.float32, device=dev)
        n = u1.new_tensor(self.look.tolist()).expand(p.shape)
        return p, n, pdf

    def _we(self, G):
        """1 / (film area x lens area x G); the lens area drops out for a
        pinhole."""
        area = self.film_area
        if self.lens_radius > 0.0:
            area = area * (np.pi * self.lens_radius ** 2)
        return 1.0 / torch.clamp(float(area) * G, min=1e-30)

    def sample_direction(self, image_x, image_y, p_camera):
        """-> (dir, We, pdf_w): the direction from p_camera through the
        film position, its importance and its solid-angle pdf (reference
        PerspectiveCamera::sampleDirection)."""
        p00, p11 = float(self.proj[0, 0]), float(self.proj[1, 1])
        x_ndc = 2.0 * image_x * (1.0 / self.film.x_res) - 1.0
        y_ndc = -2.0 * image_y * (1.0 / self.film.y_res) + 1.0
        view_dir = torch.stack([x_ndc / p00, y_ndc / p11,
                                torch.ones_like(x_ndc)], dim=-1)
        pos = image_x.new_tensor(np.float32(self.position).tolist())
        p_focus = vm.mat3_apply(self._rot.tolist(),
                                self.focal_distance * view_dir) + pos
        sd = p_focus - p_camera
        dist2 = vm.squared_length(sd)
        sd = vm.normalize(sd)
        cos_t = vm.absdot(sd.new_tensor(self.look.tolist()).expand(sd.shape),
                          sd)
        G = cos_t * cos_t / torch.clamp(dist2, min=1e-20)
        pdf_w = dist2 / torch.clamp(self.film_area * cos_t, min=1e-20)
        return sd, self._we(G), pdf_w

    def eval_we(self, p_camera, p_world):
        """Importance emitted from p_camera toward p_world; 0 where the
        point does not project onto the film (reference evalWe)."""
        _, _, _, valid = self.world_to_screen(p_world, p_camera)
        p_lens = self._to_view(p_camera)
        dirv = self._to_view(p_world) - p_lens
        dz = torch.where(dirv[..., 2] == 0.0, 1e-7, dirv[..., 2])
        lens_to_film = (p_lens + dirv * (self.focal_distance / dz)[..., None]
                        - p_lens)
        dist2 = vm.squared_length(lens_to_film)
        cos_t = vm.normalize(lens_to_film)[..., 2]
        G = cos_t * cos_t / torch.clamp(dist2, min=1e-20)
        return torch.where(valid, self._we(G), 0.0)

    def pdf_position(self) -> float:
        """Area pdf on the lens (reference pdfPosition); 0 for a pinhole."""
        if self.lens_radius > 0.0:
            return 1.0 / (np.pi * self.lens_radius ** 2)
        return 0.0

    def pdf_direction(self, wo):
        """Solid-angle pdf of emitting along wo (reference pdfDirection:
        focal_distance^2 / (film area x cos^3))."""
        cos_t = vm.dot(wo.new_tensor(self.look.tolist()).expand(wo.shape), wo)
        return self.focal_distance ** 2 / torch.clamp(
            self.film_area * cos_t ** 3, min=1e-20)


def _quat_mul(a, b):
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return (aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw)


def rotate(spec: CameraSpec, axis, angle: float) -> CameraSpec:
    """orientation' = normalize(Quaternion(axis, angle) * orientation)
    (reference Camera::rotate)."""
    ax = np.asarray(axis, np.float64)
    ax = ax / max(np.linalg.norm(ax), 1e-20)
    h = 0.5 * float(angle)
    o = _quat_mul((np.cos(h), *(np.sin(h) * ax)), spec.orientation)
    n = max(np.sqrt(sum(v * v for v in o)), 1e-20)
    return dataclasses.replace(spec, orientation=tuple(float(v) / n for v in o))


def translate(spec: CameraSpec, d) -> CameraSpec:
    """position += d (reference Camera::translate)."""
    return dataclasses.replace(
        spec, position=tuple(float(p) + float(v)
                             for p, v in zip(spec.position, d)))


def roll(spec: CameraSpec, angle: float) -> CameraSpec:
    return rotate(spec, spec.look, angle)


def pitch(spec: CameraSpec, angle: float) -> CameraSpec:
    return rotate(spec, spec.right, angle)


def yaw(spec: CameraSpec, angle: float) -> CameraSpec:
    return rotate(spec, spec.up, angle)


def rotate_x(spec: CameraSpec, angle: float) -> CameraSpec:
    return rotate(spec, (1.0, 0.0, 0.0), angle)


def rotate_y(spec: CameraSpec, angle: float) -> CameraSpec:
    return rotate(spec, (0.0, 1.0, 0.0), angle)


def rotate_z(spec: CameraSpec, angle: float) -> CameraSpec:
    return rotate(spec, (0.0, 0.0, 1.0), angle)
