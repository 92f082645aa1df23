"""Film: reconstruction filter, accumulation buffers, dense splat and
image output (port of goblin_tpu/camera/film.py).

Filters are evaluated in closed form, with the reference's normalisation
semantics (src/GoblinFilter.cpp, GoblinFilm.cpp:10-37).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch
import torch.nn.functional as F

from ..io import exr as exr_io

FILTER_BOX = "box"
FILTER_TRIANGLE = "triangle"
FILTER_GAUSSIAN = "gaussian"
FILTER_MITCHELL = "mitchell"


@dataclass(frozen=True)
class FilterSpec:
    kind: str = FILTER_GAUSSIAN
    x_width: float = 1.0
    y_width: float = 1.0
    falloff: float = 2.0  # gaussian
    b: float = 2.0  # mitchell
    c: float = 2.0  # mitchell

    def evaluate(self, dx, dy):
        """Unnormalised filter value at offsets (broadcastable tensors)."""
        if self.kind == FILTER_BOX:
            return torch.ones_like(dx)
        if self.kind == FILTER_TRIANGLE:
            return (torch.clamp(self.x_width - dx.abs(), min=0.0)
                    * torch.clamp(self.y_width - dy.abs(), min=0.0))
        if self.kind == FILTER_GAUSSIAN:
            ex = float(np.exp(-self.falloff * self.x_width ** 2))
            ey = float(np.exp(-self.falloff * self.y_width ** 2))
            gx = torch.clamp(torch.exp(-self.falloff * dx * dx) - ex, min=0.0)
            gy = torch.clamp(torch.exp(-self.falloff * dy * dy) - ey, min=0.0)
            return gx * gy
        if self.kind == FILTER_MITCHELL:
            return (self._mitchell_1d(dx / self.x_width)
                    * self._mitchell_1d(dy / self.y_width))
        raise ValueError(self.kind)

    def _mitchell_1d(self, x):
        b, c = self.b, self.c
        x = (2.0 * x).abs()
        inner = ((12 - 9 * b - 6 * c) * x ** 3
                 + (-18 + 12 * b + 6 * c) * x ** 2 + (6 - 2 * b)) / 6.0
        outer = ((-b - 6 * c) * x ** 3 + (6 * b + 30 * c) * x ** 2
                 + (-12 * b - 48 * c) * x + (8 * b + 24 * c)) / 6.0
        return torch.where(x > 1.0, outer, inner)


@dataclass(frozen=True)
class FilmSpec:
    x_res: int = 512
    y_res: int = 512
    crop: tuple = (0.0, 1.0, 0.0, 1.0)
    filename: str = "goblin.exr"
    filter: FilterSpec = field(default_factory=FilterSpec)

    @property
    def aspect_ratio(self) -> float:
        return self.x_res / self.y_res

    def crop_window(self):
        """(x_start, x_count, y_start, y_count) like the reference Film."""
        xs = int(np.ceil(self.x_res * self.crop[0]))
        xc = max(1, int(np.ceil(self.x_res * self.crop[1])) - xs)
        ys = int(np.ceil(self.y_res * self.crop[2]))
        yc = max(1, int(np.ceil(self.y_res * self.crop[3])) - ys)
        return xs, xc, ys, yc


def new_film(spec: FilmSpec, device):
    """-> (color (H, W, 3), weight (H, W)) zeroed on device."""
    return (
        torch.zeros((spec.y_res, spec.x_res, 3), dtype=torch.float32,
                    device=device),
        torch.zeros((spec.y_res, spec.x_res), dtype=torch.float32,
                    device=device),
    )


def splat_dense(spec: FilmSpec, color, weight, jx, jy, L, ys0=0, xs0=0):
    """Dense filter splat of one stratified sample per crop pixel.

    Pixel (iy, ix) sums w(0.5 - o - jitter) * L over the static window of
    neighbouring samples: shifted multiply-adds, no scatter. jx, jy:
    (yc, xc) jitters in [0, 1); L: (yc, xc, 3). Non-finite samples are
    dropped (reference ImageTile::addSample NaN guard). Adds into color
    and weight in place and returns them.
    """
    f = spec.filter
    yc, xc = jx.shape
    kx = int(np.floor(f.x_width + 0.5))
    ky = int(np.floor(f.y_width + 0.5))
    fin = torch.isfinite(L).all(dim=-1)
    Lz = torch.where(fin[..., None], L, 0.0)
    pad = (kx, kx, ky, ky)
    Lp = F.pad(Lz.permute(2, 0, 1), pad).permute(1, 2, 0)
    jxp = F.pad(jx, pad)
    jyp = F.pad(jy, pad)
    finp = F.pad(fin.to(torch.float32), pad)
    acc_c = torch.zeros((yc, xc, 3), dtype=torch.float32, device=L.device)
    acc_w = torch.zeros((yc, xc), dtype=torch.float32, device=L.device)
    for oy in range(-ky, ky + 1):
        for ox in range(-kx, kx + 1):
            # sample of pixel (iy+oy, ix+ox) seen from target (iy, ix)
            sl = (slice(ky + oy, ky + oy + yc), slice(kx + ox, kx + ox + xc))
            fdx = 0.5 - ox - jxp[sl]
            fdy = 0.5 - oy - jyp[sl]
            w = f.evaluate(fdx, fdy)
            w = torch.where(
                (fdx.abs() <= f.x_width) & (fdy.abs() <= f.y_width),
                w * finp[sl], 0.0,
            )
            acc_c = acc_c + w[..., None] * Lp[sl]
            acc_w = acc_w + w
    color[ys0:ys0 + yc, xs0:xs0 + xc] += acc_c
    weight[ys0:ys0 + yc, xs0:xs0 + xc] += acc_w
    return color, weight


def to_image(color, weight):
    """Resolve the accumulation to an image (reference Film::writeImage)."""
    return color / torch.clamp(weight, min=1e-30)[..., None]


def write_image(spec: FilmSpec, image) -> str:
    """Write the image to spec.filename as EXR. Returns the path."""
    path = spec.filename
    exr_io.write_exr(path, image.detach().cpu().numpy())
    return path
