"""Procedural stand-in assets (the counterpart of goblin_tpu/assets.py for
what the port's example scenes need).

    python -m goblin_tpu_torch.assets examples/textures/gallery.exr
    python -m goblin_tpu_torch.assets examples/textures/sky.exr
    python -m goblin_tpu_torch.assets examples/volumes/smoke.vol

write the image texture of examples/bunny_gallery.json, the environment
map of examples/bunny_sky.json and the density grid of
examples/bunny_smoke.json anew (the file's name picks the asset).
"""

from __future__ import annotations

import os
import sys

import numpy as np

from .integrators.volume import write_vol
from .io.exr import write_exr

GALLERY_SHAPE = (120, 200)  # rows, columns: not powers of two on purpose
SKY_SHAPE = (128, 256)  # rows (theta), columns (phi) of the lat-long sky
SMOKE_SHAPE = (64, 64, 64)  # (nz, ny, nx) of the density grid
SMOKE_BBOX = (0.0, 0.0, 0.0, 1.0, 1.0, 1.0)  # the grid's box; the scene
# places it by the volume's transform


def make_gallery_image(seed: int = 7) -> np.ndarray:
    """The gallery scene's one image, (120, 200, 3) float32 in [0, 1], made
    from seed: smooth waves with a little noise. Red and green stay around
    0.5 and blue near 0.9, so the image reads as a tangent-space normal map
    that leans gently off +z, as a mask's alpha around one half (its red
    channel), as a soft height field (its luminance) and as a bluish
    colour."""
    h, w = GALLERY_SHAPE
    rng = np.random.default_rng(seed)
    y, x = np.meshgrid(np.arange(h) / h, np.arange(w) / w, indexing="ij")
    phase = rng.uniform(0.0, 2.0 * np.pi, size=6)
    r = 0.5 + 0.22 * np.sin(2 * np.pi * (3 * x + y) + phase[0]) \
        * np.cos(2 * np.pi * 2 * y + phase[1])
    g = 0.5 + 0.22 * np.sin(2 * np.pi * (2 * y - x) + phase[2]) \
        * np.cos(2 * np.pi * 4 * x + phase[3])
    b = 0.9 + 0.08 * np.sin(2 * np.pi * (5 * x + 3 * y) + phase[4]) \
        * np.sin(2 * np.pi * y + phase[5])
    img = np.stack([r, g, b], axis=-1) + rng.normal(0.0, 0.01, (h, w, 3))
    return np.clip(img, 0.0, 1.0).astype(np.float32)


def make_sky_image() -> np.ndarray:
    """The sky scene's environment map, (128, 256, 3) float32 lat-long
    (row = theta / pi from the map's zenith, column = phi / 2 pi): a
    horizon-to-zenith gradient over the upper half, a darker ground below,
    and a small bright sun (about 5 degrees across, ~100x the sky) at 35
    degrees elevation, so that the 2-D CDF's importance sampling matters."""
    h, w = SKY_SHAPE
    theta = (np.arange(h) + 0.5) / h * np.pi
    phi = (np.arange(w) + 0.5) / w * 2.0 * np.pi
    th, ph = np.meshgrid(theta, phi, indexing="ij")
    d = np.stack([np.sin(th) * np.cos(ph), np.sin(th) * np.sin(ph),
                  np.cos(th)], axis=-1)
    up = np.clip(np.cos(th), 0.0, 1.0)[..., None]
    horizon = np.float64([0.085, 0.08, 0.07])
    zenith = np.float64([0.025, 0.045, 0.09])
    ground = np.float64([0.018, 0.015, 0.012])
    down = np.clip(-np.cos(th), 0.0, 1.0)[..., None]
    sky = np.where(np.cos(th)[..., None] >= 0.0,
                   horizon * (1.0 - up) + zenith * up,
                   ground * (1.0 - 0.5 * down))
    s_th, s_ph = np.radians(55.0), np.radians(110.0)
    sun = np.float64([np.sin(s_th) * np.cos(s_ph), np.sin(s_th) * np.sin(s_ph),
                      np.cos(s_th)])
    ang = np.arccos(np.clip(d @ sun, -1.0, 1.0))
    disk = (ang < np.radians(2.5))[..., None]
    glow = np.exp(-(ang / np.radians(8.0)) ** 2)[..., None]
    img = (sky + 0.15 * glow * np.float64([1.0, 0.9, 0.7])
           + disk * np.float64([9.0, 8.5, 7.5]))
    return img.astype(np.float32)


def make_smoke_grid(seed: int = 11) -> np.ndarray:
    """The smoke scene's density grid, (64, 64, 64) float16 (z, y, x) over
    the unit box, made from seed: seven soft gaussian puffs (peak density
    1.5-4 a unit of the box, radii 0.06-0.16) whose sum is modulated by a
    gentle wave, fading to zero at the box's faces so the medium has no hard
    edge."""
    nz, ny, nx = SMOKE_SHAPE
    rng = np.random.default_rng(seed)
    z, y, x = np.meshgrid(*((np.arange(n) + 0.5) / n for n in (nz, ny, nx)),
                          indexing="ij")
    dens = np.zeros(SMOKE_SHAPE)
    for _ in range(7):
        c = rng.uniform(0.2, 0.8, size=3)
        r = rng.uniform(0.06, 0.16)
        peak = rng.uniform(1.5, 4.0)
        d2 = (x - c[0]) ** 2 + (y - c[1]) ** 2 + (z - c[2]) ** 2
        dens += peak * np.exp(-d2 / (2.0 * r * r))
    phase = rng.uniform(0.0, 2.0 * np.pi, size=3)
    dens *= 0.75 + 0.25 * np.sin(2 * np.pi * (3 * x + phase[0])) \
        * np.sin(2 * np.pi * (2 * y + phase[1])) \
        * np.sin(2 * np.pi * (3 * z + phase[2]))
    fade = np.minimum.reduce([np.clip(v / 0.1, 0.0, 1.0) for v in
                              (x, y, z, 1 - x, 1 - y, 1 - z)])
    return (dens * fade).astype(np.float16)


if __name__ == "__main__":
    out = sys.argv[1]
    name = os.path.basename(out)
    if name.endswith(".vol"):
        write_vol(out, make_smoke_grid(), SMOKE_BBOX)
    else:
        write_exr(out, make_sky_image() if name.startswith("sky")
                  else make_gallery_image())
