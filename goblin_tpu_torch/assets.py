"""Procedural stand-in assets (the counterpart of goblin_tpu/assets.py for
what the port's example scenes need).

    python -m goblin_tpu_torch.assets examples/textures/gallery.exr
    python -m goblin_tpu_torch.assets examples/textures/sky.exr

write the image texture of examples/bunny_gallery.json and the environment
map of examples/bunny_sky.json anew (the file's name picks the image).
"""

from __future__ import annotations

import os
import sys

import numpy as np

from .io.exr import write_exr

GALLERY_SHAPE = (120, 200)  # rows, columns: not powers of two on purpose
SKY_SHAPE = (128, 256)  # rows (theta), columns (phi) of the lat-long sky


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


if __name__ == "__main__":
    out = sys.argv[1]
    write_exr(out, make_sky_image() if os.path.basename(out).startswith("sky")
              else make_gallery_image())
