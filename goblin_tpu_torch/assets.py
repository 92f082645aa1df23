"""Procedural stand-in assets (the counterpart of goblin_tpu/assets.py for
what the port's example scenes need).

    python -m goblin_tpu_torch.assets examples/textures/gallery.exr

writes the image texture of examples/bunny_gallery.json anew.
"""

from __future__ import annotations

import sys

import numpy as np

from .io.exr import write_exr

GALLERY_SHAPE = (120, 200)  # rows, columns: not powers of two on purpose


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


if __name__ == "__main__":
    write_exr(sys.argv[1], make_gallery_image())
