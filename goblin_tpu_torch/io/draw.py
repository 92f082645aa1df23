"""Debug overlay: world-space rays and points projected by the camera and
drawn onto a rendered image (port of goblin_tpu/io/draw.py; reference
DebugData and Renderer::drawDebugData, src/GoblinDebugData.h:12-33,
src/GoblinRenderer.cpp:667-690, drawLine / drawPoint
src/GoblinUtils.cpp:115-197).

Every segment is projected with the camera's world_to_screen in one batch
and drawn by sampling it at 2 max(H, W) points (at least twice the
screen-length rate, so the samples cover the pixels Bresenham's walk
would); a point is a 3 x 3 square. Samples behind the lens or off the
film are left out.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch


@dataclass
class DebugData:
    """Host-side collector of rays (p0, p1, rgb) and points (p, rgb)."""

    rays: list = field(default_factory=list)
    points: list = field(default_factory=list)

    def add_ray(self, p0, p1, color=(0.0, 1.0, 0.0)):
        self.rays.append((np.asarray(p0, np.float32),
                          np.asarray(p1, np.float32),
                          np.asarray(color, np.float32)))

    def add_point(self, p, color=(1.0, 0.0, 0.0)):
        self.points.append((np.asarray(p, np.float32),
                            np.asarray(color, np.float32)))


def _screen(camera, p, w, h):
    """Pixel indices of world points and whether each lands on the film."""
    sx, sy, _, valid = camera.world_to_screen(p)
    xi = torch.clamp(torch.round(sx).to(torch.int64), 0, w - 1)
    yi = torch.clamp(torch.round(sy).to(torch.int64), 0, h - 1)
    return xi, yi, valid & (sx >= 0) & (sx < w) & (sy >= 0) & (sy < h)


def draw_overlay(image, camera, debug: DebugData, samples_per_line=None):
    """A copy of image (H, W, 3) with the debug rays and points drawn on
    it -> float32 tensor on image's device (the CPU for a numpy image)."""
    img = torch.as_tensor(np.asarray(image) if not isinstance(
        image, torch.Tensor) else image, dtype=torch.float32).clone()
    h, w = img.shape[:2]
    if samples_per_line is None:
        samples_per_line = 2 * max(h, w)

    def tensor(rows):
        return torch.as_tensor(np.stack(rows), device=img.device)

    if debug.rays:
        p0 = tensor([r[0] for r in debug.rays])
        p1 = tensor([r[1] for r in debug.rays])
        col = tensor([r[2] for r in debug.rays])
        ts = torch.linspace(0.0, 1.0, samples_per_line, device=img.device)
        pw = p0[:, None, :] + ts[None, :, None] * (p1 - p0)[:, None, :]
        xi, yi, inside = _screen(camera, pw.reshape(-1, 3), w, h)
        c = col.repeat_interleave(samples_per_line, dim=0)
        img[yi[inside], xi[inside]] = c[inside]

    if debug.points:
        p = tensor([q[0] for q in debug.points])
        col = tensor([q[1] for q in debug.points])
        xi, yi, inside = _screen(camera, p, w, h)
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                xj = torch.clamp(xi + dx, 0, w - 1)
                yj = torch.clamp(yi + dy, 0, h - 1)
                img[yj[inside], xj[inside]] = col[inside]
    return img
