"""Constant textures (port of goblin_tpu/shading/textures.py's
TextureSystem for TEX_CONSTANT; image, checkerboard and scale textures
are refused by the loader). Colour and float textures are two systems of
the same kind; a float texture holds its value in all three channels."""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch


@dataclass
class TexSpec:
    """Host-side constant texture: one RGB value."""

    value: np.ndarray = field(default_factory=lambda: np.ones(3, np.float32))


class TextureSystem:
    """A list of constant textures baked into one (X, 3) table."""

    def __init__(self, specs: list[TexSpec]):
        self.specs = specs

    def const_table(self, device) -> torch.Tensor:
        """(X, 3) float32 table of the texture values on device."""
        rows = [np.broadcast_to(np.asarray(s.value, np.float32).reshape(-1)[:3],
                                (3,)) for s in self.specs]
        return torch.as_tensor(np.stack(rows), device=device)

    @staticmethod
    def eval_all(uv, const):
        """Every texture at uv (R, 2) -> (X, R, 3): constants broadcast."""
        return const[:, None, :].expand(const.shape[0], uv.shape[0], 3)
