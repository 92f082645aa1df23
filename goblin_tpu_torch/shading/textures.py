"""Texture programs: baked, branch-free texture evaluation (port of
goblin_tpu/shading/textures.py).

The reference's Texture class tree (src/GoblinTexture.{h,cpp}): constant /
checkerboard / scale / image nodes with uv or spherical mappings, becomes a
per-scene program. The nodes are sorted topologically at bake time and
evaluated in that order as dense tensor ops over the whole wavefront; each
lane then picks its material's value by texture id. Colour and float
textures are two systems of the same kind; a float texture holds its value
in all three channels.

Image data lives in one flat float32 atlas, RGB interleaved; an image node
stores (offset, height, width), and one filtered by a MIP pyramid stores
them for every level. Filters: nearest, bilinear, trilinear over the
pyramid, and EWA as a fixed lattice of gaussian-weighted taps over the
footprint's ellipse (reference src/GoblinTexture.cpp:131-271). The
arithmetic keeps goblin_tpu's order of operations, so both packages pick
the same texels except where a coordinate lies within rounding of a texel
or level boundary.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

TEX_CONSTANT = 0
TEX_CHECKERBOARD = 1
TEX_SCALE = 2
TEX_IMAGE = 3

MAP_UV = 0
MAP_SPHERICAL = 1

ADDRESS_REPEAT = 0
ADDRESS_CLAMP = 1
ADDRESS_BORDER = 2

FILTER_NEAREST = 0
FILTER_BILINEAR = 1
FILTER_TRILINEAR = 2
FILTER_EWA = 3

# the EWA lattice: taps along the ellipse's major and minor axes
EWA_TAPS = 8
EWA_MINOR_TAPS = 3


def _build_pyramid(img: np.ndarray):
    """Resize to powers of two (bilinear), then 2 x 2 box-average down to
    1 x 1 (the analogue of the reference's resize and pyramid,
    src/GoblinTexture.cpp:39-128, 524-598). Returns a list of (H, W, 3)."""

    def pow2(n):
        p = 1
        while p < n:
            p *= 2
        return p

    h, w = img.shape[:2]
    H, W = pow2(h), pow2(w)
    if (H, W) != (h, w):
        ys = (np.arange(H) + 0.5) * h / H - 0.5
        xs = (np.arange(W) + 0.5) * w / W - 0.5
        y0 = np.clip(np.floor(ys).astype(int), 0, h - 1)
        x0 = np.clip(np.floor(xs).astype(int), 0, w - 1)
        y1 = np.minimum(y0 + 1, h - 1)
        x1 = np.minimum(x0 + 1, w - 1)
        fy = (ys - y0).clip(0, 1)[:, None, None]
        fx = (xs - x0).clip(0, 1)[None, :, None]
        img = (
            img[y0][:, x0] * (1 - fy) * (1 - fx)
            + img[y0][:, x1] * (1 - fy) * fx
            + img[y1][:, x0] * fy * (1 - fx)
            + img[y1][:, x1] * fy * fx
        )
    levels = [img.astype(np.float32)]
    while levels[-1].shape[0] > 1 or levels[-1].shape[1] > 1:
        cur = levels[-1]
        ch, cw = cur.shape[:2]
        nh, nw = max(1, ch // 2), max(1, cw // 2)
        if ch > 1 and cw > 1:
            nxt = cur[:nh * 2, :nw * 2].reshape(nh, 2, nw, 2, 3).mean(axis=(1, 3))
        elif ch > 1:
            nxt = cur[:nh * 2].reshape(nh, 2, cw, 3).mean(axis=1)
        else:
            nxt = cur[:, :nw * 2].reshape(ch, nw, 2, 3).mean(axis=2)
        levels.append(nxt.astype(np.float32))
    return levels


@dataclass
class TexSpec:
    """Host-side texture description: one node of the program."""

    kind: int = TEX_CONSTANT
    value: np.ndarray = field(default_factory=lambda: np.ones(3, np.float32))
    # checkerboard / scale children (indices into the same spec list)
    child0: int = -1
    child1: int = -1
    scale: np.ndarray = field(default_factory=lambda: np.ones(3, np.float32))
    # uv mapping: uv' = uv * map_scale + map_offset
    map_scale: tuple = (1.0, 1.0)
    map_offset: tuple = (0.0, 0.0)
    # image
    image: np.ndarray | None = None  # (H, W, C) float32
    address: int = ADDRESS_REPEAT
    filter: int = FILTER_NEAREST
    gamma: float = 1.0
    # box-filtered checkerboard (reference integrateChecker)
    checker_filter: bool = False
    # EWA anisotropy clamp (reference maxAnisotropy)
    max_anisotropy: float = 10.0
    # mapping kind; spherical applies world_to_tex to the hit position
    mapping: int = MAP_UV
    world_to_tex: np.ndarray | None = None  # (4, 4), spherical mapping only


def _ewa_lattice():
    """The EWA taps inside the unit ellipse -> [(a, b, weight)], a along the
    major axis and b along the minor one in [-0.5, 0.5], with the
    reference's gaussian profile exp(-2 r^2) - exp(-2) (initEWALut,
    src/GoblinTexture.cpp:262-271) as Python floats."""
    taps = []
    for i in range(EWA_TAPS):
        a = (i + 0.5) / EWA_TAPS - 0.5
        for j in range(EWA_MINOR_TAPS):
            b = (j + 0.5) / EWA_MINOR_TAPS - 0.5
            r2 = (2.0 * a) ** 2 + (2.0 * b) ** 2
            gw = float(np.exp(-2.0 * r2) - np.exp(-2.0))
            if gw > 0.0:
                taps.append((a, b, gw))
    return taps


_EWA_LATTICE = _ewa_lattice()


def _address(address, x, n):
    """Texel index x (int32) into [0, n): repeat wraps by the floored
    remainder, clamp and border clamp (border zeroes the texel after)."""
    if address == ADDRESS_REPEAT:
        return torch.remainder(x, n)
    if isinstance(n, torch.Tensor):
        return torch.minimum(torch.clamp(x, min=0), n - 1)
    return torch.clamp(x, 0, n - 1)


def _fetch(address, atlas, off, h, w, xi, yi):
    """RGB texels (xi, yi) of the image at off with h x w texels -> (..., 3);
    outside texels are 0 under border addressing. An index past the atlas
    clamps to its ends."""
    inside = None
    if address == ADDRESS_BORDER:
        inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
    xi, yi = _address(address, xi, w), _address(address, yi, h)
    base = (off + (yi * w + xi) * 3).long()
    idx = base[..., None] + torch.arange(3, device=atlas.device)
    rgb = atlas[torch.clamp(idx, 0, atlas.shape[0] - 1)]
    if inside is not None:
        rgb = torch.where(inside[..., None], rgb, 0.0)
    return rgb


def _bilinear(address, atlas, off, h, w, u, v):
    """Bilinear fetch; off / h / w are Python ints, or int32 tensors that
    broadcast with u and v (the levels of a MIP lookup)."""
    fx = u * w - 0.5
    fy = v * h - 0.5
    x0 = torch.floor(fx).to(torch.int32)
    y0 = torch.floor(fy).to(torch.int32)
    tx = fx - x0
    ty = fy - y0
    out = 0.0
    for dy in (0, 1):
        for dx in (0, 1):
            rgb = _fetch(address, atlas, off, h, w, x0 + dx, y0 + dy)
            wgt = (tx if dx else 1 - tx) * (ty if dy else 1 - ty)
            out = out + wgt[..., None] * rgb
    return out


class TextureSystem:
    """A list of TexSpec baked into a constant table, an image atlas and an
    evaluation program. const and atlas are numpy here; the bake puts them
    on the device, in the scene dict, and eval_all reads them from there."""

    def __init__(self, specs: list[TexSpec]):
        self.specs = specs
        self.order = self._topo_order()

        # per-spec constant row: a TEX_CONSTANT's value, a TEX_SCALE's factor
        def const_row(s):
            v = np.asarray(s.scale if s.kind == TEX_SCALE else s.value,
                           np.float32).reshape(-1)
            return np.broadcast_to(v[:3] if v.size >= 3 else v[:1], (3,))

        self.const = (np.stack([const_row(s) for s in specs]).astype(np.float32)
                      if specs else np.zeros((0, 3), np.float32))
        chunks = []
        offset = 0
        self.image_info = {}  # spec id -> (offset, h, w) of level 0
        self.mip_info = {}  # spec id -> (offsets, hs, ws) int32, per level
        for i, s in enumerate(specs):
            if s.kind != TEX_IMAGE or s.image is None:
                continue
            img = np.asarray(s.image, dtype=np.float32)
            if s.gamma != 1.0:
                img = np.power(np.maximum(img, 0.0), s.gamma)
            h, w = img.shape[:2]
            c = img.shape[2] if img.ndim == 3 else 1
            img = img.reshape(h, w, c)
            if c < 3:
                img = np.repeat(img[:, :, :1], 3, axis=2)
            img = img[:, :, :3]
            levels = [img]
            if s.filter >= FILTER_TRILINEAR:
                levels = _build_pyramid(img)
                self.mip_info[i] = tuple(
                    np.asarray(col, np.int32) for col in (
                        np.cumsum([offset] + [lv.shape[0] * lv.shape[1] * 3
                                              for lv in levels[:-1]]),
                        [lv.shape[0] for lv in levels],
                        [lv.shape[1] for lv in levels]))
            self.image_info[i] = (offset,) + levels[0].shape[:2]
            for lv in levels:
                chunks.append(lv.reshape(-1))
                offset += lv.size
        self.atlas = (np.concatenate(chunks) if chunks
                      else np.zeros((3,), np.float32))
        self._device_tables = {}

    def _topo_order(self):
        order, seen = [], set()

        def visit(i):
            if i < 0 or i in seen:
                return
            s = self.specs[i]
            visit(s.child0)
            visit(s.child1)
            seen.add(i)
            order.append(i)

        for i in range(len(self.specs)):
            visit(i)
        return order

    def _on_device(self, key, device, make):
        """A small host table as a tensor on device, made once. It is made
        outside inference mode: it outlives the render that first asks for
        it, and a gradient pass after that render saves it for backward."""
        k = (key, str(device))
        if k not in self._device_tables:
            with torch.inference_mode(False):
                self._device_tables[k] = torch.as_tensor(make(), device=device)
        return self._device_tables[k]

    # -- evaluation --------------------------------------------------------

    def _mip_bilinear(self, s, spec_id, atlas, lvl_i, u, v):
        offs, hs, ws = (
            self._on_device((spec_id, k), atlas.device,
                            lambda k=k: self.mip_info[spec_id][k])
            for k in range(3))
        lvl_i = lvl_i.long()
        return _bilinear(s.address, atlas, offs[lvl_i], hs[lvl_i], ws[lvl_i],
                         u, v)

    def _eval_image(self, spec_id, uv, atlas, duv=None, duv4=None):
        s = self.specs[spec_id]
        off, h, w = self.image_info[spec_id]
        # uv arrives mapped by _spec_uv (scale and offset, or spherical)
        u = uv[..., 0]
        v = uv[..., 1]

        if s.filter == FILTER_NEAREST:
            xi = torch.floor(u * w).to(torch.int32)
            yi = torch.floor(v * h).to(torch.int32)
            return _fetch(s.address, atlas, off, h, w, xi, yi)

        if (s.filter < FILTER_TRILINEAR or spec_id not in self.mip_info
                or duv is None):
            return _bilinear(s.address, atlas, off, h, w, u, v)

        # --- MIP lookups (reference src/GoblinTexture.cpp:131-271)
        n_levels = len(self.mip_info[spec_id][0])
        su, sv = abs(s.map_scale[0]), abs(s.map_scale[1])

        def two_levels(lvl):
            lvl = torch.clamp(lvl, 0.0, n_levels - 1)
            l0 = lvl.to(torch.int32)  # truncates
            l1 = torch.clamp(l0 + 1, max=n_levels - 1)
            return l0, l1, (lvl - l0)[..., None]

        if s.filter == FILTER_EWA and duv4 is not None:
            # The ellipse's minor axis, widened so that major / minor <=
            # max_anisotropy, picks the level (reference lookup, :158-193);
            # the lattice of bilinear taps over the ellipse in its own
            # (major, minor) frame then integrates its area, where the
            # reference scans the texels of its bounding box (:195-259).
            axu = duv4[..., 0] * su
            axv = duv4[..., 1] * sv
            ayu = duv4[..., 2] * su
            ayv = duv4[..., 3] * sv
            lx = torch.sqrt((axu * w) ** 2 + (axv * h) ** 2)
            ly = torch.sqrt((ayu * w) ** 2 + (ayv * h) ** 2)
            x_major = lx >= ly
            major = torch.maximum(lx, ly)
            minor = torch.minimum(lx, ly)
            maj_u = torch.where(x_major, axu, ayu)
            maj_v = torch.where(x_major, axv, ayv)
            min_u = torch.where(x_major, ayu, axu)
            min_v = torch.where(x_major, ayv, axv)
            max_a = float(s.max_anisotropy) or 10.0
            widen = torch.clamp(
                major / torch.clamp(minor * max_a, min=1e-12), min=1.0)
            minor = minor * widen
            min_u = min_u * widen
            min_v = min_v * widen
            l0, l1, f = two_levels(torch.log2(torch.clamp(minor, min=1.0)))
            # every tap in one batch, (taps, R); summed tap by tap after
            ab = self._on_device("ewa_lattice", atlas.device,
                                 lambda: np.float32(_EWA_LATTICE))
            a, b = ab[:, 0, None], ab[:, 1, None]
            uq = u + a * maj_u + b * min_u
            vq = v + a * maj_v + b * min_v
            taps = ((1.0 - f) * self._mip_bilinear(s, spec_id, atlas, l0, uq, vq)
                    + f * self._mip_bilinear(s, spec_id, atlas, l1, uq, vq))
            out = 0.0
            wsum = 0.0
            for k, (_, _, gw) in enumerate(_EWA_LATTICE):
                out = out + gw * taps[k]
                wsum += gw
            return out / wsum

        # trilinear: the level from the larger footprint extent, two levels
        wu = duv[..., 0].abs() * su * w
        wv = duv[..., 1].abs() * sv * h
        width = torch.clamp(torch.maximum(wu, wv), min=1e-6)
        l0, l1, f = two_levels(torch.log2(torch.clamp(width, min=1.0)))
        v0 = self._mip_bilinear(s, spec_id, atlas, l0, u, v)
        v1 = self._mip_bilinear(s, spec_id, atlas, l1, u, v)
        return (1.0 - f) * v0 + f * v1

    def _spec_uv(self, spec_id, uv, p):
        """A node's texture coordinates: the uv mapping (scale and offset),
        or the spherical mapping of the world position (reference
        SphericalMapping, src/GoblinTexture.cpp:293-307)."""
        s = self.specs[spec_id]
        if s.mapping == MAP_SPHERICAL and p is not None:
            m = self._on_device(
                (spec_id, "world_to_tex"), p.device,
                lambda: np.asarray(s.world_to_tex, np.float32))
            q = p @ m[:3, :3].T + m[:3, 3]
            ln = torch.sqrt(torch.clamp((q * q).sum(dim=-1), min=1e-30))
            vec = q / ln[..., None]
            theta = torch.acos(torch.clamp(vec[..., 2], -1.0, 1.0))
            phi = torch.atan2(vec[..., 1], vec[..., 0])
            phi = torch.where(phi < 0, phi + 2 * math.pi, phi)
            return torch.stack([phi / (2 * math.pi), theta / math.pi], dim=-1)
        return torch.stack([uv[..., 0] * s.map_scale[0] + s.map_offset[0],
                            uv[..., 1] * s.map_scale[1] + s.map_offset[1]],
                           dim=-1)

    def eval_all(self, uv, atlas, const, p=None, duv=None, duv4=None):
        """Every texture at uv (R, 2) -> (X, R, 3).

        atlas, const: the scene's tensors (scene["tex_atlas"] /
        scene["tex_const"], or the float system's). p: world positions for
        spherical mappings. duv: (R, 2) uv footprint widths for the
        box-filtered checkerboard (reference integrateChecker,
        src/GoblinTexture.cpp:371-416) and the trilinear level; duv4:
        (R, 4) = [dudx, dvdx, dudy, dvdy], EWA's ellipse axes. Without
        them the MIP filters fall back to bilinear at level 0.
        """
        n = len(self.specs)
        vals: list = [None] * n
        for i in self.order:
            s = self.specs[i]
            if s.kind == TEX_CONSTANT:
                v = const[i].expand(uv.shape[:-1] + (3,))
            elif s.kind == TEX_CHECKERBOARD:
                suv = self._spec_uv(i, uv, p)
                u_, v_ = suv[..., 0], suv[..., 1]
                c0 = (vals[s.child0] if s.child0 >= 0
                      else torch.ones_like(uv[..., :1]))
                c1 = (vals[s.child1] if s.child1 >= 0
                      else torch.zeros_like(uv[..., :1]))
                if s.checker_filter and duv is not None:
                    # analytic box filter: the share of the footprint
                    # [u - w, u + w] x [v - w, v + w] on the even squares
                    wu = torch.clamp(duv[..., 0].abs() * abs(s.map_scale[0]),
                                     min=1e-8)
                    wv = torch.clamp(duv[..., 1].abs() * abs(s.map_scale[1]),
                                     min=1e-8)

                    def stair(x):
                        # integral from 0 to x of the indicator of an even
                        # cell (a square wave of period 2)
                        per = torch.floor(x / 2.0)
                        return per + torch.clamp(x - 2.0 * per, max=1.0)

                    def frac_even(c, w):
                        return (stair(c + w) - stair(c - w)) / (2.0 * w)

                    fe_u = frac_even(u_, wu)
                    fe_v = frac_even(v_, wv)
                    # an even square: both axes even or both odd
                    w1 = fe_u * fe_v + (1.0 - fe_u) * (1.0 - fe_v)
                    v = w1[..., None] * c0 + (1.0 - w1[..., None]) * c1
                else:
                    even = torch.remainder(
                        torch.floor(u_).to(torch.int32)
                        + torch.floor(v_).to(torch.int32), 2) == 0
                    v = torch.where(even[..., None], c0, c1)
            elif s.kind == TEX_SCALE:
                v = vals[s.child0] * const[i]
            elif s.kind == TEX_IMAGE:
                v = self._eval_image(i, self._spec_uv(i, uv, p), atlas,
                                     duv=duv, duv4=duv4)
            else:
                raise ValueError(s.kind)
            vals[i] = v
        shape = uv.shape[:-1] + (3,)
        return torch.stack([v.expand(shape) for v in vals], dim=0)
