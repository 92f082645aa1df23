"""Participating media: one homogeneous or heterogeneous volume region
(port of goblin_tpu/integrators/volume.py).

Reference behaviour (src/GoblinVolume.{h,cpp}, GoblinRenderer.cpp:296-455):
- homogeneous: Beer's-law transmittance; in-scatter by equi-angular and
  distance sampling towards a light pivot, combined by MIS
  (Kulla-Fajardo 2012);
- heterogeneous: a Mitsuba .vol density grid (trilinear; the density is
  sigma_t), jittered ray marching for transmittance and in-scatter;
- Henyey-Greenstein phase function;
- applied by the path tracer to the camera ray over [mint, hit t]:
  L = tr * L + Lv.

The heterogeneous march takes march_steps(vol) steps, each with one
any-hit shadow ray and a transmittance march of march_steps steps towards
the light. That inner march runs as one batch over its steps, (R, n)
points at once, instead of a loop: a chunk's launches grow with n, not
n^2. Its optical depth is summed over the batch, so it rounds differently
from goblin_tpu's running sum (a few float32 ulps). Shadow rays of lanes
that cannot count go to the trace as dead lanes (mint = BIG_T, maxt = 0).
Every shadow ray takes the plain occluded(), which counts a mask surface
as opaque, as goblin_tpu's does.

A deliberate divergence: a shadow ray stops LIGHT_GAP short of its light
sample. goblin_tpu ends it on the sample itself (sample_li with eps = 0),
so an area or sphere light's own surface occludes the ray wherever float
rounding puts the hit at or before the sample -- about half the lanes, and
different ones on every device and compiler.
"""

from __future__ import annotations

import functools
import struct
from dataclasses import dataclass

import numpy as np
import torch

from ..camera.film import luminance
from ..core import vecmath as vm
from ..core.rng import hash_uniform
from ..core.sampling import (equi_angular_pdf, equi_angular_sample,
                             exponential_pdf_range, exponential_sample_range,
                             power_heuristic)
from ..lights import lights as lt
from ..scene import intersect as scn

KEY_JITTER = 0x7F0  # the camera segment's transmittance jitter, dim 0
KEY_HOMOGENEOUS = 0x7F1  # homogeneous sample i: dims 16 i + k; march jitter
KEY_MARCH = (0x7F2, 0x7F3, 0x7F4, 0x7F5)  # march step i: pick, u1, u2, tr
MAX_MARCH_STEPS = 1024
SHADOW_MINT = 1e-4  # where a shadow ray starts, as in goblin_tpu
LIGHT_GAP = 1e-4  # how far short of its light sample it stops


def march_steps(vol) -> int:
    """The heterogeneous march's step count: the volume's diagonal (scaled
    by the largest column norm of to_world) over step_size, in [4, 1024].
    Each ray then steps seg / n, never coarser than step_size."""
    diag = float(np.linalg.norm(np.asarray(vol.box_max)
                                - np.asarray(vol.box_min)))
    if vol.to_world:
        m = np.asarray(vol.to_world, np.float32).reshape(4, 4)
        diag *= float(max(np.linalg.norm(m[:3, k]) for k in range(3)))
    n = int(np.ceil(diag / max(vol.step_size, 1e-6)))
    return max(4, min(n, MAX_MARCH_STEPS))


@dataclass(frozen=True)
class VolumeSpec:
    kind: str = "homogeneous"  # or "heterogeneous"
    to_world: tuple = ()  # 4x4 row-major
    to_local: tuple = ()
    box_min: tuple = (0.0, 0.0, 0.0)
    box_max: tuple = (1.0, 1.0, 1.0)
    attenuation: tuple = (0.0, 0.0, 0.0)  # sigma_t (homogeneous)
    albedo: tuple = (0.0, 0.0, 0.0)
    emission: tuple = (0.0, 0.0, 0.0)
    g: float = 0.0
    sample_num: int = 5
    step_size: float = 0.1
    grid_shape: tuple = ()  # (nz, ny, nx), heterogeneous


def phase_hg(wi, wo, g: float):
    """Henyey-Greenstein (reference GoblinVolume.h:126-134); isotropic for
    |g| < 1e-3."""
    cos_t = vm.dot(wi, wo)
    if abs(g) < 1e-3:
        return torch.full_like(cos_t, 0.25 * vm.INV_PI)
    return 0.25 * vm.INV_PI * (1.0 - g * g) / torch.pow(
        torch.clamp(1.0 + g * g - 2.0 * g * cos_t, min=1e-8), 1.5)


@functools.lru_cache(maxsize=64)
def _const(values: tuple, device, dtype=torch.float32):
    """A small constant tensor, made once a device (no copy a call), and
    outside inference mode, so that a gradient pass after a render may
    save it for backward."""
    with torch.inference_mode(False):
        return torch.tensor(values, dtype=dtype, device=device)


def _vec(v, like):
    return _const(tuple(float(x) for x in v), like.device)


def _local(vol: VolumeSpec, x, point: bool):
    """World points (point=True) or directions to the volume's space."""
    m = np.asarray(vol.to_local, np.float32).reshape(4, 4)
    y = vm.mat3_apply(m[:3, :3].tolist(), x)
    return y + _vec(m[:3, 3], x) if point else y


def intersect_volume(vol: VolumeSpec, o, d, mint, maxt):
    """Slab test in the volume's space -> (hit, t0, t1), t in the world
    ray's parameter (the reference does not renormalise the direction). A
    zero direction component is taken as 1e-30."""
    ol = _local(vol, o, True)
    dl = _local(vol, d, False)
    inv = 1.0 / torch.where(dl == 0.0, 1e-30, dl)
    t0 = (_vec(vol.box_min, o) - ol) * inv
    t1 = (_vec(vol.box_max, o) - ol) * inv
    tn = torch.maximum(torch.minimum(t0, t1).amax(dim=-1), mint)
    tf = torch.minimum(torch.maximum(t0, t1).amin(dim=-1), maxt)
    return tn < tf, tn, tf


def eval_density(vol: VolumeSpec, grid, p):
    """Trilinear density at world points p (..., 3) over the grid (nz, ny,
    nx) spanning [box_min, box_max]; zero outside. The eight corners are
    added in goblin_tpu's order (z, then y, then x outermost first)."""
    bmin, bmax = _vec(vol.box_min, p), _vec(vol.box_max, p)
    u = (_local(vol, p, True) - bmin) / torch.clamp(bmax - bmin, min=1e-20)
    nz, ny, nx = vol.grid_shape
    f = torch.stack([u[..., 0] * nx, u[..., 1] * ny, u[..., 2] * nz],
                    dim=-1) - 0.5
    i0 = torch.floor(f)
    frac = f - i0
    i0 = i0.to(torch.int64)
    hi = _const((nx - 1, ny - 1, nz - 1), p.device, torch.int64)
    i_lo = torch.minimum(torch.clamp(i0, min=0), hi)
    i_hi = torch.minimum(torch.clamp(i0 + 1, min=0), hi)
    flat = grid.reshape(-1)
    inside = ((u >= 0.0) & (u <= 1.0)).all(dim=-1)
    out = None
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                ix = (i_hi if dx else i_lo)[..., 0]
                iy = (i_hi if dy else i_lo)[..., 1]
                iz = (i_hi if dz else i_lo)[..., 2]
                tx, ty, tz = frac[..., 0], frac[..., 1], frac[..., 2]
                w = ((tx if dx else 1 - tx) * (ty if dy else 1 - ty)
                     * (tz if dz else 1 - tz))
                term = w * flat[(iz * ny + iy) * nx + ix]
                out = term if out is None else out + term
    return torch.where(inside, out, 0.0)


def eval_sigma(vol: VolumeSpec, scene, p):
    """-> (sigma_t, sigma_s (..., 3), emission) at world points p. For the
    grid, sigma_t and emission are (..., 1), as in goblin_tpu."""
    if vol.kind == "homogeneous":
        pl = _local(vol, p, True)
        inside = ((pl >= _vec(vol.box_min, p))
                  & (pl <= _vec(vol.box_max, p))).all(dim=-1)[..., None]
        sigma_t = _vec(vol.attenuation, p) * inside
        return (sigma_t, sigma_t * _vec(vol.albedo, p),
                _vec(vol.emission, p) * inside)
    sigma_t = eval_density(vol, scene["vol_grid"], p)[..., None]
    return sigma_t, sigma_t * _vec(vol.albedo, p), torch.zeros_like(sigma_t)


def transmittance(vol: VolumeSpec, scene, o, d, mint, maxt, u_jitter):
    """Transmittance along o + t d over [mint, maxt] -> (R, 3): Beer's law
    (homogeneous; u_jitter unused), or a march of march_steps(vol) jittered
    steps over the ray's segment, all steps in one batch."""
    hit, t0, t1 = intersect_volume(vol, o, d, mint, maxt)
    seg = torch.clamp(t1 - t0, min=0.0)
    if vol.kind == "homogeneous":
        dlen = torch.sqrt(vm.squared_length(d))
        tr = torch.exp(-(seg * dlen)[..., None] * _vec(vol.attenuation, o))
        return torch.where(hit[..., None], tr, 1.0)
    n = march_steps(vol)
    step = seg / n
    ts = (t0 + u_jitter * step)[..., None] + step[..., None] * torch.arange(
        n, dtype=torch.float32, device=o.device)
    pts = o[..., None, :] + ts[..., None] * d[..., None, :]
    s_t = eval_sigma(vol, scene, pts)[0][..., 0]  # (R, n)
    tau = torch.where(ts <= t1[..., None], s_t * step[..., None], 0.0).sum(-1)
    tr = torch.exp(-tau)[..., None].expand(tau.shape + (3,))
    return torch.where(hit[..., None], tr, 1.0)


def apply_volume(scene, meta, ray, hit_t, L, pixel_ids, s_idx, seed):
    """tr * L + Lv over the camera ray's segment [mint, hit_t] (the
    reference's render task); L unchanged without a volume."""
    vol = meta.volume
    if vol is None:
        return L
    o, d, mint = ray["o"], ray["d"], ray["mint"]
    maxt = torch.clamp(hit_t, max=3.0e37)
    uj = hash_uniform(seed, pixel_ids, s_idx, KEY_JITTER, 0)
    tr = transmittance(vol, scene, o, d, mint, maxt, uj)
    Lv = eval_lv(scene, meta, vol, o, d, mint, maxt, pixel_ids, s_idx, seed)
    return tr * L + Lv


def _visible(scene, meta, p, ls, ok):
    """Lanes of ok whose shadow ray from p to the light sample ls is not
    blocked; the others trace as dead lanes."""
    occ = scn.occluded(scene, meta, p, ls["wi"],
                       torch.where(ok, SHADOW_MINT, scn.BIG_T),
                       torch.where(ok, ls["shadow_maxt"] - LIGHT_GAP, 0.0))
    return ok & ~occ


def eval_lv(scene, meta, vol: VolumeSpec, o, d, mint, maxt, pixel_ids,
            s_idx, seed):
    """Single-scatter in-scatter and emission along the segment -> (R, 3).
    Homogeneous: sample_num samples, each a light pick, a pivot on the
    light, then one equi-angular and one distance sample, each with its
    shadow ray. Heterogeneous: march_steps(vol) steps, each with a light
    pick, its shadow ray and a transmittance march towards the light."""
    lights = scene["lights"]
    tri_data = {"em_rows": scene["em_rows"]}
    hit, t0, t1 = intersect_volume(vol, o, d, mint, maxt)
    valid_seg = hit & ((t1 - t0) > 1e-5)
    R = o.shape[0]
    Lv = torch.zeros((R, 3), dtype=torch.float32, device=o.device)
    if meta.n_lights == 0:
        return Lv
    zeros = torch.zeros((R,), dtype=torch.float32, device=o.device)

    def u(key, k):
        return hash_uniform(seed, pixel_ids, s_idx, key, k)

    if vol.kind == "homogeneous":
        n = max(1, vol.sample_num)
        # exponential sampling degenerates at sigma = 0: clamp (it then
        # draws nearly uniformly)
        sigma_lum = max(float(luminance(np.asarray(vol.attenuation,
                                                  np.float32))), 1e-5)
        for i in range(n):
            base = 16 * i
            lid, pick_pdf = lt.pick_light(lights, u(KEY_HOMOGENEOUS, base))
            # the light's pivot (samplePosition)
            p_light = lt.sample_emission(
                lights, tri_data, lid, *(u(KEY_HOMOGENEOUS, base + k)
                                         for k in (1, 2, 3, 4)))["p"]
            delta = vm.dot(p_light - o, d)
            a = t0 - delta
            b = t1 - delta
            D = torch.clamp(torch.sqrt(vm.squared_length(
                p_light - (o + delta[..., None] * d))), min=1e-8)
            theta_a = torch.atan2(a, D)
            theta_b = torch.atan2(b, D)

            def in_scatter(t_s, pdf_t, pdf_other, k1, k2):
                p_s = o + (delta + t_s)[..., None] * d
                s_t, s_s, _ = eval_sigma(vol, scene, p_s)
                tr_seg = torch.exp(
                    -s_t * torch.clamp(t_s - a, min=0.0)[..., None])
                ls = lt.sample_li(lights, tri_data, lid, p_s, zeros,
                                  u(KEY_HOMOGENEOUS, base + k1),
                                  u(KEY_HOMOGENEOUS, base + k2))
                vis = _visible(scene, meta, p_s, ls,
                               valid_seg & (ls["pdf"] > 0.0))
                tr_light = transmittance(vol, scene, p_s, ls["wi"], zeros,
                                         ls["shadow_maxt"], None)
                Ld = tr_light * ls["Li"] / torch.clamp(
                    pick_pdf * ls["pdf"], min=1e-20)[..., None]
                ph = phase_hg(d, ls["wi"], vol.g)
                w = power_heuristic(1.0, pdf_t, 1.0, pdf_other)
                return torch.where(
                    vis[..., None],
                    (w / torch.clamp(pdf_t, min=1e-20))[..., None]
                    * tr_seg * s_s * ph[..., None] * Ld,
                    0.0)

            # the equi-angular sample, then the distance sample
            te = equi_angular_sample(u(KEY_HOMOGENEOUS, base + 5), D,
                                     theta_a, theta_b)
            Lv = Lv + in_scatter(
                te, equi_angular_pdf(te, D, theta_a, theta_b),
                exponential_pdf_range(te, sigma_lum, a, b), 6, 7)
            td = exponential_sample_range(u(KEY_HOMOGENEOUS, base + 8),
                                          sigma_lum, a, b)
            Lv = Lv + in_scatter(
                td, exponential_pdf_range(td, sigma_lum, a, b),
                equi_angular_pdf(td, D, theta_a, theta_b), 10, 11)
        return Lv / n

    # heterogeneous: a running transmittance from the segment's start, the
    # step of each ray its segment over march_steps (the grid emits nothing)
    n_steps = march_steps(vol)
    step = torch.clamp(t1 - t0, min=0.0) / n_steps
    t = t0 + u(KEY_HOMOGENEOUS, 0) * step
    prev_t = t
    tr = torch.ones((R, 3), dtype=torch.float32, device=o.device)
    k_pick, k_u1, k_u2, k_tr = KEY_MARCH
    for i in range(n_steps):
        p = o + t[..., None] * d
        s_t, s_s, _ = eval_sigma(vol, scene, p)
        tr = tr * torch.exp(-s_t * (t - prev_t)[..., None])
        active = valid_seg & (t <= t1)
        # goblin_tpu writes this pick's u as u(32) * 0 + the hash: the hash
        lid, pick_pdf = lt.pick_light(lights, u(k_pick, i))
        ls = lt.sample_li(lights, tri_data, lid, p, zeros, u(k_u1, i),
                          u(k_u2, i))
        vis = _visible(scene, meta, p, ls, active & (ls["pdf"] > 0.0))
        tr_light = transmittance(vol, scene, p, ls["wi"], zeros,
                                 ls["shadow_maxt"], u(k_tr, i))
        Ld = tr_light * ls["Li"] / torch.clamp(pick_pdf * ls["pdf"],
                                               min=1e-20)[..., None]
        ph = phase_hg(d, ls["wi"], vol.g)
        Lv = Lv + torch.where(vis[..., None],
                              tr * s_s * ph[..., None] * Ld, 0.0)
        t, prev_t = t + step, t
    return Lv * step[..., None]


VOL_DTYPES = {1: np.float32, 2: np.float16, 3: np.uint8}


def load_vol(path: str):
    """A Mitsuba .vol density grid -> (grid (nz, ny, nx) float32 of its
    first channel, bbox (xmin, ymin, zmin, xmax, ymax, zmax)). Encodings: 1
    float32, 2 float16, 3 uint8 (/ 255)."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:3] != b"VOL":
        raise ValueError("not a .vol file")
    enc, nx, ny, nz, ch = struct.unpack_from("<iiiii", buf, 4)
    bbox = struct.unpack_from("<6f", buf, 24)
    if enc not in VOL_DTYPES:
        raise ValueError(f"unsupported .vol encoding {enc}")
    data = np.frombuffer(buf, VOL_DTYPES[enc], nx * ny * nz * ch, 48)
    data = data.astype(np.float32)
    if enc == 3:
        data = data / 255.0
    grid = data.reshape(nz, ny, nx, ch)[..., 0]
    return np.ascontiguousarray(grid, np.float32), bbox


def write_vol(path: str, grid, bbox):
    """Write a one-channel grid (nz, ny, nx) as a Mitsuba .vol file of
    float16 values (encoding 2)."""
    grid = np.asarray(grid, np.float32)
    nz, ny, nx = grid.shape
    with open(path, "wb") as f:
        f.write(b"VOL" + bytes([3]))
        f.write(struct.pack("<iiiii", 2, nx, ny, nz, 1))
        f.write(struct.pack("<6f", *bbox))
        f.write(grid.astype(np.float16).tobytes())
