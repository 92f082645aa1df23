"""Chunked render driver shared by the camera-sampled integrators (port of
goblin_tpu/integrators/common.py).

A pass renders one stratified sample per crop pixel: pixels go through
the integrator in row-major chunks, and the pass image is filter-splatted
densely into the film. Samples are keyed by pixel id, so the values match
goblin_tpu's (which traces in a screen-tile order) pixel for pixel.
"""

from __future__ import annotations

import math

import torch

from ..camera import film as film_mod
from ..core.rng import hash_uniform

# reserved dimension ids for the hash streams
DIM_PIXEL_X = 0
DIM_PIXEL_Y = 1
DIM_LENS_U = 2
DIM_LENS_V = 3
DIM_BASE = 4  # integrator dims start here
# bounce id used for camera-sample dims
BOUNCE_CAMERA = 0x7FFF


def spp_grid(spp: int) -> int:
    """Stratification grid edge: smallest n with n*n >= spp (reference
    roundToSquare)."""
    return int(math.ceil(math.sqrt(max(1, spp))))


def stratified_1d(seed, pixel_ids, s_idx, n_spp, bounce, dim):
    """Stratified-shuffled 1D sample: sample s_idx lands in stratum
    (s_idx + a per-(pixel, bounce, dim) rotation) mod n_spp, jittered."""
    off = torch.floor(
        hash_uniform(seed, pixel_ids, 0x57A7, bounce, dim) * n_spp
    ).to(torch.int32)
    cell = (s_idx + off) % n_spp
    j = hash_uniform(seed, pixel_ids, s_idx, bounce, dim)
    return (cell.to(torch.float32) + j) / n_spp


def stratified_2d(seed, pixel_ids, s_idx, n_spp, bounce, dim_a, dim_b):
    """Stratified-shuffled 2D pair over the g x g cell grid (n_spp = g*g)."""
    g = int(math.sqrt(n_spp))
    off = torch.floor(
        hash_uniform(seed, pixel_ids, 0x57A8, bounce, dim_a) * n_spp
    ).to(torch.int32)
    cell = (s_idx + off) % n_spp
    j1 = hash_uniform(seed, pixel_ids, s_idx, bounce, dim_a)
    j2 = hash_uniform(seed, pixel_ids, s_idx, bounce, dim_b)
    u1 = ((cell % g).to(torch.float32) + j1) / g
    u2 = (torch.div(cell, g, rounding_mode="floor").to(torch.float32)
          + j2) / g
    return u1, u2


def pixel_samples(seed, pixel_ids, x_res, s_idx, n_grid):
    """Stratified-jittered continuous image coords for sample index s_idx."""
    px = (pixel_ids % x_res).to(torch.float32)
    py = torch.div(pixel_ids, x_res, rounding_mode="floor").to(torch.float32)
    sx = float(s_idx % n_grid)
    sy = float(s_idx // n_grid)
    jx = hash_uniform(seed, pixel_ids, s_idx, BOUNCE_CAMERA, DIM_PIXEL_X)
    jy = hash_uniform(seed, pixel_ids, s_idx, BOUNCE_CAMERA, DIM_PIXEL_Y)
    return px + (sx + jx) / n_grid, py + (sy + jy) / n_grid


def make_render_pass(scene, meta, li_fn, spp, seed, chunk_size=1 << 16):
    """Build render_pass(color, weight, s_idx) -> (color, weight): one
    full-frame stratified sample per crop pixel, traced in row-major chunks
    of chunk_size pixels, then splatted densely into the film in place.
    Returns (render_pass, n_spp)."""
    cam = meta.camera
    spec = cam.film
    n_grid = spp_grid(spp)
    dev = scene["tri_rows"].device
    xs_, xc, ys_, yc = spec.crop_window()
    rows = torch.arange(ys_, ys_ + yc, dtype=torch.int32, device=dev)
    cols = torch.arange(xs_, xs_ + xc, dtype=torch.int32, device=dev)
    pixel_ids = (rows[:, None] * spec.x_res + cols[None, :]).reshape(-1)
    n_pix = pixel_ids.numel()

    def render_pass(color, weight, s_idx: int):
        L = torch.empty((n_pix, 3), dtype=torch.float32, device=dev)
        for c0 in range(0, n_pix, chunk_size):
            pix = pixel_ids[c0:c0 + chunk_size]
            x, y = pixel_samples(seed, pix, spec.x_res, s_idx, n_grid)
            if cam.is_delta:  # a pinhole or orthographic camera has no lens
                ray = cam.generate_ray(x, y)
            else:
                ray = cam.generate_ray(
                    x, y,
                    hash_uniform(seed, pix, s_idx, BOUNCE_CAMERA, DIM_LENS_U),
                    hash_uniform(seed, pix, s_idx, BOUNCE_CAMERA, DIM_LENS_V))
            L[c0:c0 + pix.numel()] = li_fn(scene, meta, ray, pix, s_idx, seed)
        jx = hash_uniform(seed, pixel_ids, s_idx, BOUNCE_CAMERA, DIM_PIXEL_X)
        jy = hash_uniform(seed, pixel_ids, s_idx, BOUNCE_CAMERA, DIM_PIXEL_Y)
        jx = (float(s_idx % n_grid) + jx) / n_grid
        jy = (float(s_idx // n_grid) + jy) / n_grid
        return film_mod.splat_dense(
            spec, color, weight, jx.reshape(yc, xc), jy.reshape(yc, xc),
            L.reshape(yc, xc, 3), ys_, xs_,
        )

    return render_pass, n_grid * n_grid


def render(scene, meta, li_fn, spp=None, seed=None, chunk_size=1 << 16,
           report=None):
    """Render with a batched radiance function
    li_fn(scene, meta, ray, pixel_ids, s_idx, seed) -> (R, 3).

    report(done, total) is called after each pass. Returns the resolved
    (H, W, 3) image on the scene's device."""
    if spp is None:
        spp = int(meta.settings.get("sample_per_pixel", 1))
    if seed is None:
        seed = int(meta.settings.get("seed", 0))
    with torch.inference_mode():
        render_pass, n_spp = make_render_pass(
            scene, meta, li_fn, spp, seed, chunk_size
        )
        color, weight = film_mod.new_film(meta.camera.film,
                                          scene["tri_rows"].device)
        for s in range(n_spp):
            color, weight = render_pass(color, weight, s)
            if report is not None:
                report(s + 1, n_spp)
        return film_mod.to_image(color, weight)
