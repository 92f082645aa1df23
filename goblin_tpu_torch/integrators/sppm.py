"""Stochastic progressive photon mapping in wavefront form (port of
goblin_tpu/integrators/sppm.py).

Per iteration (reference src/GoblinSPPM.cpp):
  1. ray pass: one camera path per pixel, with direct lighting (one light
     pick and NEE, MIS shared with the continuation ray) per bounce; the
     walk continues through non-diffuse lobes and the first diffuse (or
     the second-last) vertex becomes the pixel's visible point (:327-389);
  2. grid: photon deposits go into every cell their +-max_r cube
     overlaps (at most 8, clamp-deduped), entries sorted by cell hash
     (Teschner hash, cell edge = 2 * max radius, :240-276);
  3. photon pass, visible-point major: every visible point drains its own
     cell's deposit list into its own Phi / M (:391-462);
  4. radius and flux update, alpha = 0.7 (:548-567).
Final: L = Ld / iterations + Tau / (N_emitted * pi * R^2) (:586-600),
splatted at the pixel centres.

make_sppm splits a render into its parts: a state (per-pixel progress and
the photons emitted), one iteration on it, and the film that a state
resolves to; render_sppm is a loop over them.

Camera-path dimensions use qmc_uniform: prime-base radical inverses of the
iteration index with a per-pixel Cranley-Patterson rotation, bit-equal to
goblin_tpu's. Each bounce traces the whole frame at once. The light walk
takes the iteration's photons at once too (walk_lanes: as many whole
chunks as a share of the card's free memory holds); the grid and the drain
then run chunk by chunk over the walk's rows. The drain is a loop on the
host over the fullest cell's entries, whose count it reads from the device
once a drain.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from .. import telemetry
from ..camera import film as film_mod
from ..core import vecmath as vm
from ..core.rng import _mul32, _u32, hash_uniform
from ..core.sampling import radical_inverse
from ..lights import lights as lt
from ..scene import intersect as scn
from ..shading import bsdf as bx
from . import direct
from .common import pixel_samples, spp_grid
from .materials import gather_material

ALPHA = 0.7
PHOTON_CHUNK = 1 << 15  # photons per deposit chunk
_BIG_T = 3.0e38
# a light walk's bytes a photon: walk_light_paths holds 82 B of fields a
# vertex and copies them once more into its stacked result; a deposit row
# is 10 floats and a valid flag
_VERTEX_BYTES = 82
_ROW_BYTES = 41
WALK_MEMORY_SHARE = 0.25  # of the card's free bytes at make_sppm

# one prime base per (bounce, dim) pair, like the reference PermutedHalton
# (src/GoblinSampler.cpp:659-748); 64 primes cover 9 bounces of 7 dims
_QMC_PRIMES = (
    2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53,
    59, 61, 67, 71, 73, 79, 83, 89, 97, 101, 103, 107, 109, 113, 127, 131,
    137, 139, 149, 151, 157, 163, 167, 173, 179, 181, 191, 193, 197, 199,
    211, 223, 227, 229, 233, 239, 241, 251, 257, 263, 269, 271, 277, 281,
    283, 293, 307, 311,
)
QMC_N_DIMS = 7  # dims consumed per camera-path bounce
_QMC_SALT = 0x51C


def qmc_table(it, max_len, n_dims=QMC_N_DIMS):
    """Radical inverses of the iteration index it for every (bounce, dim)
    pair, each in its own prime base -> (max_len, n_dims) float32 on the
    CPU."""
    bases = [_QMC_PRIMES[(b * n_dims + d) % len(_QMC_PRIMES)]
             for b in range(max_len) for d in range(n_dims)]
    return radical_inverse(it, torch.tensor(bases)).reshape(max_len, n_dims)


def qmc_uniform(seed, pixel_ids, h, dim, salt=0):
    """Per-pixel low-discrepancy stream over the iteration axis: the
    bounce's radical inverse h (from qmc_table) rotated by a per-(pixel,
    salt, dim) hash shift, mod 1."""
    shift = hash_uniform(seed, pixel_ids, _QMC_SALT + salt, 0, dim)
    return torch.remainder(h + shift, 1.0)


def _hash_cells(cx, cy, cz, size):
    """Teschner hash of integer cells (their uint32 values, so negative
    cells wrap as in goblin_tpu) mod size -> int32."""
    h = (_mul32(_u32(cx), 73856093) ^ _mul32(_u32(cy), 19349663)
         ^ _mul32(_u32(cz), 83492791))
    return (h % size).to(torch.int32)


def make_ray_pass(scene, meta, seed, max_len, n_grid):
    """-> ray_pass(pixel_ids, it) -> (Ld (R, 3), visible points dict)."""
    cam = meta.camera
    spec = cam.film
    lights = scene["lights"]

    def ray_pass(pixel_ids, it: int):
        R = pixel_ids.shape[0]
        dev = pixel_ids.device
        with telemetry.span("render.camera"):
            x, y = pixel_samples(seed, pixel_ids, spec.x_res,
                                 it % (n_grid * n_grid), n_grid)
            # no lens samples: a thin-lens camera renders as a pinhole
            # here, as in goblin_tpu's SPPM
            ray = cam.generate_ray(x, y)
        frag = scn.intersect(scene, meta, ray["o"], ray["d"], ray["mint"],
                             ray["maxt"])
        Ld = torch.where(frag["hit"][:, None],
                         direct.area_light_le(scene, frag, frag["wo"]),
                         direct.env_le(scene, meta, ray["d"]))

        def zeros(*shape, dtype=torch.float32):
            return torch.zeros((R,) + shape, dtype=dtype, device=dev)

        vp = {"p": zeros(3), "ns": zeros(3), "dpdu": zeros(3), "uv": zeros(2),
              "mat": zeros(dtype=torch.int32), "wo": zeros(3), "tp": zeros(3),
              "len": zeros(dtype=torch.int32),
              "valid": zeros(dtype=torch.bool)}
        tp = torch.ones((R, 3), dtype=torch.float32, device=dev)
        active = frag["hit"]
        h_tab = qmc_table(it, max_len).tolist()

        def qmc(b, k):
            return qmc_uniform(seed, pixel_ids, h_tab[b][k], k, salt=b)

        for b in range(max_len):
            with telemetry.span("sppm.ray"):
                # dim 0 picks a mask material's lobe; dims 2-3 sample an
                # area light: neither is drawn where the scene has no use
                # for it
                mat = gather_material(
                    scene, meta, frag,
                    u_mask=qmc(b, 0) if meta.has_null else None)
                ns, wo, p = frag["ns"], frag["wo"], frag["p"]
                eps = frag["eps"]
                path_len = b + 1

                # NEE: one light pick; the continuation sample is the MIS
                # partner, as in the path tracer. No image-based light in
                # NEE, and the shadow rays are plain any-hit ones
                if meta.n_lights > 0:
                    lid, pick_pdf = lt.pick_light(lights, qmc(b, 1))
                    u1 = u2 = None
                    if not meta.all_delta_lights:
                        u1, u2 = qmc(b, 2), qmc(b, 3)
                    ls = direct.sample_light(scene, meta, lid, p, eps, u1, u2,
                                             ibl=False)
                    nee, _ = direct.light_side(scene, meta, mat, frag, ls,
                                               active, through_masks=False)

                # continuation sample (also the BSDF side of the MIS)
                bs = bx.bsdf_sample(mat, ns, frag["dpdu"], wo, qmc(b, 4),
                                    qmc(b, 5), qmc(b, 6), bx.BSDF_ALL)
                cont_ok = active & bs["valid"] & (bs["f"] > 0.0).any(dim=-1)
                frag2 = scn.intersect(scene, meta, p, bs["wi"],
                                      torch.where(cont_ok, eps, _BIG_T),
                                      torch.where(cont_ok, 3.0e37, 0.0))
                if meta.n_lights > 0:
                    nee = nee + direct.bsdf_side(scene, meta, lid, frag, bs,
                                                 frag2, cont_ok, ibl=False)
                    Ld = direct.add_direct(Ld, active, tp, nee, pick_pdf)

                # stop at a diffuse vertex (record the visible point) or go
                # on
                is_diffuse = (bx.lobe_of(mat["mtype"]) & bx.BSDF_DIFFUSE) != 0
                record = (active if path_len == max_len - 1
                          else active & is_diffuse)
                rec = record[:, None]
                for k, src in (("p", p), ("ns", ns), ("dpdu", frag["dpdu"]),
                               ("wo", wo), ("uv", frag["uv"]), ("tp", tp)):
                    vp[k] = torch.where(rec, src, vp[k])
                vp["mat"] = torch.where(record, frag["mat"], vp["mat"])
                vp["len"] = torch.where(record, path_len, vp["len"])
                vp["valid"] = vp["valid"] | record

                tp2 = direct.bsdf_throughput(tp, bs, ns)
                active = active & ~record & cont_ok & frag2["hit"]
                tp = torch.where(active[:, None], tp2, tp)
                frag = {k: torch.where(
                    active.reshape((R,) + (1,) * (v.ndim - 1)), frag2[k], v)
                    for k, v in frag.items()}
        return Ld, vp

    return ray_pass


def _grid_entries(rows, valid, bbox_min, inv_len, max_r, n_pix):
    """The grid's entries of a chunk's deposits rows (N, 10), valid (N,):
    each deposit in the <= 8 cells its +-max_r cube overlaps (clamp-deduped)
    -> (entry_hash (8N,) sorted, entry_idx (8N,) into rows)."""
    dp = rows[:, 0:3]
    lo = torch.floor((dp - max_r - bbox_min) * inv_len).to(torch.int32)
    hi = torch.floor((dp + max_r - bbox_min) * inv_len).to(torch.int32)
    idx = torch.arange(rows.shape[0], dtype=torch.int32, device=rows.device)
    hashes, seen = [], []
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                cx = torch.minimum(lo[:, 0] + dx, hi[:, 0])
                cy = torch.minimum(lo[:, 1] + dy, hi[:, 1])
                cz = torch.minimum(lo[:, 2] + dz, hi[:, 2])
                dup = torch.zeros_like(valid)
                for px, py, pz in seen:
                    dup = dup | ((cx == px) & (cy == py) & (cz == pz))
                seen.append((cx, cy, cz))
                hashes.append(torch.where(valid & ~dup,
                                          _hash_cells(cx, cy, cz, n_pix),
                                          0x7FFFFFFF))
    entry_hash = torch.cat(hashes)
    entry_idx = idx.repeat(8)
    entry_hash, order = torch.sort(entry_hash, stable=True)
    return entry_hash, entry_idx[order]


def _drain_turns(start, end, n_entries):
    """The turns of goblin_tpu's drain loop (while any lane has start + k <
    end): the fullest cell's entries, read from the device once a drain."""
    n_turns = min(int((end - start).max()), n_entries)
    telemetry.count("sppm.drain_reads")
    telemetry.count("sppm.drain_turns", n_turns)
    return n_turns


def walk_lanes(n_pix, cs, max_len, free_bytes):
    """Photons a light walk takes, a whole number of chunks of cs: all the
    iteration's chunks (n_pix over cs, rounded up) where the walk's bytes
    fit WALK_MEMORY_SHARE of free_bytes, else as many chunks as fit, never
    fewer than one. free_bytes None (the CPU): all the chunks."""
    n_chunks = -(-n_pix // cs)
    if free_bytes is None:
        return n_chunks * cs
    per_photon = 2 * _VERTEX_BYTES * max_len + _ROW_BYTES * (max_len - 1)
    fit = int(free_bytes * WALK_MEMORY_SHARE) // (cs * per_photon)
    return cs * max(1, min(n_chunks, fit))


def make_photon_walk(scene, meta, seed, max_len):
    """-> walk(photon_ids, it) -> (rows (D, N, 10) [p, wi, wgt, path_len],
    valid (D, N)): each photon's light walk and its deposits at vertices
    1 .. D = max_len - 1 (vertex d has path length d + 1; direct light is
    the ray pass's NEE). A photon's streams hash (seed, its id, it), so a
    walk over any set of ids gives each photon the same rows."""
    from ..splatting import walk_light_paths

    lights = scene["lights"]

    def walk(photon_ids, it):
        telemetry.count("sppm.photons", photon_ids.shape[0])
        telemetry.count("sppm.photon_walks")
        with telemetry.span("sppm.photon"):
            em, verts = walk_light_paths(scene, meta, photon_ids, it, seed,
                                         max_len + 1, mode=bx.MODE_RADIANCE)
            le_scale = lt.eval_emission(
                lights, em["lid"], em["n"], em["dir"],
                env_le=direct.env_le_at(scene, meta, em["dir"]))
            wgt = verts["tp"][1:] * le_scale
            D, N = wgt.shape[:2]
            plen = torch.arange(2, D + 2, dtype=torch.float32,
                                device=wgt.device)
            rows = torch.cat([verts["p"][1:], verts["wo_prev"][1:], wgt,
                              plen[:, None, None].expand(D, N, 1)], dim=-1)
            return rows, verts["valid"][1:]

    return walk


def chunk_deposits(rows, valid, lo, hi):
    """Photons lo .. hi - 1 of a walk's rows, in a chunk's (depth, photon)
    order -> (rows ((hi - lo) D, 10), valid ((hi - lo) D,))."""
    return rows[:, lo:hi].reshape(-1, 10), valid[:, lo:hi].reshape(-1)


def make_photon_passes(scene, meta, seed, max_len, n_pix):
    """Visible-point-major photon deposit (goblin_tpu's gather form): photon
    deposits are hashed into the grid, each into the <= 8 cells its +-max_r
    cube overlaps (clamp-deduped), and every visible point drains exactly
    its own cell, accumulating Phi / M in its own lane. M counts the
    deposits that pass the distance test; there is no deposit cap.

    Returns (deposit_chunk, vp_drain):
      deposit_chunk(photon_ids, it, bbox_min, inv_len, max_r)
        -> (rows (N, 10) [p, wi, wgt, path_len], entry_hash (8N,) sorted,
            entry_idx (8N,)): a chunk's walk (make_photon_walk) and grid
      vp_drain(vp, radius, rows, entry_hash, entry_idx, bbox_min, inv_len,
               Phi, Mi) -> (Phi, Mi)
    """
    walk = make_photon_walk(scene, meta, seed, max_len)

    def deposit_chunk(photon_ids, it, bbox_min, inv_len, max_r):
        rows, valid = walk(photon_ids, it)
        with telemetry.span("sppm.grid"):
            rows, valid = chunk_deposits(rows, valid, 0, rows.shape[1])
            return rows, *_grid_entries(rows, valid, bbox_min, inv_len,
                                        max_r, n_pix)

    @telemetry.spanned("sppm.drain")
    def vp_drain(vp, radius, rows, entry_hash, entry_idx, bbox_min, inv_len,
                 Phi, Mi):
        p = vp["p"]
        E = entry_hash.shape[0]
        with telemetry.span("sppm.grid"):
            c = torch.floor((p - bbox_min) * inv_len).to(torch.int32)
            h = _hash_cells(c[:, 0], c[:, 1], c[:, 2], n_pix)
            start = torch.searchsorted(entry_hash, h)
            end = torch.searchsorted(entry_hash, h, right=True)
            end = torch.where(vp["valid"], end, start)
        # per visible point, loop invariant
        mat_v = gather_material(scene, meta, {"mat": vp["mat"], "uv": vp["uv"]})
        ns, wo = vp["ns"], vp["wo"]
        r2 = radius * radius
        budget = float(max_len) - vp["len"].to(torch.float32)
        for k in range(_drain_turns(start, end, E)):
            row = rows[entry_idx[torch.clamp(start + k, max=E - 1)].long()]
            dp, wi, wgt, plen = row[:, 0:3], row[:, 3:6], row[:, 6:9], row[:, 9]
            ok = ((start + k < end) & (vm.squared_length(dp - p) <= r2)
                  & (plen <= budget))
            fs = bx.bsdf_eval(mat_v, ns, wo, wi, bx.BSDF_ALL)
            Phi = Phi + torch.where(ok[:, None], fs * wgt, 0.0)
            Mi = Mi + ok.to(torch.float32)
        return Phi, Mi

    return deposit_chunk, vp_drain


def vp_cell_meta(vp, radius):
    """Cell layout of an iteration: bbox over the valid visible points,
    cell edge = 2 * max radius (reference SpatialHashGrids::rebuild,
    src/GoblinSPPM.cpp:240-276). -> (bbox_min (3,), 1 / cell, max_r)."""
    valid = vp["valid"]
    pmin = torch.where(valid[:, None], vp["p"], 3e38).min(dim=0).values
    max_r = torch.where(valid, radius, 0.0).max()
    cell = 2.0 * torch.clamp(max_r, min=1e-12)
    return pmin - max_r, 1.0 / cell, max_r


def save_sppm_state(path, state):
    """Checkpoint the per-pixel SPPM progress: state is the dict that
    render_sppm(return_state=True) returns."""
    np.savez(path, **{k: v.cpu().numpy() if isinstance(v, torch.Tensor)
                      else np.asarray(v) for k, v in state.items()})


def load_sppm_state(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


class SPPM(NamedTuple):
    """One SPPM render's parts (make_sppm). A state is the dict that
    render_sppm(return_state=True) returns: per-pixel Ld_acc, Ni, Tau and
    radius, the photons emitted so far, and `it`, the next iteration."""
    new_state: Callable  # (state=None) -> a fresh state, or state resumed
    iterate: Callable  # (state, it) -> state, iteration it added in place
    film: Callable  # (state, iterations) -> (color, weight) of the film


def make_sppm(scene, meta, chunk_size=PHOTON_CHUNK, iterations=None,
              seed=None):
    """-> SPPM for the scene: iteration it's streams are a pure function of
    (seed, it), so a state can take iterations in any order and resume
    anywhere. iterations (default: the scene's sample_per_pixel) sets the
    camera's stratification; chunk_size: photons per deposit chunk, the
    grid's and the drain's unit (the light walk takes as many chunks at
    once as walk_lanes allows)."""
    spec = meta.camera.film
    if iterations is None:
        iterations = int(meta.settings.get("sample_per_pixel", 1))
    if seed is None:
        seed = int(meta.settings.get("seed", 0))
    max_len = max(2, int(meta.settings.get("max_ray_depth", 5)))
    init_radius = float(meta.settings.get("initial_radius", -1.0))
    dev = scene["tri_rows"].device

    xs_, xc, ys_, yc = spec.crop_window()
    n_pix = xc * yc
    rows = torch.arange(ys_, ys_ + yc, dtype=torch.int32, device=dev)
    cols = torch.arange(xs_, xs_ + xc, dtype=torch.int32, device=dev)
    pixel_ids = (rows[:, None] * spec.x_res + cols[None, :]).reshape(-1)
    ray_pass = make_ray_pass(scene, meta, seed, max_len, spp_grid(iterations))
    walk = make_photon_walk(scene, meta, seed + 77, max_len)
    _, vp_drain = make_photon_passes(scene, meta, seed + 77, max_len, n_pix)
    # whole chunks; emitted counts every photon traced
    cs = min(chunk_size, n_pix)
    n_photons = -(-n_pix // cs) * cs
    lanes = walk_lanes(n_pix, cs, max_len,
                       torch.cuda.mem_get_info(dev)[0]
                       if dev.type == "cuda" else None)

    def new_state(state=None):
        if state is not None:
            out = {k: torch.as_tensor(state[k], device=dev)
                   for k in ("Ld_acc", "Ni", "Tau", "radius")}
            out.update(emitted=int(state["emitted"]), it=int(state["it"]))
            return out
        return {
            "Ld_acc": torch.zeros((n_pix, 3), dtype=torch.float32,
                                  device=dev),
            "Ni": torch.zeros(n_pix, dtype=torch.float32, device=dev),
            "Tau": torch.zeros((n_pix, 3), dtype=torch.float32, device=dev),
            "radius": torch.full((n_pix,), init_radius, dtype=torch.float32,
                                 device=dev),
            "emitted": 0, "it": 0}

    def iterate(state, it: int):
        telemetry.count("render.samples", n_pix)
        with telemetry.once("setup.first_pass"), \
                telemetry.span("render.pass"):
            Ld_it, vp = ray_pass(pixel_ids, it)
            state["Ld_acc"] = state["Ld_acc"] + Ld_it
            radius, emitted = state["radius"], state["emitted"]
            if emitted == 0 and init_radius <= 0.0:
                radius = _auto_radius(vp, xc, yc).expand(n_pix).clone()
            with telemetry.span("sppm.grid"):
                bbox_min, inv_len, max_r = vp_cell_meta(vp, radius)
            Phi = torch.zeros((n_pix, 3), dtype=torch.float32, device=dev)
            Mi = torch.zeros(n_pix, dtype=torch.float32, device=dev)
            for w0 in range(0, n_photons, lanes):
                ids = torch.arange(emitted + w0,
                                   emitted + min(w0 + lanes, n_photons),
                                   dtype=torch.int32, device=dev)
                rows_w, valid_w = walk(ids, it)
                for lo in range(0, ids.shape[0], cs):
                    with telemetry.span("sppm.grid"):
                        rows_c, valid_c = chunk_deposits(rows_w, valid_w, lo,
                                                         lo + cs)
                        e_hash, e_idx = _grid_entries(
                            rows_c, valid_c, bbox_min, inv_len, max_r, n_pix)
                    Phi, Mi = vp_drain(vp, radius, rows_c, e_hash, e_idx,
                                       bbox_min, inv_len, Phi, Mi)
            with telemetry.span("sppm.update"):
                state["Ni"], state["Tau"], state["radius"] = _update(
                    state["Ni"], state["Tau"], radius, Phi, Mi, vp["tp"],
                    vp["valid"])
            state["emitted"] = emitted + n_photons
            state["it"] = it + 1
        return state

    def film(state, iterations: int):
        radius = state["radius"]
        L = state["Ld_acc"] / max(iterations, 1) + state["Tau"] / torch.clamp(
            state["emitted"] * math.pi * (radius * radius)[:, None],
            min=1e-20)
        # splat with the film filter at the pixel centres
        color, weight = film_mod.new_film(spec, dev)
        px = (pixel_ids % spec.x_res).to(torch.float32) + 0.5
        py = torch.div(pixel_ids, spec.x_res,
                       rounding_mode="floor").to(torch.float32) + 0.5
        return film_mod.splat(spec, color, weight, px, py, L)

    return SPPM(new_state, iterate, film)


def render_sppm(scene, meta, chunk_size=PHOTON_CHUNK, iterations=None,
                seed=None,
                state=None, return_state=False, report=None):
    """Render SPPM -> image (H, W, 3) on the scene's device, or (image,
    state) with return_state. state (from return_state, possibly through
    save_sppm_state / load_sppm_state) resumes at its iteration with the
    same per-iteration streams, bit-identical to an uninterrupted run.
    chunk_size: photons per deposit chunk; report(done, total) is called
    after each iteration."""
    if iterations is None:
        iterations = int(meta.settings.get("sample_per_pixel", 1))
    sppm = make_sppm(scene, meta, chunk_size, iterations, seed)
    with torch.inference_mode():
        st = sppm.new_state(state)
        for it in range(st["it"], iterations):
            sppm.iterate(st, it)
            if report is not None:
                report(it + 1, iterations)
        img = film_mod.to_image(*sppm.film(st, iterations))
    if return_state:
        st["it"] = iterations
        return img, st
    return img


def _auto_radius(vp, xc, yc):
    """Initial radius when the scene sets none (reference :241-253): the
    visible points' mean bbox edge over the mean film edge, times 2."""
    v = vp["valid"][:, None]
    lo = torch.where(v, vp["p"], 3e38).min(dim=0).values
    hi = torch.where(v, vp["p"], -3e38).max(dim=0).values
    r0 = ((hi - lo).sum() / 3.0) / ((xc + yc) / 2.0) * 2.0
    return torch.where(vp["valid"].any() & (r0 > 0.0), r0, 1e-5)


def _update(Ni, Tau, radius, Phi, Mi, vp_tp, vp_valid):
    """Progressive radius and flux update (reference :548-567)."""
    has = vp_valid & (Mi > 0)
    new_n = Ni + ALPHA * Mi
    new_r = radius * torch.sqrt(new_n / torch.clamp(Ni + Mi, min=1e-12))
    q = new_r / torch.clamp(radius, min=1e-20)
    ratio = torch.where(has, q * q, 1.0)
    new_tau = (Tau + vp_tp * Phi) * ratio[:, None]
    return (torch.where(has, new_n, Ni),
            torch.where(has[:, None], new_tau, Tau),
            torch.where(has, new_r, radius))
