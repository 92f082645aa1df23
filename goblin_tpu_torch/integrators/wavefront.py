"""Regenerative wavefront path tracer: a fixed pool of lanes kept full
(port of goblin_tpu/integrators/wavefront.py).

The chunked driver (common.render) traces every bounce over a whole chunk,
though on bunny only 9-31% of the lanes survive the first bounce. Here a
pool of R lanes runs until the frame's samples are done: a lane whose path
ends writes its radiance to a sample buffer and pulls the next (pixel,
sample) from a counter, so its next trace is that sample's camera ray.
Every iteration is

    [one NEE shadow any-hit over the surface lanes] + [one closest-hit over
    all lanes: camera rays for fresh lanes, continuation rays for surface
    lanes] + shading

The sample streams are keyed on (pixel, s_idx, bounce) as in
integrators/path.py, so each sample's radiance is the chunked driver's;
the buffer is splatted a spp pass at a time with the same dense splat. The
loop is a Python loop that reads the device once an iteration (whether a
lane is live). Samples are taken in row-major order: goblin_tpu's screen
tile order is a TPU artifact, and only which lane carries which sample
depends on it.

A volume's (tr, Lv) over the camera segment rides with its lane and is
applied when the lane retires (L' = tr L + Lv, reference RenderTask::run).
Scenes with a BSSRDF take the chunked driver (supports()).
"""

from __future__ import annotations

import torch

from ..camera import film as film_mod
from ..core.rng import hash_uniform
from ..lights import lights as lt
from ..scene import intersect as scn
from ..shading import bsdf as bx
from . import direct
from .common import (camera_rays, crop_pixel_ids, spp_grid, splat_pass,
                     stratified_1d, stratified_2d)
from .materials import gather_material
from .path import (DIM_BSDF_COMP, DIM_BSDF_U1, DIM_BSDF_U2, DIM_LIGHT_U1,
                   DIM_LIGHT_U2, DIM_PICK)
from .volume import KEY_JITTER, eval_lv, transmittance

_BIG_T = scn.BIG_T


def supports(meta) -> bool:
    """Whether the regenerative driver covers this scene's features."""
    return not meta.has_bssrdf


def _dead_fragment(scene, meta, R, dev):
    """A fragment of R lanes that hit nothing, with every key intersect
    gives (a zero-ray intersect launches no kernel)."""
    z3 = torch.zeros((0, 3), dtype=torch.float32, device=dev)
    z1 = torch.zeros((0,), dtype=torch.float32, device=dev)
    frag = scn.intersect(scene, meta, z3, z3, z1, z1, dxd=z3, dyd=z3)
    frag = {k: v.new_zeros((R,) + v.shape[1:]) for k, v in frag.items()}
    frag["light"] -= 1
    return frag


def render_wavefront(scene, meta, spp=None, seed=None, pool=1 << 16,
                     report=None, with_stats=False, return_samples=False):
    """Path-trace the frame with path regeneration -> (H, W, 3) image on the
    scene's device; with with_stats, (image, {"iterations", "pool",
    "lane_rays", "useful_segments", "live_lanes"}), live_lanes the live
    lanes of each iteration; with return_samples, the (n_pix * n_spp, 3)
    per-sample radiance, sample s of the crop's row-major pixel k at row
    s * n_pix + k. report(done, total) after each spp pass of the resolve."""
    settings = meta.settings
    if spp is None:
        spp = int(settings.get("sample_per_pixel", 1))
    if seed is None:
        seed = int(settings.get("seed", 0))
    max_depth = int(settings.get("max_ray_depth", 5))
    cam = meta.camera
    spec = cam.film
    n_grid = spp_grid(spp)
    n_spp = n_grid * n_grid
    # the integrator's dims stratify over the declared spp, as make_li's
    n_strat = spp_grid(int(settings.get("sample_per_pixel", 1))) ** 2
    lights = scene["lights"]
    dev = scene["tri_rows"].device
    row_major = crop_pixel_ids(spec, dev).long()
    n_pix = row_major.numel()
    total = n_pix * n_spp
    R = int(min(pool, -(-total // 1024) * 1024))
    vol = meta.volume

    def step(state):
        (sample_id, counter, is_primary, bounce, tp, L, tr, Lv, frag, L_buf,
         useful) = state
        live = sample_id >= 0
        surface = live & ~is_primary
        sid = torch.clamp(sample_id, min=0)
        s_idx = sid // n_pix
        pix = row_major[sid % n_pix]
        b = bounce

        # NEE for surface lanes (reference PathTracer NEE with MIS,
        # src/GoblinPathtracer.cpp:95-160)
        u_mask = None
        if meta.has_null:
            u_mask = hash_uniform(seed, pix, s_idx, b, DIM_BSDF_COMP)
        mat = gather_material(scene, meta, frag, u_mask=u_mask)
        p, ns, wo, eps = frag["p"], frag["ns"], frag["wo"], frag["eps"]
        u_pick = stratified_1d(seed, pix, s_idx, n_strat, b, DIM_PICK)
        lid, pick_pdf = lt.pick_light(lights, u_pick)
        if meta.all_delta_lights:  # no light reads the samples
            u1 = u2 = None
        else:
            u1, u2 = stratified_2d(seed, pix, s_idx, n_strat, b,
                                   DIM_LIGHT_U1, DIM_LIGHT_U2)
        ls = direct.sample_light(scene, meta, lid, p, eps, u1, u2)
        Ld, consider = direct.light_side(scene, meta, mat, frag, ls, surface)

        # the BSDF continuation sample (surface lanes)
        bu1, bu2 = stratified_2d(seed, pix, s_idx, n_strat, b,
                                 DIM_BSDF_U1, DIM_BSDF_U2)
        bcomp = stratified_1d(seed, pix, s_idx, n_strat, b, DIM_BSDF_COMP + 3)
        bs = bx.bsdf_sample(mat, ns, frag["dpdu"], wo, bu1, bu2, bcomp,
                            bx.BSDF_ALL)
        cont_ok = surface & bs["valid"] & (bs["f"] > 0.0).any(dim=-1)

        # one closest-hit: camera rays for fresh lanes, continuation rays
        # for surface lanes
        cray = camera_rays(cam, seed, pix, s_idx, n_grid)
        fresh = live & is_primary
        prim = fresh[:, None]
        o_c = torch.where(prim, cray["o"], p)
        d_c = torch.where(prim, cray["d"], bs["wi"])
        mint_c = torch.where(fresh, cray["mint"],
                             torch.where(cont_ok, eps, _BIG_T))
        maxt_c = torch.where(fresh, cray["maxt"],
                             torch.where(cont_ok, 3.0e37, 0.0))
        frag2 = scn.intersect(scene, meta, o_c, d_c, mint_c, maxt_c,
                              dxd=cray["dxd"], dyd=cray["dyd"])
        # continuation lanes carry no uv differentials, as the chunked
        # driver's continuation fragments
        frag2["duv4"] = torch.where(prim, frag2["duv4"], 0.0)
        frag2["duv"] = torch.where(prim, frag2["duv"], 0.0)

        # the primary segment's emission and environment
        L = L + torch.where((fresh & ~frag2["hit"])[:, None],
                            direct.env_le(scene, meta, d_c), 0.0)
        L = L + torch.where((fresh & frag2["hit"])[:, None],
                            direct.area_light_le(scene, frag2, frag2["wo"]),
                            0.0)
        if vol is not None:
            # the volume over the camera segment, applied at retirement;
            # other lanes trace their shadow rays as dead lanes
            uj = hash_uniform(seed, pix, s_idx, KEY_JITTER, 0)
            mint_v = torch.where(fresh, mint_c, _BIG_T)
            maxt_v = torch.clamp(frag2["t"], max=3.0e37)
            tr = torch.where(prim, transmittance(vol, scene, o_c, d_c, mint_v,
                                                 maxt_v, uj), tr)
            Lv = torch.where(prim, eval_lv(scene, meta, vol, o_c, d_c, mint_v,
                                           maxt_v, pix, s_idx, seed), Lv)

        # the BSDF side's MIS light contribution (surface lanes)
        Ld_b = direct.bsdf_side(scene, meta, lid, frag, bs, frag2, cont_ok)
        L = direct.add_direct(L, surface, tp, Ld + Ld_b, pick_pdf)
        tp = torch.where(cont_ok[:, None], direct.bsdf_throughput(tp, bs, ns),
                         tp)

        # advance, retire, regenerate: a surface lane goes on while its
        # continuation hit something and bounces are left (bounce counts
        # the NEE rounds done; the chunked driver runs max_depth - 1)
        cont_surface = cont_ok & frag2["hit"] & (b + 1 < max_depth - 1)
        cont_primary = fresh & frag2["hit"] & (max_depth > 1)
        cont = cont_surface | cont_primary
        retire = live & ~cont
        L_out = tr * L + Lv if vol is not None else L
        # dead lanes add 0 to slot 0
        L_buf.index_add_(0, sid, torch.where(retire[:, None], L_out, 0.0))
        # retired lanes pull the next sample ids, in lane order
        rank = torch.cumsum(retire.long(), 0) - 1
        new_id = counter + rank
        sample_id = torch.where(
            retire, torch.where(new_id < total, new_id, -1), sample_id)
        counter = counter + retire.sum()
        bounce = torch.where(cont_surface, b + 1, 0)
        L = torch.where(retire[:, None], 0.0, L)
        tp = torch.where((cont_primary | retire)[:, None], 1.0, tp)
        if vol is not None:
            tr = torch.where(retire[:, None], 1.0, tr)
            Lv = torch.where(retire[:, None], 0.0, Lv)
        frag = {k: torch.where(cont.reshape((R,) + (1,) * (v.ndim - 1)),
                               frag2[k], v) for k, v in frag.items()}
        useful = useful + consider.sum() + (fresh | cont_ok).sum()
        return (sample_id, counter, retire, bounce, tp, L, tr, Lv, frag,
                L_buf, useful)

    with torch.inference_mode():
        lanes = torch.arange(R, device=dev)
        ones3 = torch.ones((R, 3), dtype=torch.float32, device=dev)
        zeros3 = torch.zeros((R, 3), dtype=torch.float32, device=dev)
        state = (
            torch.where(lanes < total, lanes, -1),
            torch.tensor(min(R, total), device=dev),
            torch.ones(R, dtype=torch.bool, device=dev),
            torch.zeros(R, dtype=torch.long, device=dev),
            ones3, zeros3, ones3, zeros3,
            _dead_fragment(scene, meta, R, dev),
            torch.zeros((total, 3), dtype=torch.float32, device=dev),
            torch.zeros((), dtype=torch.long, device=dev),
        )
        live_lanes = []
        while True:
            if with_stats:
                live_lanes.append((state[0] >= 0).sum())
            state = step(state)
            # the loop's one read of the device an iteration
            if not bool((state[0] >= 0).any()):
                break
        L_buf, useful = state[9], state[10]
        if return_samples:
            return L_buf

        # resolve: a dense filter splat a spp pass, as common.render's
        color, weight = film_mod.new_film(spec, dev)
        for s in range(n_spp):
            color, weight = splat_pass(spec, color, weight, seed, row_major,
                                       s, n_grid,
                                       L_buf[s * n_pix:(s + 1) * n_pix])
            if report is not None:
                report(s + 1, n_spp)
        img = film_mod.to_image(color, weight)
    if with_stats:
        iterations = len(live_lanes)
        return img, {"iterations": iterations, "pool": R,
                     "lane_rays": iterations * R * 2,
                     "useful_segments": int(useful),
                     "live_lanes": torch.stack(live_lanes).tolist()}
    return img
