"""Unidirectional path tracer with NEE + MIS in wavefront form (port of
goblin_tpu/integrators/path.py).

Per bounce (reference src/GoblinPathtracer.cpp:50-208): one power-CDF
light pick, one NEE shadow ray (MIS with the power heuristic; none for
delta lights), and one BSDF continuation sample whose hit doubles as the
BSDF-side light contribution. Specular lobes take full weight on the BSDF
side. No Russian roulette: max_ray_depth - 1 bounces. Inactive lanes are
masked. A shadow ray punches through mask (null-lobe) surfaces with their
attenuation. When every light is a delta light, a BSDF ray can never hit
an emitter, so the last bounce skips its continuation trace.
"""

from __future__ import annotations

import torch

from ..core import vecmath as vm
from ..core.rng import hash_uniform
from ..core.sampling import power_heuristic
from ..lights import lights as lt
from ..scene import intersect as scn
from ..shading import bsdf as bx
from .common import DIM_BASE, spp_grid, stratified_1d, stratified_2d
from .materials import gather_material

# per-bounce dimension layout (goblin_tpu's)
DIM_PICK = DIM_BASE + 0
DIM_LIGHT_U1 = DIM_BASE + 1
DIM_LIGHT_U2 = DIM_BASE + 2
DIM_BSDF_U1 = DIM_BASE + 3
DIM_BSDF_U2 = DIM_BASE + 4
DIM_BSDF_COMP = DIM_BASE + 5

_BIG_T = 3.0e38


def _em_tri_data(scene):
    """The emissive-triangle rows the light sampling reads."""
    return {"em_rows": scene["em_rows"]}


def _env_le(scene, meta, d):
    """Environment radiance for direction d: zeros, since the loader
    refuses image-based lights (ROADMAP Queue 1 item 12)."""
    return torch.zeros(d.shape[:-1] + (3,), dtype=torch.float32,
                       device=d.device)


def _area_light_Le(scene, frag, wo):
    """Emission toward wo from the hit point, one-sided (reference
    AreaLight::L: dot(ns, w) > 0). Zero for lanes that hit no emitter."""
    lid = frag["light"]
    Le = scene["lights"]["color"][torch.clamp(lid, min=0)]
    facing = vm.dot(frag["ns"], wo) > 0.0
    return torch.where(((lid >= 0) & facing)[..., None], Le, 0.0)


def make_li(meta, max_depth=None):
    """Build li(scene, meta, ray, pixel_ids, s_idx, seed) -> (R, 3)."""
    if max_depth is None:
        max_depth = int(meta.settings.get("max_ray_depth", 5))
    # integrator dims are stratified over the declared spp
    n_spp = spp_grid(int(meta.settings.get("sample_per_pixel", 1))) ** 2

    def li(scene, meta_, ray, pixel_ids, s_idx, seed):
        lights = scene["lights"]
        tri_data = _em_tri_data(scene)
        R = ray["o"].shape[0]
        frag = scn.intersect(scene, meta, ray["o"], ray["d"], ray["mint"],
                             ray["maxt"], dxd=ray.get("dxd"),
                             dyd=ray.get("dyd"))
        L = torch.where(frag["hit"][:, None],
                        _area_light_Le(scene, frag, frag["wo"]), 0.0)
        if meta.n_lights == 0:
            return L

        def bounce(state, b, trace_cont=True):
            L, throughput, frag, active = state
            p, ns, wo, eps = frag["p"], frag["ns"], frag["wo"], frag["eps"]
            u_mask = None
            if meta.has_null:
                u_mask = hash_uniform(seed, pixel_ids, s_idx, b, DIM_BSDF_COMP)
            mat = gather_material(scene, meta, frag, u_mask=u_mask)

            # pick a light by its power
            u_pick = stratified_1d(seed, pixel_ids, s_idx, n_spp, b, DIM_PICK)
            lid, pick_pdf = lt.pick_light(lights, u_pick)

            # light-sample side (NEE)
            if meta.all_delta_lights:  # no light reads the samples
                u1 = u2 = None
            else:
                u1, u2 = stratified_2d(seed, pixel_ids, s_idx, n_spp, b,
                                       DIM_LIGHT_U1, DIM_LIGHT_U2)
            ls = lt.sample_li(lights, tri_data, lid, p, eps, u1, u2)
            f_l = bx.bsdf_eval(mat, ns, wo, ls["wi"], bx.BSDF_ALL)
            consider = (active & (ls["pdf"] > 0.0)
                        & (ls["Li"] > 0.0).any(dim=-1)
                        & (f_l > 0.0).any(dim=-1))
            # dead lanes (mint = BIG_T, maxt = 0) skip the traversal
            occ, tr = scn.occluded_attenuated(
                scene, meta, p, ls["wi"],
                torch.where(consider, eps, _BIG_T),
                torch.where(consider, ls["shadow_maxt"], 0.0),
            )
            vis = consider & ~occ
            bsdf_pdf_l = bx.bsdf_pdf(mat, ns, wo, ls["wi"], bx.BSDF_ALL)
            w_l = torch.where(ls["is_delta"], 1.0,
                              power_heuristic(1.0, ls["pdf"], 1.0, bsdf_pdf_l))
            Ld = torch.where(
                vis[:, None],
                f_l * tr * ls["Li"]
                * (vm.absdot(ns, ls["wi"]) * w_l
                   / torch.clamp(ls["pdf"], min=1e-20))[:, None],
                0.0,
            )

            # BSDF-sample side: continuation ray + MIS light hit
            bu1, bu2 = stratified_2d(seed, pixel_ids, s_idx, n_spp, b,
                                     DIM_BSDF_U1, DIM_BSDF_U2)
            bcomp = stratified_1d(seed, pixel_ids, s_idx, n_spp, b,
                                  DIM_BSDF_COMP + 3)
            bs = bx.bsdf_sample(mat, ns, frag["dpdu"], wo, bu1, bu2, bcomp,
                                bx.BSDF_ALL)
            wi, f_b, pdf_b = bs["wi"], bs["f"], bs["pdf"]
            cont_ok = active & bs["valid"] & (f_b > 0.0).any(dim=-1)
            if trace_cont:
                frag2 = scn.intersect(
                    scene, meta, p, wi,
                    torch.where(cont_ok, eps, _BIG_T),
                    torch.where(cont_ok, 3.0e37, 0.0),
                )
            else:
                # last bounce with only delta lights: the continuation hit
                # cannot be emissive and the walk ends, so skip the trace
                frag2 = {k: torch.zeros_like(v) for k, v in frag.items()}
                frag2["light"] = torch.full_like(frag["light"], -1)

            cos_at_light = vm.dot(frag2["ns"], -wi)
            pdf_l_of_b = lt.pdf_li(lights, lid, p, wi, frag2["t"],
                                   cos_at_light, frag2["light"])
            f_weight = torch.where(
                bs["is_specular"] | bs["is_null"], 1.0,
                power_heuristic(1.0, pdf_b, 1.0, pdf_l_of_b),
            )
            # emission along the BSDF ray, only from the picked light
            hit_le = _area_light_Le(scene, frag2, -wi)
            hit_is_picked = frag2["hit"] & (frag2["light"] == lid)
            Ld_b = torch.where(
                (cont_ok & hit_is_picked)[:, None],
                f_b * hit_le * (vm.absdot(wi, ns) * f_weight
                                / torch.clamp(pdf_b, min=1e-20))[:, None],
                0.0,
            )
            L = L + torch.where(
                active[:, None],
                throughput * (Ld + Ld_b)
                / torch.clamp(pick_pdf, min=1e-20)[:, None],
                0.0,
            )

            # continue the walk; inactive lanes keep their old fragment
            throughput = torch.where(
                cont_ok[:, None],
                throughput * f_b * (vm.absdot(wi, ns)
                                    / torch.clamp(pdf_b, min=1e-20))[:, None],
                throughput,
            )
            active = cont_ok & frag2["hit"]
            new_frag = {
                k: torch.where(active.reshape((R,) + (1,) * (v.ndim - 1)),
                               frag2[k], v)
                for k, v in frag.items()
            }
            return L, throughput, new_frag, active

        state = (L, torch.ones((R, 3), dtype=torch.float32, device=L.device),
                 frag, frag["hit"])
        skip_last = meta.all_delta_lights and max_depth >= 2
        n_traced = max_depth - 2 if skip_last else max_depth - 1
        for b in range(n_traced):
            state = bounce(state, b)
        if skip_last:
            state = bounce(state, max_depth - 2, trace_cont=False)
        return state[0]

    return li
