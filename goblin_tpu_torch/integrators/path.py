"""Unidirectional path tracer with NEE + MIS in wavefront form (port of
goblin_tpu/integrators/path.py).

Per bounce (reference src/GoblinPathtracer.cpp:50-208): one power-CDF
light pick, one NEE shadow ray (MIS with the power heuristic; none for
delta lights), and one BSDF continuation sample whose hit doubles as the
BSDF-side light contribution. Specular lobes take full weight on the BSDF
side. No Russian roulette: max_ray_depth - 1 bounces. Inactive lanes are
masked. A shadow ray punches through mask (null-lobe) surfaces with their
attenuation. An environment map lights primary misses; a pick of the
image-based light samples the map for NEE (shadow maxt 3e37), and a BSDF
ray that escapes takes the map's radiance with MIS against the map's pdf.
When every light is a delta light and there is no environment, a BSDF ray
can never hit an emitter, so the last bounce skips its continuation trace.
A subsurface material adds its BSSRDF term once, at the camera hit, and a
volume attenuates and scatters along the camera ray up to that hit; a
scene without lights draws neither.
"""

from __future__ import annotations

import torch

from .. import telemetry
from ..core.rng import hash_uniform
from ..lights import lights as lt
from ..scene import intersect as scn
from ..shading import bsdf as bx
from . import direct
from .bssrdf import subsurface_L
from .common import DIM_BASE, spp_grid, stratified_1d, stratified_2d
from .materials import gather_material
from .volume import apply_volume

# per-bounce dimension layout (goblin_tpu's)
DIM_PICK = DIM_BASE + 0
DIM_LIGHT_U1 = DIM_BASE + 1
DIM_LIGHT_U2 = DIM_BASE + 2
DIM_BSDF_U1 = DIM_BASE + 3
DIM_BSDF_U2 = DIM_BASE + 4
DIM_BSDF_COMP = DIM_BASE + 5


def make_li(meta, max_depth=None, with_stats=False):
    """Build li(scene, meta, ray, pixel_ids, s_idx, seed) -> (R, 3).

    with_stats=True makes li return (L, (considered, traced)): int32 tensors
    of max_depth - 1 per-bounce counts on L's device, the shadow rays
    considered and the continuation rays traced (0 for a last bounce whose
    trace is skipped), goblin_tpu's census for bench.py. Off, li reads and
    launches nothing more."""
    if max_depth is None:
        max_depth = int(meta.settings.get("max_ray_depth", 5))
    # integrator dims are stratified over the declared spp
    n_spp = spp_grid(int(meta.settings.get("sample_per_pixel", 1))) ** 2

    def li(scene, meta_, ray, pixel_ids, s_idx, seed):
        lights = scene["lights"]
        R = ray["o"].shape[0]
        frag = scn.intersect(scene, meta, ray["o"], ray["d"], ray["mint"],
                             ray["maxt"], dxd=ray.get("dxd"),
                             dyd=ray.get("dyd"))
        L = torch.where(frag["hit"][:, None],
                        direct.area_light_le(scene, frag, frag["wo"]),
                        direct.env_le(scene, meta, ray["d"]))
        if meta.n_lights == 0:
            if with_stats:
                z = torch.zeros(max_depth - 1, dtype=torch.int32,
                                device=L.device)
                return L, (z, z)
            return L
        if meta.has_bssrdf:
            # subsurface transport, once at the camera hit (reference
            # src/GoblinPathtracer.cpp:68-70)
            L = L + subsurface_L(scene, meta, frag, frag["hit"], pixel_ids,
                                 s_idx, seed)

        @telemetry.spanned("pt.bounce")
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
            ls = direct.sample_light(scene, meta, lid, p, eps, u1, u2)
            Ld, consider = direct.light_side(scene, meta, mat, frag, ls,
                                             active)

            # BSDF-sample side: continuation ray + MIS light hit
            bu1, bu2 = stratified_2d(seed, pixel_ids, s_idx, n_spp, b,
                                     DIM_BSDF_U1, DIM_BSDF_U2)
            bcomp = stratified_1d(seed, pixel_ids, s_idx, n_spp, b,
                                  DIM_BSDF_COMP + 3)
            bs = bx.bsdf_sample(mat, ns, frag["dpdu"], wo, bu1, bu2, bcomp,
                                bx.BSDF_ALL)
            cont_ok = active & bs["valid"] & (bs["f"] > 0.0).any(dim=-1)
            if trace_cont:
                frag2 = scn.intersect(
                    scene, meta, p, bs["wi"],
                    torch.where(cont_ok, eps, scn.BIG_T),
                    torch.where(cont_ok, 3.0e37, 0.0),
                )
            else:
                # last bounce with only delta lights: the continuation hit
                # cannot be emissive and the walk ends, so skip the trace
                frag2 = {k: torch.zeros_like(v) for k, v in frag.items()}
                frag2["light"] = torch.full_like(frag["light"], -1)
            Ld_b = direct.bsdf_side(scene, meta, lid, frag, bs, frag2, cont_ok)
            L = direct.add_direct(L, active, throughput, Ld + Ld_b, pick_pdf)

            # continue the walk; inactive lanes keep their old fragment
            throughput = torch.where(
                cont_ok[:, None],
                direct.bsdf_throughput(throughput, bs, ns),
                throughput)
            active = cont_ok & frag2["hit"]
            new_frag = {
                k: torch.where(active.reshape((R,) + (1,) * (v.ndim - 1)),
                               frag2[k], v)
                for k, v in frag.items()
            }
            if with_stats:
                traced = cont_ok.sum() if trace_cont else consider.sum() * 0
                census.append(torch.stack([consider.sum(), traced]))
            return L, throughput, new_frag, active

        state = (L, torch.ones((R, 3), dtype=torch.float32, device=L.device),
                 frag, frag["hit"])
        census = []  # with_stats: (considered, traced) a bounce
        skip_last = meta.all_delta_lights and max_depth >= 2
        n_traced = max_depth - 2 if skip_last else max_depth - 1
        for b in range(n_traced):
            state = bounce(state, b)
        if skip_last:
            state = bounce(state, max_depth - 2, trace_cont=False)
        # the medium over the camera ray's segment, up to the camera hit
        L = apply_volume(scene, meta, ray, frag["t"], state[0], pixel_ids,
                         s_idx, seed)
        if with_stats:
            counts = (torch.stack(census, dim=1) if census else
                      torch.zeros((2, 0), dtype=torch.int64, device=L.device))
            considered, traced = counts.to(torch.int32)
            return L, (considered, traced)
        return L

    return li
