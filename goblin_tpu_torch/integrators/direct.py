"""Direct lighting at a surface vertex, shared by the path tracer, the
regenerative driver, SPPM's camera paths and Whitted's light side
(reference PathTracer NEE with MIS, src/GoblinPathtracer.cpp:95-160, and
estimateLd, GoblinRenderer.cpp:502-564).

Next-event estimation (NEE) samples the picked light and casts a shadow
ray; its multiple-importance-sampling (MIS) partner is the BSDF
continuation ray, which counts where it hits the picked light (or, with
that light the image-based one, escapes). Both sides are weighted by the
power heuristic, delta lights and specular or null lobes taking full
weight on their own side. The caller picks the light, draws the samples,
and casts the continuation ray, and chooses the variant it needs: the
image-based light in NEE or not, shadow rays that punch through mask
surfaces or plain any-hit ones, the lobes lit.

Also here: the emission a ray receives from an area light it hits or from
the environment, which every integrator reads.
"""

from __future__ import annotations

import torch

from ..core import vecmath as vm
from ..core.sampling import power_heuristic
from ..lights import envmap
from ..lights import lights as lt
from ..scene import intersect as scn
from ..shading import bsdf as bx


def em_tri_data(scene):
    """The emissive-triangle rows the light sampling reads."""
    return {"em_rows": scene["em_rows"]}


def env_le(scene, meta, d):
    """Environment radiance for direction d (zeros without an image-based
    light)."""
    if not meta.has_env:
        return torch.zeros(d.shape[:-1] + (3,), dtype=torch.float32,
                           device=d.device)
    return envmap.eval_env(scene, meta, d)


def env_le_at(scene, meta, wo):
    """The environment's radiance for emission toward wo: the map looked up
    at -wo (ImageBasedLight::eval, src/GoblinLight.cpp:600-608); None
    without an image-based light."""
    if not meta.has_env:
        return None
    return envmap.eval_env(scene, meta, -wo)


def area_light_le(scene, frag, wo):
    """Emission toward wo from the hit point, one-sided (reference
    AreaLight::L: dot(ns, w) > 0). Zero for lanes that hit no emitter."""
    lid = frag["light"]
    Le = scene["lights"]["color"][torch.clamp(lid, min=0)]
    facing = vm.dot(frag["ns"], wo) > 0.0
    return torch.where(((lid >= 0) & facing)[..., None], Le, 0.0)


def sample_light(scene, meta, lid, p, eps, u1, u2, ibl=True):
    """lt.sample_li toward the lights lid from p; with ibl and an
    image-based light in the scene, a lane that picked it samples the map
    instead (shadow maxt 3e37)."""
    lights = scene["lights"]
    ls = lt.sample_li(lights, em_tri_data(scene), lid, p, eps, u1, u2)
    if ibl and meta.has_env:
        is_ibl = lights["type"][lid] == lt.LIGHT_IBL
        env_li, env_wi, env_pdf = envmap.sample_env(scene, meta, u1, u2)
        ls["Li"] = torch.where(is_ibl[:, None], env_li, ls["Li"])
        ls["wi"] = torch.where(is_ibl[:, None], env_wi, ls["wi"])
        ls["pdf"] = torch.where(is_ibl, env_pdf, ls["pdf"])
        ls["shadow_maxt"] = torch.where(is_ibl, 3.0e37, ls["shadow_maxt"])
    return ls


def light_side(scene, meta, mat, frag, ls, active, lobes=bx.BSDF_ALL,
               through_masks=True):
    """The light sample ls's contribution at frag's points over the BSDF
    lobes, MIS-weighted against the BSDF's pdf (1 for a delta light) ->
    (Ld (R, 3), consider): the lanes that cast a shadow ray, the others
    skipping the traversal. The shadow ray punches through mask surfaces
    with their attenuation, or with through_masks=False is a plain any-hit
    query."""
    p, ns, wo, eps = frag["p"], frag["ns"], frag["wo"], frag["eps"]
    f_l = bx.bsdf_eval(mat, ns, wo, ls["wi"], lobes)
    consider = (active & (ls["pdf"] > 0.0)
                & (ls["Li"] > 0.0).any(dim=-1)
                & (f_l > 0.0).any(dim=-1))
    mint = torch.where(consider, eps, scn.BIG_T)
    maxt = torch.where(consider, ls["shadow_maxt"], 0.0)
    if through_masks:
        occ, tr = scn.occluded_attenuated(scene, meta, p, ls["wi"], mint,
                                          maxt)
    else:
        occ, tr = scn.occluded(scene, meta, p, ls["wi"], mint, maxt), None
    vis = consider & ~occ
    bsdf_pdf_l = bx.bsdf_pdf(mat, ns, wo, ls["wi"], lobes)
    w_l = torch.where(ls["is_delta"], 1.0,
                      power_heuristic(1.0, ls["pdf"], 1.0, bsdf_pdf_l))
    Ld = torch.where(
        vis[:, None],
        (f_l if tr is None else f_l * tr) * ls["Li"]
        * (vm.absdot(ns, ls["wi"]) * w_l
           / torch.clamp(ls["pdf"], min=1e-20))[:, None],
        0.0)
    return Ld, consider


def bsdf_side(scene, meta, lid, frag, bs, frag2, cont_ok, ibl=True):
    """The BSDF sample bs's MIS term at frag's points: the emission of the
    picked light lid where the continuation ray (hit frag2) meets it,
    weighted against lt.pdf_li (1 for a specular or null lobe); with ibl
    and an image-based light picked, an escaped ray's map radiance,
    weighted against the map's pdf -> (R, 3)."""
    lights = scene["lights"]
    p, ns = frag["p"], frag["ns"]
    wi, f_b, pdf_b = bs["wi"], bs["f"], bs["pdf"]
    pdf_l_of_b = lt.pdf_li(lights, lid, p, wi, frag2["t"],
                           vm.dot(frag2["ns"], -wi), frag2["light"])
    f_weight = torch.where(bs["is_specular"] | bs["is_null"], 1.0,
                           power_heuristic(1.0, pdf_b, 1.0, pdf_l_of_b))
    hit_le = area_light_le(scene, frag2, -wi)
    hit_is_picked = frag2["hit"] & (frag2["light"] == lid)
    Ld_b = torch.where(
        (cont_ok & hit_is_picked)[:, None],
        f_b * hit_le * (vm.absdot(wi, ns) * f_weight
                        / torch.clamp(pdf_b, min=1e-20))[:, None],
        0.0)
    if ibl and meta.has_env:
        env_w = torch.where(
            bs["is_specular"] | bs["is_null"], 1.0,
            power_heuristic(1.0, pdf_b, 1.0, envmap.pdf_env(scene, meta, wi)))
        is_ibl = lights["type"][lid] == lt.LIGHT_IBL
        Ld_b = Ld_b + torch.where(
            (cont_ok & ~frag2["hit"] & is_ibl)[:, None],
            f_b * env_le(scene, meta, wi)
            * (vm.absdot(wi, ns) * env_w
               / torch.clamp(pdf_b, min=1e-20))[:, None],
            0.0)
    return Ld_b


def add_direct(L, active, tp, Ld, pick_pdf):
    """L plus the direct light Ld (both sides) of the active lanes, through
    their throughput tp and over the light pick's pdf."""
    return L + torch.where(
        active[:, None],
        tp * Ld / torch.clamp(pick_pdf, min=1e-20)[:, None],
        0.0)


def bsdf_throughput(tp, bs, ns):
    """The throughput tp carried along the BSDF sample bs: tp f |cos| / pdf."""
    return tp * bs["f"] * (vm.absdot(bs["wi"], ns)
                           / torch.clamp(bs["pdf"], min=1e-20))[:, None]
