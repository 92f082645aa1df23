"""BSDF evaluation, pdf and sampling for Lambert and transparent materials
(port of the matching parts of goblin_tpu/shading/bsdf.py).

Every lane carries a material type id and its parameters; the models are
evaluated with masked selects. Branches for material kinds absent from
the scene are skipped (``_need``, goblin_tpu's static kind pruning),
which changes no value. Blinn, mirror, subsurface and mask materials are
refused by the loader.
"""

from __future__ import annotations

import functools

import torch

from ..core import vecmath as vm
from ..core.vecmath import INV_PI, TWO_PI

# BSDFType bitmask (reference src/GoblinMaterial.h:17-27)
BSDF_REFLECTION = 1 << 0
BSDF_TRANSMISSION = 1 << 1
BSDF_DIFFUSE = 1 << 2
BSDF_GLOSSY = 1 << 3
BSDF_SPECULAR = 1 << 4
BSDF_NULL = 1 << 5
BSDF_ALL = (BSDF_REFLECTION | BSDF_TRANSMISSION | BSDF_DIFFUSE | BSDF_GLOSSY
            | BSDF_SPECULAR | BSDF_NULL)

# transport mode: radiance (camera paths) or importance (light paths)
MODE_RADIANCE = 0
MODE_IMPORTANCE = 1

# material type ids (goblin_tpu's numbering)
MAT_LAMBERT = 0
MAT_TRANSPARENT = 2

# lobe bitmask of each material type id 0-5 (goblin_tpu's _LOBE_BY_TYPE:
# lambert, blinn, transparent, mirror, subsurface, and mask, whose lobe is
# its inner material's)
_LOBES = (
    BSDF_REFLECTION | BSDF_DIFFUSE,
    BSDF_REFLECTION | BSDF_GLOSSY,
    BSDF_SPECULAR | BSDF_REFLECTION | BSDF_TRANSMISSION,
    BSDF_SPECULAR | BSDF_REFLECTION,
    BSDF_SPECULAR | BSDF_REFLECTION,
    0,
)


@functools.cache
def _lobe_table(device) -> torch.Tensor:
    return torch.tensor(_LOBES, dtype=torch.int32, device=device)


def lobe_of(mtype):
    """Per-lane lobe bitmask of material type ids (clipped to 0-5)."""
    return _lobe_table(mtype.device)[torch.clamp(mtype, 0, 5).long()]


def match_type(type_mask, to_match):
    """(type & toMatch) == toMatch (reference GoblinMaterial.h:191-193)."""
    return (type_mask & to_match) == to_match


def strip_by_hemisphere(ns, wo, wi, type_mask):
    """Strip the Reflection or Transmission bit by the wo/wi hemisphere
    test (reference Material::getSampleType)."""
    same = vm.dot(ns, wo) * vm.dot(ns, wi) > 0.0
    return torch.where(same, type_mask & ~BSDF_TRANSMISSION,
                       type_mask & ~BSDF_REFLECTION)


def fresnel_dielectric(cosi, etai, etat):
    """rParl/rPerp dielectric Fresnel (src/GoblinMaterial.cpp:389-410);
    etai/etat already oriented for the side the ray arrives from."""
    cosi = torch.clamp(cosi, -1.0, 1.0)
    sint = (etai / etat) * torch.sqrt(torch.clamp(1.0 - cosi * cosi, min=0.0))
    cost = torch.sqrt(torch.clamp(1.0 - sint * sint, min=0.0))
    ci = cosi.abs()
    r_parl = (etat * ci - etai * cost) / torch.clamp(etat * ci + etai * cost,
                                                     min=1e-12)
    r_perp = (etai * ci - etat * cost) / torch.clamp(etai * ci + etat * cost,
                                                     min=1e-12)
    f = 0.5 * (r_parl * r_parl + r_perp * r_perp)
    return torch.where(sint >= 1.0, 1.0, f)


def shading_frame(ns, dpdu):
    """(tangent, bitangent) of the frame with normal ns: Gram-Schmidt on
    dpdu, or coordinate_system(ns) where dpdu is degenerate
    (Fragment::getWorldToShade)."""
    t = dpdu - vm.dotn(dpdu, ns) * ns
    bad = vm.squared_length(t) < 1e-16
    alt, _ = vm.coordinate_system(ns)
    t = torch.where(bad[..., None], alt, vm.normalize(t, eps=1e-30))
    return t, vm.cross(ns, t)


def to_world(t, b, n, w_local):
    return w_local[..., 0:1] * t + w_local[..., 1:2] * b + w_local[..., 2:3] * n


def _lambert_eval(mat, ns, wo, wi, type_mask):
    st = strip_by_hemisphere(ns, wo, wi, type_mask)
    ok = match_type(st, BSDF_REFLECTION | BSDF_DIFFUSE)
    return torch.where(ok[..., None], mat["c0"] * INV_PI, 0.0)


def _lambert_pdf(mat, ns, wo, wi, type_mask):
    ok = match_type(type_mask, BSDF_REFLECTION | BSDF_DIFFUSE)
    same = vm.dot(ns, wo) * vm.dot(ns, wi) > 0.0
    return torch.where(ok & same, vm.absdot(ns, wi) * INV_PI, 0.0)


def _need(mat, kind):
    """Is material kind present in the scene (mat["kinds"])?"""
    return kind in mat["kinds"]


def bsdf_eval(mat, ns, wo, wi, type_mask, mode=MODE_RADIANCE):
    """f(wo, wi): (R, 3). Delta lobes contribute 0 (reference behaviour).
    The transport mode changes nothing here: Lambert is symmetric."""
    f = torch.zeros_like(wo)
    if _need(mat, MAT_LAMBERT):
        f = torch.where((mat["mtype"] == MAT_LAMBERT)[..., None],
                        _lambert_eval(mat, ns, wo, wi, type_mask), f)
    return f


def bsdf_pdf(mat, ns, wo, wi, type_mask):
    pdf = torch.zeros_like(wo[..., 0])
    if _need(mat, MAT_LAMBERT):
        pdf = torch.where(mat["mtype"] == MAT_LAMBERT,
                          _lambert_pdf(mat, ns, wo, wi, type_mask), pdf)
    return pdf


def bsdf_sample(mat, ns, dpdu, wo, u1, u2, u_comp, type_mask,
                mode=MODE_RADIANCE):
    """Sample a continuation direction for every lane. In radiance mode a
    refraction scales by eta^2; in importance mode it does not.

    Returns dict: f (R, 3) (delta lobes already divided by |cos|), wi
    (R, 3), pdf (R,) (solid angle for Lambert, discrete for delta lobes),
    is_specular (R,), is_null (R,) (always False here), valid (R,).
    """
    mtype = mat["mtype"]
    t, b = shading_frame(ns, dpdu)
    n_dot_wo = vm.dot(ns, wo)
    flip = torch.where(n_dot_wo < 0.0, -1.0, 1.0)[..., None]

    # lambert: cosine hemisphere around ns, flipped to wo's side
    sin_t = torch.sqrt(torch.clamp(u1, min=0.0))
    cos_t = torch.sqrt(torch.clamp(1.0 - u1, min=0.0))
    phi = TWO_PI * u2
    wi_loc = torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi),
                          cos_t], dim=-1)
    wi_lambert = to_world(t, b, ns, wi_loc * flip)

    # dielectric specular reflect / refract
    cosi = n_dot_wo.abs()
    if _need(mat, MAT_TRANSPARENT):
        entering = n_dot_wo > 0.0
        n_or = torch.where(entering[..., None], ns, -ns)
        ei = torch.where(entering, 1.0, mat["eta"])  # incident-side IOR
        et = torch.where(entering, mat["eta"], 1.0)  # transmitted-side IOR
        F = fresnel_dielectric(cosi, ei, et)
        wi_reflect = 2.0 * cosi[..., None] * n_or - wo
        eta_ratio = ei / et
        sin2t = eta_ratio * eta_ratio * torch.clamp(1.0 - cosi * cosi, min=0.0)
        total_internal = sin2t >= 1.0
        cost = torch.sqrt(torch.clamp(1.0 - sin2t, min=0.0))
        wi_refract = vm.normalize(
            n_or * (eta_ratio * cosi - cost)[..., None]
            - eta_ratio[..., None] * wo,
            eps=1e-30,
        )
    else:
        F = torch.zeros_like(cosi)
        n_or = ns
        wi_reflect = wi_refract = wi_lambert
        eta_ratio = torch.ones_like(cosi)
        total_internal = torch.zeros_like(cosi, dtype=torch.bool)
    # radiance transport squeezes by eta^2, importance does not (Veach
    # ch. 5, reference src/GoblinMaterial.cpp:378-387)
    if mode == MODE_RADIANCE:
        eta_scale = eta_ratio * eta_ratio
    else:
        eta_scale = torch.ones_like(eta_ratio)
    refract_scale = eta_scale * (1.0 - F) / torch.clamp(
        vm.absdot(wi_refract, n_or), min=1e-12)
    reflect_scale = F / torch.clamp(cosi, min=1e-12)
    # pick reflect vs refract by Fresnel reflectance (reference
    # TransparentMaterial::sampleBSDF: reflectChance = F/cos * |wi.n| = F)
    reflect_chance = reflect_scale * vm.absdot(wi_reflect, ns)
    want_reflect = match_type(type_mask, BSDF_SPECULAR | BSDF_REFLECTION)
    want_refract = match_type(type_mask, BSDF_SPECULAR | BSDF_TRANSMISSION)
    both = want_reflect and want_refract
    if both:
        do_reflect = (u_comp < reflect_chance) | total_internal
    else:
        do_reflect = torch.full_like(total_internal, want_reflect) | total_internal
    f_transparent = torch.where(
        do_reflect[..., None],
        mat["c0"] * reflect_scale[..., None],
        mat["c1"] * refract_scale[..., None],
    )
    if both:
        pdf_transparent = torch.where(do_reflect, reflect_chance,
                                      1.0 - reflect_chance)
    else:
        pdf_transparent = torch.ones_like(cosi)
    if not want_reflect:
        pdf_transparent = torch.where(total_internal, 0.0, pdf_transparent)
    wi_transparent = torch.where(do_reflect[..., None], wi_reflect, wi_refract)

    is_lambert = mtype == MAT_LAMBERT
    is_transparent = mtype == MAT_TRANSPARENT
    wi = torch.where(is_lambert[..., None], wi_lambert, wi_transparent)
    f_l = _lambert_eval(mat, ns, wo, wi, BSDF_ALL)
    p_l = _lambert_pdf(mat, ns, wo, wi, BSDF_ALL)
    f = torch.where(is_lambert[..., None], f_l, f_transparent)
    pdf = torch.where(is_lambert, p_l, pdf_transparent)
    # the requested lobes must include the material's own
    lobe = torch.where(
        is_lambert, BSDF_REFLECTION | BSDF_DIFFUSE,
        BSDF_SPECULAR | BSDF_REFLECTION | BSDF_TRANSMISSION,
    )
    pdf = torch.where((type_mask & lobe) != 0, pdf, 0.0)
    return {
        "f": f,
        "wi": wi,
        "pdf": pdf,
        "is_specular": is_transparent,
        "is_null": torch.zeros_like(is_transparent),
        "valid": pdf > 0.0,
    }
