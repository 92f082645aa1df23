"""BSDF evaluation, pdf and sampling for Lambert, Blinn, transparent,
mirror, subsurface and mask materials (port of
goblin_tpu/shading/bsdf.py).

Every lane carries a material type id and its parameters; the models are
evaluated with masked selects. Branches for material kinds absent from
the scene are skipped (``_need``, goblin_tpu's static kind pruning),
which changes no value. A mask material arrives flattened
(integrators/materials.py): the lane holds its inner material plus
is_masked, mask_alpha, mask_u and the transparent colour in c1, and the
null lobe (wi = -wo, BSDF_NULL) is picked against alpha. A subsurface
material's surface lobe is the dielectric's specular reflection alone (its
transport under the surface is integrators/bssrdf.py's).
"""

from __future__ import annotations

import functools

import torch

from ..core import vecmath as vm
from ..core.vecmath import INV_PI, INV_TWO_PI, TWO_PI

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
MAT_BLINN = 1
MAT_TRANSPARENT = 2
MAT_MIRROR = 3
MAT_SUBSURFACE = 4
MAT_MASK = 5

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


def fresnel_conductor(cosi, eta, k):
    """Conductor Fresnel (src/GoblinMaterial.cpp:412-421)."""
    tmp = eta * eta + k * k
    c2 = cosi * cosi
    r_parl2 = (tmp * c2 - 2.0 * eta * cosi + 1.0) / (
        tmp * c2 + 2.0 * eta * cosi + 1.0)
    r_perp2 = (tmp - 2.0 * eta * cosi + c2) / (tmp + 2.0 * eta * cosi + c2)
    return 0.5 * (r_parl2 + r_perp2)


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


def _blinn_eval(mat, ns, wo, wi, type_mask):
    """Torrance-Sparrow with the Blinn distribution: D G F / (4 cos cos);
    F is the conductor's where k > 0, else the dielectric's."""
    st = strip_by_hemisphere(ns, wo, wi, type_mask)
    ok = match_type(st, BSDF_REFLECTION | BSDF_GLOSSY)
    cosi = vm.absdot(ns, wi)
    coso = vm.absdot(ns, wo)
    wh = vm.normalize(wo + wi, eps=1e-30)
    cosh = vm.absdot(ns, wh)
    e = mat["f0"]
    D = (e + 2.0) * INV_TWO_PI * torch.pow(torch.clamp(cosh, min=1e-12), e)
    wo_dot_wh = vm.absdot(wo, wh)
    safe = torch.clamp(wo_dot_wh, min=1e-12)
    G = torch.clamp(torch.minimum(2.0 * cosh * coso / safe,
                                  2.0 * cosh * cosi / safe), max=1.0)
    F = torch.where(mat["k"] > 0.0,
                    fresnel_conductor(wo_dot_wh, mat["eta"], mat["k"]),
                    fresnel_dielectric(wo_dot_wh, 1.0, mat["eta"]))
    denom = torch.clamp(4.0 * cosi * coso, min=1e-12)
    ok = ok & (cosi > 0.0) & (coso > 0.0)
    f = mat["c0"] * (D * G * F / denom)[..., None]
    return torch.where(ok[..., None], f, 0.0)


def _blinn_pdf(mat, ns, wo, wi, type_mask):
    ok = match_type(type_mask, BSDF_REFLECTION | BSDF_GLOSSY)
    same = vm.dot(ns, wo) * vm.dot(ns, wi) > 0.0
    wh = vm.normalize(wo + wi, eps=1e-30)
    cosh = vm.absdot(wh, ns)
    e = mat["f0"]
    pdf = (e + 1.0) * torch.pow(torch.clamp(cosh, min=1e-12), e) / (
        TWO_PI * 4.0 * torch.clamp(vm.dot(wo, wh), min=1e-12))
    return torch.where(ok & same, pdf, 0.0)


def _need(mat, kind):
    """Is material kind present in the scene (mat["kinds"])?"""
    return kind in mat["kinds"]


def bsdf_eval(mat, ns, wo, wi, type_mask, mode=MODE_RADIANCE):
    """f(wo, wi): (R, 3). Delta lobes contribute 0 (reference behaviour).
    The transport mode changes nothing here: both smooth lobes are
    symmetric. A masked lane scales its inner lobe by alpha."""
    f = torch.zeros_like(wo)
    if _need(mat, MAT_LAMBERT):
        f = torch.where((mat["mtype"] == MAT_LAMBERT)[..., None],
                        _lambert_eval(mat, ns, wo, wi, type_mask), f)
    if _need(mat, MAT_BLINN):
        f = torch.where((mat["mtype"] == MAT_BLINN)[..., None],
                        _blinn_eval(mat, ns, wo, wi, type_mask), f)
    if "mask_alpha" in mat:
        f = f * torch.where(mat["is_masked"], mat["mask_alpha"], 1.0)[..., None]
    return f


def bsdf_pdf(mat, ns, wo, wi, type_mask):
    pdf = torch.zeros_like(wo[..., 0])
    if _need(mat, MAT_LAMBERT):
        pdf = torch.where(mat["mtype"] == MAT_LAMBERT,
                          _lambert_pdf(mat, ns, wo, wi, type_mask), pdf)
    if _need(mat, MAT_BLINN):
        pdf = torch.where(mat["mtype"] == MAT_BLINN,
                          _blinn_pdf(mat, ns, wo, wi, type_mask), pdf)
    if "mask_alpha" in mat:
        pdf = pdf * torch.where(mat["is_masked"], mat["mask_alpha"], 1.0)
    return pdf


def bsdf_sample(mat, ns, dpdu, wo, u1, u2, u_comp, type_mask,
                mode=MODE_RADIANCE):
    """Sample a continuation direction for every lane. In radiance mode a
    refraction scales by eta^2; in importance mode it does not.

    Returns dict: f (R, 3) (delta lobes already divided by |cos|), wi
    (R, 3), pdf (R,) (solid angle for smooth lobes, discrete for delta
    lobes), is_specular (R,), is_null (R,) (the mask's punch-through lobe,
    wi = -wo), valid (R,).
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

    # blinn: sample the half vector, reflect about it
    if _need(mat, MAT_BLINN):
        e = mat["f0"]
        cos_th = torch.pow(torch.clamp(u1, min=1e-12), 1.0 / (e + 1.0))
        sin_th = torch.sqrt(torch.clamp(1.0 - cos_th * cos_th, min=0.0))
        wh_loc = torch.stack([sin_th * torch.cos(phi), sin_th * torch.sin(phi),
                              cos_th], dim=-1)
        wh = to_world(t, b, ns, wh_loc * flip)
        wi_blinn = -wo + 2.0 * vm.dotn(wo, wh) * wh
    else:
        wi_blinn = wi_lambert  # never selected

    # dielectric specular reflect / refract (transparent, and subsurface's
    # reflection)
    cosi = n_dot_wo.abs()
    if _need(mat, MAT_TRANSPARENT) or _need(mat, MAT_SUBSURFACE):
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

    # conductor mirror: F / cos, zero on the back face
    if _need(mat, MAT_MIRROR):
        F_cond = fresnel_conductor(torch.clamp(n_dot_wo, min=0.0),
                                   mat["eta"], mat["k"])
        mirror_scale = torch.where(
            n_dot_wo > 0.0, F_cond / torch.clamp(n_dot_wo, min=1e-12), 0.0)
        wi_mirror = 2.0 * vm.dotn(wo, ns) * ns - wo
    else:
        mirror_scale = torch.zeros_like(n_dot_wo)
        wi_mirror = wi_lambert

    is_lambert = mtype == MAT_LAMBERT
    is_blinn = mtype == MAT_BLINN
    is_transparent = mtype == MAT_TRANSPARENT
    is_mirror = mtype == MAT_MIRROR
    is_subsurface = mtype == MAT_SUBSURFACE
    wi = torch.where(
        is_lambert[..., None], wi_lambert,
        torch.where(is_blinn[..., None], wi_blinn,
                    torch.where(is_transparent[..., None], wi_transparent,
                                torch.where(is_subsurface[..., None],
                                            wi_reflect, wi_mirror))))
    # smooth lobes: f and pdf by evaluating the model at the sampled wi
    f_l = _lambert_eval(mat, ns, wo, wi, BSDF_ALL)
    p_l = _lambert_pdf(mat, ns, wo, wi, BSDF_ALL)
    if _need(mat, MAT_BLINN):
        f_b = _blinn_eval(mat, ns, wo, wi, BSDF_ALL)
        p_b = _blinn_pdf(mat, ns, wo, wi, BSDF_ALL)
    else:
        f_b, p_b = f_l, p_l
    # subsurface: the dielectric's specular reflection, F / cos
    f_subsurface = mat["c0"] * reflect_scale[..., None]
    f = torch.where(
        is_lambert[..., None], f_l,
        torch.where(is_blinn[..., None], f_b,
                    torch.where(is_transparent[..., None], f_transparent,
                                torch.where(is_subsurface[..., None],
                                            f_subsurface,
                                            mat["c0"] * mirror_scale[..., None]))))
    pdf = torch.where(
        is_lambert, p_l,
        torch.where(is_blinn, p_b,
                    torch.where(is_transparent, pdf_transparent, 1.0)))
    is_specular = is_transparent | is_mirror | is_subsurface
    # the requested lobes must include the material's own
    pdf = torch.where((type_mask & lobe_of(mtype)) != 0, pdf, 0.0)
    # mirror back face
    pdf = torch.where(is_mirror & (n_dot_wo <= 0.0), 0.0, pdf)

    # mask material: pick between the inner lobe and the punch-through
    is_null = torch.zeros_like(is_specular)
    if "is_masked" in mat:
        alpha = mat["mask_alpha"]
        masked = mat["is_masked"]
        want_null = match_type(type_mask, BSDF_NULL)
        want_inner = type_mask != BSDF_NULL
        # a stochastic pick only when both lobes are requested (reference
        # MaskMaterial::sampleBSDF)
        if want_inner and want_null:
            pick_inner = mat["mask_u"] < alpha
        else:
            pick_inner = torch.full_like(masked, want_inner)
        sel_null = masked & ~pick_inner
        if not want_null:
            sel_null = torch.zeros_like(masked)
        null_f = (1.0 - alpha)[..., None] * mat["c1"]
        f = torch.where(sel_null[..., None], null_f,
                        f * torch.where(masked, alpha, 1.0)[..., None])
        inner_scale = alpha if want_null and want_inner else 1.0
        pdf = torch.where(
            sel_null,
            (1.0 - alpha) if want_inner else torch.ones_like(alpha),
            pdf * torch.where(masked, inner_scale, 1.0))
        wi = torch.where(sel_null[..., None], -vm.normalize(wo, eps=1e-30), wi)
        is_null = sel_null
        is_specular = is_specular & ~sel_null
    return {
        "f": f,
        "wi": wi,
        "pdf": pdf,
        "is_specular": is_specular,
        "is_null": is_null,
        "valid": pdf > 0.0,
    }
