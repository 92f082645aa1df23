"""Subsurface scattering in wavefront form: single scatter plus dipole
diffusion (port of goblin_tpu/integrators/bssrdf.py; reference
Renderer::Lsubsurface, src/GoblinRenderer.cpp:128-294).

- Single scatter: refract wo into the medium, sample a depth with
  exponential falloff, connect that interior point to a light through the
  surface (the closest hit towards the light must be the same material),
  attenuated along both segments.
- Multiple scatter: sample a gaussian disc about the hit along one of the
  shading axes (N : U : V picked 2 : 1 : 1), probe for a surface point of
  the same material, evaluate the dipole Rd against the irradiance there,
  and weight the three axis strategies by the power heuristic
  (BSSRDF::MISWeight, src/GoblinMaterial.cpp:84-127).

Each sample makes four trace calls: the exit's closest hit, its shadow
ray, the probe's closest hit and the probe's shadow ray. Lanes whose
material is not subsurface trace dead rays (mint = BIG_T, maxt = 0). The
shadow rays take the plain occluded(), which counts a mask surface as
opaque, and the probe's light sample reuses the exit's u[2], u[3], as
goblin_tpu's do.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..camera.film import luminance
from ..core import vecmath as vm
from ..core.rng import hash_uniform
from ..core.sampling import (exponential_pdf, exponential_sample,
                             gaussian_sample_2d, gaussian_sample_2d_pdf)
from ..lights import lights as lt
from ..scene import intersect as scn
from ..shading.bsdf import MAT_SUBSURFACE, fresnel_dielectric
from ..shading.bssrdf import gaussian_pdf_projected, rd_dipole
from .common import DIM_BASE
from .materials import COL_ETA, COL_TYPE

DIM_SS = DIM_BASE + 64  # the BSSRDF's dimensions: 16 a sample, 8 used
KEY_SS = 0x5542  # bounce key of sample i at bounce b: KEY_SS + 131 b + i
# the disc is cut where pdf(Rmax) / pdf(0) = 0.01 (reference skipRatio):
# log(0.01) in float32, as goblin_tpu takes it
LOG_SKIP = float(np.log(np.float32(0.01)))


def _refract_in(wo, n, eta_mat):
    """wo refracted through n into the medium (etai = 1, etat = eta;
    reference specularRefract, src/GoblinMaterial.cpp:418-433)."""
    eta = 1.0 / eta_mat
    cosi = vm.absdot(n, wo)
    cost = torch.sqrt(torch.clamp(1.0 - eta * eta * (1.0 - cosi * cosi),
                                  min=0.0))
    return vm.normalize(n * (eta * cosi - cost)[..., None]
                        - eta[..., None] * wo, eps=1e-30)


def subsurface_L(scene, meta, frag, active, pixel_ids, s_idx, seed, bounce=0):
    """Radiance that subsurface transport adds at the fragment -> (R, 3);
    zero on lanes whose material is not subsurface."""
    lights = scene["lights"]
    tri_data = {"em_rows": scene["em_rows"]}
    mid = frag["mat"]
    rows = scene["mat_rows"][mid]
    is_ss = (rows[:, COL_TYPE] == MAT_SUBSURFACE) & active & frag["hit"]
    p, ns, wo = frag["p"], frag["ns"], frag["wo"]
    eta = rows[:, COL_ETA]
    sigma_a = scene["mat_sigma_a"][mid]
    sigma_sp = scene["mat_sigma_sp"][mid]
    g = scene["mat_ss_g"][mid]
    A = scene["mat_ss_A"][mid]
    # getScatter = sigma_s' / (1 - g); sigma_t = scatter + sigma_a
    scatter = sigma_sp / torch.clamp(1.0 - g, min=1e-6)[..., None]
    sigma_t = scatter + sigma_a
    falloff = torch.clamp(luminance(sigma_t), min=1e-6)
    Ft_o = 1.0 - fresnel_dielectric(vm.absdot(wo, ns), 1.0, eta)
    wo_refr = _refract_in(wo, ns, eta)

    # the shading frame of the probe axes
    t_ = vm.normalize(frag["dpdu"] - vm.dot(frag["dpdu"], ns)[..., None] * ns,
                      eps=1e-30)
    b_ = vm.cross(ns, t_)

    sigma_tr = torch.clamp(
        luminance(torch.sqrt(3.0 * sigma_a * (sigma_a + sigma_sp))), min=1e-6)
    r_max = torch.sqrt(LOG_SKIP / -sigma_tr)

    n_samples = int(meta.settings.get("bssrdf_sample_num", 4))
    big = scn.BIG_T
    L_single = torch.zeros_like(p)
    L_multi = torch.zeros_like(p)
    for i in range(n_samples):
        u = [hash_uniform(seed, pixel_ids, s_idx, KEY_SS + 131 * bounce + i,
                          DIM_SS + 16 * i + k) for k in range(8)]

        # single scatter
        d_s = exponential_sample(u[0], falloff)
        p_samp = p + d_s[..., None] * wo_refr
        samp_pdf = exponential_pdf(d_s, falloff)
        lid, pick_pdf = lt.pick_light(lights, u[1])
        ls = lt.sample_li(lights, tri_data, lid, p_samp, 1e-5, u[2], u[3])
        cand = is_ss & (ls["pdf"] > 0.0) & (ls["Li"] > 0.0).any(dim=-1)
        # the closest hit from the interior point towards the light: the exit
        exit_frag = scn.intersect(scene, meta, p_samp, ls["wi"],
                                  torch.where(cand, 1e-5, big),
                                  torch.where(cand, ls["shadow_maxt"], 0.0))
        same_mat = exit_frag["hit"] & (exit_frag["mat"] == mid)
        through = cand & same_mat
        occ = scn.occluded(scene, meta, p_samp, ls["wi"],
                           torch.where(through,
                                       exit_frag["t"] + exit_frag["eps"], big),
                           torch.where(through, ls["shadow_maxt"], 0.0))
        ok = through & ~occ
        ni = exit_frag["ns"]
        wi = ls["wi"]
        cosi = vm.absdot(ni, wi)
        Ft_i = 1.0 - fresnel_dielectric(cosi, 1.0, eta)
        phase = _phase_hg(wi, wo_refr, g)
        G = vm.absdot(ni, wo_refr) / torch.clamp(cosi, min=1e-6)
        sigma_tc = sigma_t + G[..., None] * sigma_t
        di = torch.sqrt(vm.squared_length(exit_frag["p"] - p_samp))
        et = 1.0 / eta
        di_prime = di * cosi / torch.sqrt(torch.clamp(
            1.0 - et * et * (1.0 - cosi * cosi), min=1e-6))
        contrib = (
            (Ft_o * Ft_i * phase)[..., None] * scatter / sigma_tc
            * torch.exp(-di_prime[..., None] * sigma_t)
            * torch.exp(-d_s[..., None] * sigma_t)
            * ls["Li"]
            / torch.clamp(ls["pdf"] * pick_pdf * samp_pdf,
                          min=1e-20)[..., None])
        L_single = L_single + torch.where(ok[..., None], contrib, 0.0)

        # dipole diffusion
        dxy = gaussian_sample_2d(u[4], u[5], sigma_tr, r_max)
        dx, dy = dxy[..., 0], dxy[..., 1]
        half = torch.sqrt(torch.clamp(r_max * r_max - (dx * dx + dy * dy),
                                      min=0.0))
        # the axis, picked 2 : 1 : 1 (N : U : V)
        pick_n = u[6] <= 0.5
        pick_u = (u[6] > 0.5) & (u[6] <= 0.75)
        axis_pdf = torch.where(pick_n, 0.5, 0.25)
        dx3, dy3, half3 = dx[..., None], dy[..., None], half[..., None]
        off = torch.where(
            pick_n[..., None], dx3 * t_ + dy3 * b_ - half3 * ns,
            torch.where(pick_u[..., None], dx3 * b_ + dy3 * ns - half3 * t_,
                        dy3 * ns + dx3 * t_ - half3 * b_))
        probe_d = torch.where(pick_n[..., None], ns,
                              torch.where(pick_u[..., None], t_, b_))
        disc_pdf = axis_pdf * gaussian_sample_2d_pdf(dx, dy, sigma_tr, r_max)
        probe = scn.intersect(scene, meta, p + off, probe_d,
                              torch.where(is_ss, 0.0, big),
                              torch.where(is_ss, 2.0 * half, 0.0))
        pp = probe["p"]
        rd = rd_dipole(sigma_a, sigma_sp, A, vm.squared_length(pp - p))
        lid2, pick_pdf2 = lt.pick_light(lights, u[7])
        ls2 = lt.sample_li(lights, tri_data, lid2, pp, probe["eps"], u[2],
                           u[3])
        cand2 = (probe["hit"] & (probe["mat"] == mid) & (ls2["pdf"] > 0.0)
                 & (ls2["Li"] > 0.0).any(dim=-1))
        occ2 = scn.occluded(scene, meta, pp, ls2["wi"],
                            torch.where(cand2, probe["eps"], big),
                            torch.where(cand2, ls2["shadow_maxt"], 0.0))
        ni2 = probe["ns"]
        cosi2 = vm.absdot(ni2, ls2["wi"])
        irradiance = ls2["Li"] * (
            cosi2 / torch.clamp(ls2["pdf"] * pick_pdf2, min=1e-20))[..., None]
        Ft_i2 = 1.0 - fresnel_dielectric(cosi2, 1.0, eta)
        pdf_probe = disc_pdf * vm.absdot(probe_d, ni2)
        w = _axis_mis(p, pp, ni2, ns, t_, b_, pick_n, pick_u, pdf_probe,
                      sigma_tr, r_max)
        contrib2 = ((w / math.pi * Ft_o * Ft_i2)[..., None] * rd * irradiance
                    / torch.clamp(pdf_probe, min=1e-20)[..., None])
        L_multi = L_multi + torch.where((cand2 & ~occ2)[..., None], contrib2,
                                        0.0)

    return torch.where(is_ss[..., None],
                       (L_single + L_multi) * (1.0 / float(n_samples)), 0.0)


def _phase_hg(wi, wo, g):
    """Henyey-Greenstein with a per-lane g (the sign convention of
    volume.phase_hg and the reference's phaseHG)."""
    denom = 1.0 + g * g - 2.0 * g * vm.dot(wi, wo)
    return (1.0 - g * g) / torch.clamp(
        4.0 * math.pi * denom * torch.sqrt(torch.clamp(denom, min=1e-12)),
        min=1e-12)


def _axis_mis(pwo, pwi, ni, n, t_, b_, pick_n, pick_u, pdf, sigma_tr, r_max):
    """Power-heuristic weight over the N / U / V probe axes with the
    4 : 1 : 1 weighting of the 2 : 1 : 1 pick (BSSRDF::MISWeight)."""

    def axis_pdf(ax, frac):
        return frac * gaussian_pdf_projected(pwo, pwi, ax, sigma_tr,
                                             r_max) * vm.absdot(ax, ni)

    pdf_n = axis_pdf(n, 0.5)
    pdf_u = axis_pdf(t_, 0.25)
    pdf_v = axis_pdf(b_, 0.25)
    p2 = pdf * pdf
    w_n = 4.0 * p2 / torch.clamp(4.0 * p2 + pdf_u * pdf_u + pdf_v * pdf_v,
                                 min=1e-20)
    w_u = p2 / torch.clamp(4.0 * pdf_n * pdf_n + p2 + pdf_v * pdf_v, min=1e-20)
    w_v = p2 / torch.clamp(4.0 * pdf_n * pdf_n + pdf_u * pdf_u + p2, min=1e-20)
    return torch.where(pick_n, w_n, torch.where(pick_u, w_u, w_v))
