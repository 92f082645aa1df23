"""The dipole diffusion BSSRDF (Jensen / Donner; port of
goblin_tpu/shading/bssrdf.py): the internal Fresnel reflectivity Fdr, the
dipole profile Rd(d^2), and the diffuse-albedo -> (sigma_a, sigma_s')
inversion, a bisection on the host at load time (reference
src/GoblinMaterial.cpp:39-219).

- A = (1 + Fdr) / (1 - Fdr)
- sigma_t' = sigma_a + sigma_s', sigma_tr = sqrt(3 sigma_a sigma_t')
- zr = 1 / sigma_t', zv = zr (1 + 4 A / 3)
- Rd = alpha' / (4 pi) [zr (1 + str dr) e^(-str dr) / dr^3
                        + zv (1 + str dv) e^(-str dv) / dv^3]
"""

from __future__ import annotations

import math

import numpy as np
import torch


def fdr(eta: float) -> float:
    """Internal diffuse Fresnel reflectivity (Donner 06 polynomial)."""
    if eta < 1.0:
        return (-0.4399 + 0.7099 / eta - 0.3319 / (eta * eta)
                + 0.0636 / (eta ** 3))
    return -1.4399 / (eta * eta) + 0.7099 / eta + 0.6681 + 0.0636 * eta


def fresnel_a(eta: float) -> float:
    f = fdr(eta)
    return (1.0 + f) / (1.0 - f)


def diffuse_reflectance(alpha_prime, A: float):
    """Total diffuse reflectance of albedo alpha' (numpy)."""
    s = np.sqrt(3.0 * (1.0 - alpha_prime))
    return (0.5 * alpha_prime * (1.0 + np.exp(-(4.0 / 3.0) * A * s))
            * np.exp(-s))


def convert_from_diffuse(kd, mean_free_path, A: float):
    """Diffuse albedo and mean free path -> (sigma_a, sigma_s') per channel,
    float32 (3,) each, by 16 bisection steps on alpha' (reference
    convertFromDiffuse)."""
    kd = np.asarray(kd, np.float64)
    sigma_tr = 1.0 / np.asarray(mean_free_path, np.float64)
    lo = np.zeros(3)
    hi = np.ones(3)
    for _ in range(16):
        mid = 0.5 * (lo + hi)
        above = diffuse_reflectance(mid, A) > kd
        hi = np.where(above, mid, hi)
        lo = np.where(above, lo, mid)
    alpha_prime = 0.5 * (lo + hi)
    sigma_t_prime = sigma_tr / np.sqrt(3.0 * (1.0 - alpha_prime))
    sigma_s_prime = alpha_prime * sigma_t_prime
    sigma_a = sigma_t_prime - sigma_s_prime
    return sigma_a.astype(np.float32), sigma_s_prime.astype(np.float32)


def rd_dipole(sigma_a, sigma_sp, A, d2):
    """The dipole profile: sigma_a, sigma_sp (..., 3), A (...,), d2 (...,)
    squared distances -> (..., 3), clamped at 0."""
    sigma_tp = torch.clamp(sigma_a + sigma_sp, min=1e-12)
    sigma_tr = torch.sqrt(3.0 * sigma_a * sigma_tp)
    zr = 1.0 / sigma_tp
    zv = zr * (1.0 + (4.0 / 3.0) * A[..., None])
    d2e = d2[..., None]
    dr = torch.sqrt(zr * zr + d2e)
    dv = torch.sqrt(zv * zv + d2e)
    alpha_p = sigma_sp / sigma_tp
    str_dr = sigma_tr * dr
    str_dv = sigma_tr * dv
    rd = (0.25 / math.pi) * alpha_p * (
        zr * (1.0 + str_dr) * torch.exp(-str_dr) / (dr * dr * dr)
        + zv * (1.0 + str_dv) * torch.exp(-str_dv) / (dv * dv * dv))
    return torch.clamp(rd, min=0.0)


def gaussian_pdf_projected(p_center, p_sample, axis, falloff, r_max):
    """The truncated-gaussian disc pdf of p_sample projected on the plane
    through p_center normal to axis (reference gaussianSample2DPdf(pCenter,
    pSample, N, falloff, Rmax))."""
    d = p_sample - p_center
    proj = d - axis * (d * axis).sum(dim=-1, keepdim=True)
    r2 = (proj * proj).sum(dim=-1)
    norm = 1.0 - torch.exp(-falloff * r_max * r_max)
    return (falloff / math.pi) * torch.exp(-falloff * r2) / torch.clamp(
        norm, min=1e-20)
