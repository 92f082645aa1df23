"""Sampling warps, MIS weights and the radical inverse the path tracer and
SPPM use (port of part of goblin_tpu/core/sampling.py).

Warps take uniform [0, 1) samples of any batch shape and return matching
outputs, with the pdfs as separate functions (reference
src/GoblinSampler.cpp).
"""

from __future__ import annotations

import math

import torch

from .vecmath import INV_PI, INV_TWO_PI, TWO_PI


def uniform_sample_triangle(u1, u2):
    """-> barycentric (u, v) uniformly over a triangle."""
    r = torch.sqrt(u1)
    return 1.0 - r, r * u2


def uniform_sample_cone(u1, u2, cos_theta_max):
    """Uniform direction in a z-up cone with half-angle acos(cos_theta_max)."""
    cos_t = 1.0 - u1 + u1 * cos_theta_max
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    phi = TWO_PI * u2
    return torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_t],
                       dim=-1)


def uniform_cone_pdf(cos_theta_max):
    return 1.0 / (TWO_PI * (1.0 - cos_theta_max))


def uniform_sample_sphere(u1, u2):
    z = 1.0 - 2.0 * u1
    sin_t = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = TWO_PI * u2
    return torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi), z],
                       dim=-1)


def uniform_sphere_pdf():
    return 0.5 * INV_TWO_PI


def cosine_sample_hemisphere(u1, u2):
    sin_t = torch.sqrt(u1)
    cos_t = torch.sqrt(torch.clamp(1.0 - u1, min=0.0))
    phi = TWO_PI * u2
    return torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_t],
                       dim=-1)


def cosine_hemisphere_pdf(cos_theta):
    return cos_theta * INV_PI


def uniform_sample_disk(u1, u2):
    """Shirley-Chiu concentric square -> disk map -> (..., 2), branchless
    as goblin_tpu writes it (reference src/GoblinSampler.cpp:561-601)."""
    x = 2.0 * u1 - 1.0
    y = 2.0 * u2 - 1.0
    quarter_pi = 0.25 * math.pi
    safe_x = torch.where(x == 0.0, 1.0, x)
    safe_y = torch.where(y == 0.0, 1.0, y)
    upper = x + y > 0.0
    right = upper & (x > y)  # r = x
    up = upper & ~(x > y)  # r = y
    left = ~upper & (x < y)  # r = -x
    r = torch.where(right, x, torch.where(up, y, torch.where(left, -x, -y)))
    theta = torch.where(
        right, quarter_pi * (y / safe_x),
        torch.where(
            up, quarter_pi * (2.0 - x / safe_y),
            torch.where(
                left, quarter_pi * (4.0 + y / safe_x),
                torch.where(y != 0.0, quarter_pi * (6.0 - x / safe_y), 0.0),
            ),
        ),
    )
    return torch.stack([r * torch.cos(theta), r * torch.sin(theta)], dim=-1)


def power_heuristic(n_a, pdf_a, n_b, pdf_b):
    """Veach power heuristic (beta=2) MIS weight for strategy A."""
    a = n_a * pdf_a
    b = n_b * pdf_b
    return a * a / torch.clamp(a * a + b * b, min=1e-30)


def build_cdf_1d(f):
    """f: (..., N) nonnegative -> dict with the normalised cdf for inversion
    sampling (reference CDF1D, src/GoblinSampler.cpp:309-356): dx = 1 / N,
    cdf[i] = prefix sum / integral, with a leading 0."""
    f = torch.as_tensor(f, dtype=torch.float32)
    n = f.shape[-1]
    dx = 1.0 / n
    integral = f.sum(dim=-1, keepdim=True) * dx
    safe_int = torch.where(integral > 0.0, integral, 1.0)
    cdf = torch.cumsum(f, dim=-1) * dx / safe_int
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)
    return {"func": f, "cdf": cdf, "integral": integral[..., 0], "count": n}


def fma_f32(a, b, c):
    """a * b + c for float32 tensors, rounded once to float32 (a fused
    multiply-add). The product of two float32 values is exact in float64;
    the float64 sum is made round-to-odd (TwoSum gives its error), so its
    rounding to float32 is the correctly rounded one."""
    p = a.to(torch.float64) * b.to(torch.float64)
    c = c.to(torch.float64)
    s = p + c
    bv = s - p
    err = (p - (s - bv)) + (c - bv)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, math.inf, -math.inf).to(torch.float64)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.to(torch.float32)


def radical_inverse(n, base, n_digits: int = 32):
    """Van der Corput radical inverse of the integer n (taken as uint32) in
    `base`; n and base are ints or broadcastable integer tensors. float32
    and bit-equal to goblin_tpu's: the digits stay integers (int64 here),
    and inv and val accumulate in float32 in the same order. 1 / base is
    the double rounded once to float32, as JAX rounds the Python float
    1.0 / base that it multiplies by; and XLA contracts val + d * inv into
    a fused multiply-add, so the port rounds that sum once as well."""
    n = torch.as_tensor(n, dtype=torch.int64) & 0xFFFFFFFF
    base = torch.as_tensor(base, dtype=torch.int64, device=n.device)
    n, base = torch.broadcast_tensors(n, base)
    inv_base = (1.0 / base.to(torch.float64)).to(torch.float32)
    inv = inv_base
    val = torch.zeros_like(inv_base)
    for _ in range(n_digits):
        val = fma_f32((n % base).to(torch.float32), inv, val)
        inv = inv * inv_base
        n = n // base
    return val
