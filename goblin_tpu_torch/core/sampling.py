"""Sampling warps, MIS weights, the 1-D and 2-D CDF tables and the radical
inverse the integrators use (port of part of goblin_tpu/core/sampling.py).

Warps take uniform [0, 1) samples of any batch shape and return matching
outputs, with the pdfs as separate functions (reference
src/GoblinSampler.cpp).
"""

from __future__ import annotations

import math

import torch

from .vecmath import INV_PI, INV_TWO_PI, TWO_PI, sqrt0


def uniform_sample_triangle(u1, u2):
    """-> barycentric (u, v) uniformly over a triangle."""
    r = torch.sqrt(u1)
    return 1.0 - r, r * u2


def uniform_sample_cone(u1, u2, cos_theta_max):
    """Uniform direction in a z-up cone with half-angle acos(cos_theta_max)."""
    cos_t = 1.0 - u1 + u1 * cos_theta_max
    sin_t = sqrt0(1.0 - cos_t * cos_t)  # cos_t reaches 1 with a gradient
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


def uniform_sample_hemisphere(u1, u2):
    """Uniform direction on the z-up hemisphere."""
    sin_t = torch.sqrt(torch.clamp(1.0 - u1 * u1, min=0.0))
    phi = TWO_PI * u2
    return torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi), u1],
                       dim=-1)


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


def gaussian_sample_2d(u1, u2, falloff, r_max=None):
    """(x, y) with density ~ exp(-falloff r^2), truncated to r <= r_max when
    r_max is given -> (..., 2)."""
    u1 = torch.clamp(u1, min=1e-12)
    if r_max is None:
        r = torch.sqrt(torch.log(u1) / -falloff)
    else:
        r = torch.sqrt(torch.log(
            1.0 - u1 * (1.0 - torch.exp(-falloff * r_max * r_max))) / -falloff)
    theta = TWO_PI * u2
    return torch.stack([r * torch.cos(theta), r * torch.sin(theta)], dim=-1)


def gaussian_sample_2d_pdf(x, y, falloff, r_max=None):
    p = INV_PI * falloff * torch.exp(-falloff * (x * x + y * y))
    if r_max is None:
        return p
    return p / (1.0 - torch.exp(-falloff * r_max * r_max))


def exponential_sample(u, falloff):
    return -torch.log(torch.clamp(u, min=1e-12)) / falloff


def exponential_pdf(x, falloff):
    return falloff * torch.exp(-falloff * x)


def exponential_sample_range(u, sigma, a, b):
    """t in [a, b] with density ~ exp(-sigma (t - a))."""
    return a - torch.log(1.0 - u * (1.0 - torch.exp(sigma * (a - b)))) / sigma


def exponential_pdf_range(t, sigma, a, b):
    return sigma / (torch.exp(sigma * (t - a)) - torch.exp(sigma * (t - b)))


def equi_angular_sample(u, D, theta_a, theta_b):
    """Kulla-Fajardo equi-angular distance along a ray, measured from the
    point nearest the light (D away from it)."""
    return D * torch.tan((1.0 - u) * theta_a + u * theta_b)


def equi_angular_pdf(t, D, theta_a, theta_b):
    return D / ((theta_b - theta_a) * (D * D + t * t))


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


def _cdf_find(cdf, u):
    """The last index i with cdf[i] <= u, clipped to the cells: a
    right-sided search of the cells' lower edges, which gives goblin_tpu's
    count of edges <= u on a monotone table, flat runs included."""
    n = cdf.shape[-1] - 1
    idx = torch.searchsorted(cdf[:-1].contiguous(), u, right=True)
    return torch.clamp(idx - 1, 0, n - 1)


def sample_cdf_discrete(table, u):
    """Pick index i with probability f[i] / sum(f) -> (i, pdf_i)."""
    idx = _cdf_find(table["cdf"], u)
    pdf = table["func"][idx] / torch.clamp(
        table["integral"] * table["count"], min=1e-30)
    return idx, pdf


def sample_cdf_continuous(table, u):
    """Invert the piecewise-constant cdf -> (x in [0, 1), pdf, idx)."""
    cdf = table["cdf"]
    idx = _cdf_find(cdf, u)
    c0, c1 = cdf[idx], cdf[idx + 1]
    d = torch.where(c1 > c0, (u - c0) / torch.clamp(c1 - c0, min=1e-30), 0.0)
    x = (idx.to(torch.float32) + d) / table["count"]
    pdf = table["func"][idx] / torch.clamp(table["integral"], min=1e-30)
    return x, pdf, idx


def build_cdf_2d(f):
    """f (H, W) -> a conditional table along W for each row and a marginal
    one over the rows' integrals (reference CDF2D,
    src/GoblinSampler.cpp:359-405). "keys" holds every row's lower edges in
    one ascending int64 table: the row above bit 31, below it the edge's
    float32 bits (ordered as the non-negative floats they encode)."""
    f = torch.as_tensor(f, dtype=torch.float32)
    h, w = f.shape
    cond = build_cdf_1d(f)
    edges = cond["cdf"][:, :-1].contiguous().view(torch.int32).to(torch.int64)
    rows = torch.arange(h, dtype=torch.int64, device=f.device)[:, None]
    return {"cond": cond, "marg": build_cdf_1d(cond["integral"]),
            "shape": (h, w), "keys": ((rows << 31) + edges).reshape(-1)}


def sample_cdf_2d(table, u1, u2):
    """-> ((u, v) in [0, 1)^2 (..., 2), pdf with respect to the unit
    square's area): the row by u1, then the column in that row by u2 --
    goblin_tpu's search of the row's table, made as one search of all the
    rows' keys with the lane's row above bit 31, so that no lane gathers
    its row."""
    v, pdf_v, row = sample_cdf_continuous(table["marg"], u1)
    cond = table["cond"]
    w = cond["count"]
    q = (row << 31) + u2.view(torch.int32).to(torch.int64)
    col = torch.searchsorted(table["keys"], q, right=True) - row * w
    col = torch.clamp(col - 1, 0, w - 1)
    c0, c1 = cond["cdf"][row, col], cond["cdf"][row, col + 1]
    d = torch.where(c1 > c0, (u2 - c0) / torch.clamp(c1 - c0, min=1e-30), 0.0)
    uu = (col.to(torch.float32) + d) / w
    pdf_u = cond["func"][row, col] / torch.clamp(cond["integral"][row],
                                                 min=1e-30)
    return torch.stack([uu, v], dim=-1), pdf_v * pdf_u


def pdf_cdf_2d(table, u, v):
    """The pdf at (u, v) with respect to the unit square's area."""
    h, w = table["shape"]
    row = torch.clamp((v * h).to(torch.int64), 0, h - 1)
    col = torch.clamp((u * w).to(torch.int64), 0, w - 1)
    return table["cond"]["func"][row, col] / torch.clamp(
        table["marg"]["integral"], min=1e-30)


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
