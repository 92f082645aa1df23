"""Image-based (environment) light: a lat-long map's radiance, importance
sampling and pdf (port of goblin_tpu/lights/envmap.py).

Semantics of the reference ImageBasedLight (src/GoblinLight.cpp:464-629):
- the map's frame is the user's quaternion times rotY(-pi/2) rotX(-pi/2),
  so that the z-up spherical parameterization faces the map's centre;
- Le(dir): the local direction -> (theta, phi) -> (s, t) = (phi / 2 pi,
  theta / pi), looked up bilinearly, wrapping in s and clamped in t;
- importance sampling from a luminance x sin(theta) CDF2D built on a level
  at most 256 texels wide (the reference's mip level maxLevel - 8);
- the solid-angle pdf is pdf_st / (2 pi^2 sin(theta)).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core import sampling as sp
from ..core import vecmath as vm


def _quat_mul_np(a, b):
    """Hamilton product of two wxyz quaternions, in float64."""
    w1, x1, y1, z1 = a
    w2, x2, y2, z2 = b
    return np.array([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], dtype=np.float64)


def env_frame(orientation) -> np.ndarray:
    """The map's local -> world rotation (3, 3) float32: rotX(-pi/2), then
    rotY(-pi/2), then the user's quaternion, composed in float64."""
    qx = np.array([np.cos(-np.pi / 4), np.sin(-np.pi / 4), 0.0, 0.0])
    qy = np.array([np.cos(-np.pi / 4), 0.0, np.sin(-np.pi / 4), 0.0])
    q = _quat_mul_np(np.asarray(orientation, np.float64), _quat_mul_np(qy, qx))
    return vm.quat_to_matrix_np(q)


def env_luminance(img) -> np.ndarray:
    """Rec. 709 luminance of an (..., 3) image."""
    return (0.212671 * img[..., 0] + 0.715160 * img[..., 1]
            + 0.072169 * img[..., 2])


def bake_env(image, filter_color, orientation, device,
             dist_max_width: int = 256) -> dict:
    """-> the scene's env table on device: the filtered image, the frame,
    the CDF2D of luminance x sin(theta) on the ceil(w / dist_max_width)-
    downsampled level, and the mean radiance."""
    img = np.asarray(image, np.float32) * np.asarray(filter_color, np.float32)
    h, w = img.shape[:2]
    ds = max(1, int(np.ceil(w / dist_max_width)))
    dw, dh = max(1, w // ds), max(1, h // ds)
    small = img[:dh * ds, :dw * ds].reshape(dh, ds, dw, ds, 3).mean(axis=(1, 3))
    sin_t = np.sin((np.arange(dh) + 0.5) / dh * np.pi)
    dist = (env_luminance(small) * sin_t[:, None]).astype(np.float32)
    return {
        "img": torch.as_tensor(img, device=device),
        "rot": torch.as_tensor(env_frame(orientation), device=device),
        "cdf": sp.build_cdf_2d(torch.as_tensor(np.maximum(dist, 0.0),
                                               device=device)),
        "mean": torch.as_tensor(img.reshape(-1, 3).mean(axis=0), device=device),
    }


def _lookup(env, s, t):
    """Bilinear lat-long lookup at (s, t) in [0, 1)^2: x wraps (floored
    modulo), y clamps."""
    img = env["img"]
    h, w = img.shape[:2]
    fx = s * w - 0.5
    fy = t * h - 0.5
    x0f = torch.floor(fx)
    y0f = torch.floor(fy)
    tx = fx - x0f
    ty = fy - y0f
    x0 = x0f.to(torch.int64)
    y0 = y0f.to(torch.int64)
    out = 0.0
    for dy in (0, 1):
        for dx in (0, 1):
            xi = torch.remainder(x0 + dx, w)
            yi = torch.clamp(y0 + dy, 0, h - 1)
            wgt = (tx if dx else 1 - tx) * (ty if dy else 1 - ty)
            out = out + wgt[..., None] * img[yi, xi]
    return out


def _to_st(env, d_world):
    """World directions -> (s, t, sin(theta)) in the map's frame."""
    w_local = vm.mat3_apply_t(env["rot"], d_world)  # R^T: world -> local
    theta = vm.spherical_theta(w_local)
    phi = vm.spherical_phi(w_local)
    return phi * (0.5 / math.pi), theta * (1.0 / math.pi), torch.sin(theta)


def eval_env(scene, meta, d_world):
    """The environment's radiance for unit world directions (..., 3)."""
    env = scene["env"]
    s, t, _ = _to_st(env, d_world)
    return _lookup(env, s, t)


def sample_env(scene, meta, u1, u2):
    """Importance-sample the map -> (Li, wi_world, pdf_w)."""
    env = scene["env"]
    st, pdf_st = sp.sample_cdf_2d(env["cdf"], u1, u2)
    theta = st[..., 1] * math.pi
    phi = st[..., 0] * (2.0 * math.pi)
    sin_t = torch.sin(theta)
    w_local = torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi),
                           torch.cos(theta)], dim=-1)
    wi = vm.mat3_apply(env["rot"], w_local)
    pdf = pdf_st / torch.clamp(2.0 * math.pi * math.pi * sin_t, min=1e-12)
    return _lookup(env, st[..., 0], st[..., 1]), wi, pdf


def pdf_env(scene, meta, wi_world):
    """The solid-angle pdf that sample_env gives direction wi."""
    env = scene["env"]
    s, t, sin_t = _to_st(env, wi_world)
    pdf_st = sp.pdf_cdf_2d(env["cdf"], s, t)
    return torch.where(
        sin_t <= 0.0, 0.0,
        pdf_st / torch.clamp(2.0 * math.pi * math.pi * sin_t, min=1e-12))
