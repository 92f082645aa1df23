"""The reference path tracer and the film's filter splat at chosen pixels.

The estimator is the program's, written out plainly for the scenes that
scene.py reads: one stratified camera sample a pixel a pass, and at each
of max_ray_depth - 1 vertices one light picked by power, a shadow ray to
it (every light is a delta light, so no multiple importance sampling) and
one BSDF sample for the next vertex. Every random number is a pure
function of (seed, pixel, sample, bounce, dimension), by the same 32-bit
hash and dimension layout as the program, so that both draw the same
samples. dtype is the precision of the arithmetic: float32 is the
configuration's, a lower one makes the benchmark's control.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import accel
from .scene import LAMBERT, TRANSPARENT

M32 = 0xFFFFFFFF
BOUNCE_CAMERA = 0x7FFF
DIM_PICK, DIM_BSDF_U1, DIM_BSDF_U2, DIM_BSDF_COMP = 4, 7, 8, 12
BIG_T = 3.0e38
HIT_EPS = 1e-3
CAMERA_MINT = 1e-3


# --- sample streams --------------------------------------------------------

def _mul(a, k):
    """(a * k) mod 2**32 for a < 2**32, by 16-bit halves of k."""
    return (a * (k & 0xFFFF) + (((a * (k >> 16)) & 0xFFFF) << 16)) & M32


def _mix(a, b):
    h = (_mul(a, 0x9E3779B1) + b) & M32
    h = h ^ (h >> 15)
    h = _mul(h, 0x85EBCA77)
    h = h ^ (h >> 13)
    h = _mul(h, 0xC2B2AE3D)
    return h ^ (h >> 16)


def uniform(seed, pixel, sample, bounce, dim):
    """[0, 1) float32 from int64 tensors pixel, sample (or ints)."""
    h = _mix((int(seed) + 0x1234567) & M32, pixel & M32)
    h = _mix(h, sample & M32 if torch.is_tensor(sample) else sample & M32)
    h = _mix(h, (_mul(bounce & M32, 0x01000193) + dim) & M32)
    return (h >> 8).to(torch.float32) * (1.0 / (1 << 24))


def strat1(seed, pix, s, n, bounce, dim):
    off = torch.floor(uniform(seed, pix, 0x57A7, bounce, dim) * n).long()
    cell = (s + off) % n
    return (cell.float() + uniform(seed, pix, s, bounce, dim)) / n


def strat2(seed, pix, s, n, bounce, da, db):
    g = int(math.isqrt(n))
    off = torch.floor(uniform(seed, pix, 0x57A8, bounce, da) * n).long()
    cell = (s + off) % n
    u1 = ((cell % g).float() + uniform(seed, pix, s, bounce, da)) / g
    u2 = ((cell // g).float() + uniform(seed, pix, s, bounce, db)) / g
    return u1, u2


# --- vectors ---------------------------------------------------------------

def dot(a, b):
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])


def cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def unit(a):
    """a / |a|, and 0 for a zero vector."""
    sq = dot(a, a)[..., None]
    return a * torch.where(sq > 1e-30,
                           1.0 / torch.sqrt(torch.clamp(sq, min=1e-30)), 0.0)


def sqrt0(x):
    return torch.sqrt(torch.clamp(x, min=0.0))


def frame(n):
    """A unit vector orthogonal to unit n: the first axis of the frame
    that n x it completes."""
    x, y, z = n[..., 0], n[..., 1], n[..., 2]
    zero = torch.zeros_like(x)
    ia = 1.0 / torch.sqrt(torch.clamp(x * x + z * z, min=1e-30))
    ib = 1.0 / torch.sqrt(torch.clamp(y * y + z * z, min=1e-30))
    a2 = torch.where((x.abs() > y.abs())[..., None],
                     torch.stack([-z * ia, zero, x * ia], -1),
                     torch.stack([zero, -z * ib, y * ib], -1))
    return a2


# --- the renderer ----------------------------------------------------------

class Renderer:
    """The scene's tables on device, in dtype, and the path tracer."""

    def __init__(self, scene, device, dtype=torch.float32):
        self.scene, self.dev, self.dt = scene, torch.device(device), dtype
        self.clusters = accel.Clusters(scene, device, dtype)

        def t(a, dt=dtype):
            return torch.as_tensor(np.asarray(a), device=device).to(dt)

        self.v0, self.e1, self.e2 = t(scene.v0), t(scene.e1), t(scene.e2)
        self.normals, self.uvs = t(scene.normals), t(scene.uvs)
        self.mat = t(scene.mat, torch.int64)
        mats = scene.materials
        self.is_lambert = t([m["kind"] == LAMBERT for m in mats], torch.bool)
        self.is_glass = t([m["kind"] == TRANSPARENT for m in mats],
                          torch.bool)
        self.c0 = t([m["c0"] for m in mats])
        self.c1 = t([m["c1"] for m in mats])
        self.eta = t([m["eta"] for m in mats])
        ls = scene.lights
        self.l_pos = t([li["position"] for li in ls])
        self.l_col = t([li["color"] for li in ls])
        self.l_dir = t([li["direction"] for li in ls])
        self.l_spot = t([li["kind"] == "spot" for li in ls], torch.bool)
        self.l_cmax = t(np.float32([li["cos_max"] for li in ls]))
        self.l_cstart = t(np.float32([li["cos_start"] for li in ls]))
        power = []
        for li in ls:
            c = li["color"]
            lum = 0.212671 * c[0] + 0.715160 * c[1] + 0.072169 * c[2]
            power.append(lum * 4.0 * np.pi if li["kind"] == "point" else
                         lum * 2.0 * np.pi
                         * (1.0 - 0.5 * (li["cos_max"] + li["cos_start"])))
        power = np.float32(power)
        self.l_cdf = torch.as_tensor(np.cumsum(power) / power.sum(),
                                     device=device)
        self.l_pick = torch.as_tensor(power / power.sum(), device=device)
        cam = scene.camera
        self.cam_pos = t(cam.position)
        self.cam_rot = t(cam.rot)

    # -- geometry

    def intersect(self, o, d, mint, maxt):
        """Closest hit -> fragment dict (hit, t, p, ns, dpdu, eps, mat)."""
        hit, tri = self.clusters.closest(o, d, mint, maxt)
        k = torch.clamp(tri, min=0)
        v0, e1, e2 = self.v0[k], self.e1[k], self.e2[k]
        pv = cross(d, e2)
        det = dot(e1, pv)
        inv = 1.0 / torch.where(det.abs() < 1e-20, 1.0, det)
        tv = o - v0
        b1 = dot(tv, pv) * inv
        qv = cross(tv, e1)
        b2 = dot(d, qv) * inv
        t = torch.where(hit & (det.abs() >= 1e-20), dot(e2, qv) * inv, BIG_T)
        hit = hit & (det.abs() >= 1e-20)
        p = o + torch.where(hit, t, 1.0)[..., None] * d
        b0 = 1.0 - b1 - b2
        n = self.normals[k]
        ns = unit(b0[..., None] * n[:, 0] + b1[..., None] * n[:, 1]
                  + b2[..., None] * n[:, 2])
        uv = self.uvs[k]
        du1, dv1 = uv[:, 1, 0] - uv[:, 0, 0], uv[:, 1, 1] - uv[:, 0, 1]
        du2, dv2 = uv[:, 2, 0] - uv[:, 0, 0], uv[:, 2, 1] - uv[:, 0, 1]
        det_uv = du1 * dv2 - dv1 * du2
        flat = det_uv.abs() < 1e-20
        dpdu = (1.0 / torch.where(flat, 1.0, det_uv))[..., None] * (
            dv2[..., None] * e1 - dv1[..., None] * e2)
        dpdu = torch.where(flat[..., None], frame(ns), dpdu)
        return {"hit": hit, "t": t, "p": p, "ns": ns, "dpdu": dpdu,
                "eps": HIT_EPS * torch.where(hit, t, 1.0),
                "mat": torch.where(hit, self.mat[k], 0)}

    # -- the estimator

    def camera_rays(self, seed, pix, s, n_grid):
        """Pinhole rays of sample s (int64 a lane) of pixels pix, and the
        film jitters (jx, jy) in [0, 1)."""
        cam = self.scene.camera
        jx = ((s % n_grid).float()
              + uniform(seed, pix, s, BOUNCE_CAMERA, 0)) / n_grid
        jy = ((s // n_grid).float()
              + uniform(seed, pix, s, BOUNCE_CAMERA, 1)) / n_grid
        x = (pix % cam.x_res).float() + jx
        y = (pix // cam.x_res).float() + jy
        xn = 2.0 * x * (1.0 / cam.x_res) - 1.0
        yn = -2.0 * y * (1.0 / cam.y_res) + 1.0
        v = torch.stack([xn / cam.p00, yn / cam.p11, torch.ones_like(xn)], -1)
        v = (v / torch.sqrt(dot(v, v))[..., None]).to(self.dt)
        r = self.cam_rot
        d = torch.stack([r[i, 0] * v[..., 0] + r[i, 1] * v[..., 1]
                         + r[i, 2] * v[..., 2] for i in range(3)], -1)
        o = self.cam_pos.expand_as(d)
        return o, d, jx, jy

    def li(self, seed, pix, s, n_grid, n_spp, depth):
        """Radiance (R, 3) float32 of sample s (int64 a lane) of pixels pix
        (int64), and the film jitters."""
        dt, R = self.dt, pix.shape[0]
        o, d, jx, jy = self.camera_rays(seed, pix, s, n_grid)
        full = torch.full((R,), 0.0, dtype=dt, device=self.dev)
        frag = self.intersect(o, d, full + CAMERA_MINT, full + BIG_T)
        wo = -d
        L = torch.zeros((R, 3), dtype=dt, device=self.dev)
        beta = torch.ones((R, 3), dtype=dt, device=self.dev)
        active = frag["hit"]
        for b in range(depth - 1):
            last = b == depth - 2
            p, ns, eps = frag["p"], frag["ns"], frag["eps"]
            m = frag["mat"]
            lam, glass = self.is_lambert[m], self.is_glass[m]
            c0, c1, eta = self.c0[m], self.c1[m], self.eta[m]

            # the light: picked by power, sampled at its position
            u = strat1(seed, pix, s, n_spp, b, DIM_PICK)
            lid = torch.clamp((self.l_cdf[None] <= u[:, None]).sum(-1), 0,
                              self.l_cdf.shape[0] - 1)
            to_l = self.l_pos[lid] - p
            dist2 = torch.clamp(dot(to_l, to_l), min=1e-20)
            dist = torch.sqrt(dist2)
            wi = to_l / dist[..., None]
            cos_t = dot(-wi, self.l_dir[lid])
            cmax, cstart = self.l_cmax[lid], self.l_cstart[lid]
            x = torch.clamp((cos_t - cmax) / torch.clamp(cstart - cmax,
                                                         min=1e-12), 0.0, 1.0)
            fall = torch.where(cos_t < cmax, 0.0,
                               torch.where(cos_t > cstart, 1.0,
                                           (x * x) * (x * x)))
            fall = torch.where(self.l_spot[lid], fall, 1.0)
            Li = self.l_col[lid] / dist2[..., None] * fall[..., None]
            same = dot(ns, wo) * dot(ns, wi) > 0.0
            f = torch.where((lam & same)[..., None], c0 / math.pi, 0.0)
            go = (active & (Li > 0.0).any(-1) & (f > 0.0).any(-1))
            occ = self.clusters.occluded(
                p, wi, torch.where(go, eps, BIG_T),
                torch.where(go, dist - eps, 0.0))
            Ld = torch.where((go & ~occ)[..., None],
                             f * Li * dot(ns, wi).abs()[..., None], 0.0)
            L = L + torch.where(active[..., None],
                                beta * Ld / self.l_pick[lid][..., None].to(dt),
                                0.0)
            if last:
                break  # a delta light is never hit: the walk ends here

            # the BSDF sample: cosine lobe, or glass's reflect / refract
            u1, u2 = strat2(seed, pix, s, n_spp, b, DIM_BSDF_U1, DIM_BSDF_U2)
            uc = strat1(seed, pix, s, n_spp, b, DIM_BSDF_COMP)
            u1, u2, uc = u1.to(dt), u2.to(dt), uc.to(dt)
            ndo = dot(ns, wo)
            tg = frag["dpdu"] - dot(frag["dpdu"], ns)[..., None] * ns
            tg = torch.where((dot(tg, tg) < 1e-16)[..., None], frame(ns),
                             unit(tg))
            bt = cross(ns, tg)
            sgn = torch.where(ndo < 0.0, -1.0, 1.0).to(dt)[..., None]
            r = torch.sqrt(torch.clamp(u1, min=0.0))
            phi = 2.0 * math.pi * u2
            loc = torch.stack([r * torch.cos(phi), r * torch.sin(phi),
                               torch.sqrt(torch.clamp(1.0 - u1, min=0.0))],
                              -1) * sgn
            wi_d = loc[..., 0:1] * tg + loc[..., 1:2] * bt + loc[..., 2:3] * ns
            same_d = ndo * dot(ns, wi_d) > 0.0
            f_d = torch.where(same_d[..., None], c0 / math.pi, 0.0)
            pdf_d = torch.where(same_d, dot(ns, wi_d).abs() / math.pi, 0.0)

            ci = ndo.abs()
            enter = ndo > 0.0
            n_or = torch.where(enter[..., None], ns, -ns)
            ei = torch.where(enter, 1.0, eta)
            et = torch.where(enter, eta, 1.0)
            sint = ei / et * sqrt0(1.0 - ci * ci)
            cost_f = sqrt0(1.0 - sint * sint)
            rpa = (et * ci - ei * cost_f) / torch.clamp(et * ci + ei * cost_f,
                                                         min=1e-12)
            rpe = (ei * ci - et * cost_f) / torch.clamp(ei * ci + et * cost_f,
                                                         min=1e-12)
            F = torch.where(sint >= 1.0, 1.0, 0.5 * (rpa * rpa + rpe * rpe))
            w_refl = 2.0 * ci[..., None] * n_or - wo
            k = ei / et
            sin2 = k * k * torch.clamp(1.0 - ci * ci, min=0.0)
            tir = sin2 >= 1.0
            w_refr = unit(n_or * (k * ci - sqrt0(1.0 - sin2))[..., None]
                          - k[..., None] * wo)
            s_refl = F / torch.clamp(ci, min=1e-12)
            s_refr = k * k * (1.0 - F) / torch.clamp(dot(w_refr, n_or).abs(),
                                                     min=1e-12)
            chance = s_refl * dot(w_refl, ns).abs()
            refl = (uc < chance) | tir
            wi_g = torch.where(refl[..., None], w_refl, w_refr)
            f_g = torch.where(refl[..., None], c0 * s_refl[..., None],
                              c1 * s_refr[..., None])
            pdf_g = torch.where(refl, chance, 1.0 - chance)

            wi = torch.where(glass[..., None], wi_g, wi_d)
            f_b = torch.where(glass[..., None], f_g, f_d)
            pdf_b = torch.where(glass, pdf_g, pdf_d)
            ok = active & (pdf_b > 0.0) & (f_b > 0.0).any(-1)
            nxt = self.intersect(p, wi, torch.where(ok, eps, BIG_T),
                                 torch.where(ok, 3.0e37, 0.0).to(dt))
            beta = torch.where(
                ok[..., None],
                beta * f_b * (dot(wi, ns).abs()
                              / torch.clamp(pdf_b, min=1e-20))[..., None],
                beta)
            active = ok & nxt["hit"]
            frag = {key: torch.where(
                active.reshape((R,) + (1,) * (v.ndim - 1)), nxt[key], v)
                for key, v in frag.items()}
            wo = torch.where(active[..., None], -wi, wo)
        return L.float(), jx, jy


def grid(spp):
    """The edge of the stratification grid: the least n with n * n >=
    spp."""
    return math.isqrt(max(1, spp) - 1) + 1


def gaussian(dx, dy, width, falloff):
    """The film's Gaussian filter, zero outside its width."""
    ex = float(np.exp(-falloff * width[0] ** 2))
    ey = float(np.exp(-falloff * width[1] ** 2))
    w = (torch.clamp(torch.exp(-falloff * dx * dx) - ex, min=0.0)
         * torch.clamp(torch.exp(-falloff * dy * dy) - ey, min=0.0))
    return torch.where((dx.abs() <= width[0]) & (dy.abs() <= width[1]), w,
                       0.0)


def film_at(renderer, seed, targets, s0, n_pass, spp, n_spp, depth,
            lanes=1 << 16):
    """The film (colour (K, 3), weight (K,)) that passes s0 .. s0 + n_pass
    - 1 of one camera sample a pixel leave at the target pixels (K,) (flat
    ids): each pixel sums the filter-weighted samples of the pixels within
    the filter's reach, as the film's dense splat does."""
    sc = renderer.scene
    cam, dev = sc.camera, renderer.dev
    W, H = cam.x_res, cam.y_res
    reach = (int(np.floor(sc.filter_width[0] + 0.5)),
             int(np.floor(sc.filter_width[1] + 0.5)))
    tgt = np.asarray(targets, np.int64)
    pairs = []  # (source pixel, target index, ox, oy)
    for i, p in enumerate(tgt):
        x, y = int(p % W), int(p // W)
        for oy in range(-reach[1], reach[1] + 1):
            for ox in range(-reach[0], reach[0] + 1):
                if 0 <= x + ox < W and 0 <= y + oy < H:
                    pairs.append(((y + oy) * W + x + ox, i, ox, oy))
    src, inv = np.unique(np.asarray([q[0] for q in pairs], np.int64),
                         return_inverse=True)
    q_idx = torch.as_tensor(inv.reshape(-1), device=dev)
    t_idx = torch.as_tensor([q[1] for q in pairs], device=dev)
    ox = torch.as_tensor([float(q[2]) for q in pairs], device=dev)
    oy = torch.as_tensor([float(q[3]) for q in pairs], device=dev)
    src = torch.as_tensor(src, device=dev)
    n_grid = grid(spp)
    color = torch.zeros((len(tgt), 3), dtype=torch.float64, device=dev)
    weight = torch.zeros(len(tgt), dtype=torch.float64, device=dev)
    per = max(1, lanes // src.numel())
    for a in range(s0, s0 + n_pass, per):
        ss = torch.arange(a, min(s0 + n_pass, a + per), device=dev)
        pix = src.repeat(ss.numel())
        s = ss.repeat_interleave(src.numel())
        L, jx, jy = renderer.li(seed, pix, s, n_grid, n_spp, depth)
        shape = (ss.numel(), src.numel())
        L, jx, jy = L.reshape(shape + (3,)), jx.reshape(shape), \
            jy.reshape(shape)
        fin = torch.isfinite(L).all(-1)
        # the splat's arithmetic in the renderer's precision too
        jx, jy = jx.to(renderer.dt), jy.to(renderer.dt)
        w = gaussian(0.5 - ox.to(renderer.dt) - jx[:, q_idx],
                     0.5 - oy.to(renderer.dt) - jy[:, q_idx],
                     sc.filter_width, sc.filter_falloff).float() \
            * fin[:, q_idx]
        Lq = torch.where(fin[..., None], L, 0.0)[:, q_idx]
        color.index_add_(0, t_idx, (w[..., None] * Lq).sum(0).double())
        weight.index_add_(0, t_idx, w.sum(0).double())
    return color, weight
