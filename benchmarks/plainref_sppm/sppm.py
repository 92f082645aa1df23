"""The reference SPPM renderer at chosen pixels (the estimator of the
upstream's src/GoblinSPPM.cpp, as the program follows it), for the scenes
that plainref.scene reads.

An iteration:
  1. one camera path a pixel, with direct light at each vertex (one light
     picked by power, a shadow ray), continued by BSDF samples until the
     first diffuse vertex, or the vertex of path length max_ray_depth - 1,
     becomes the pixel's visible point;
  2. as many photons as the film has pixels, from the lights, each walked
     up to max_ray_depth surface vertices, depositing at every vertex of
     path length > 1 (a path of length 1 is the camera side's direct
     light);
  3. at each visible point, every deposit within its radius whose path
     length and the camera path's add up to at most max_ray_depth, found
     by a distance test over every deposit (no grid): N, the flux tau and
     the radius then shrink with alpha = 0.7.
The pixel's radiance is Ld / iterations + tau / (emitted pi r^2), splatted
at the pixel centres by the film's filter.

Departures from the upstream, each the program's too:
- camera streams: the radical inverse of the iteration in one prime base a
  (bounce, dim), 64 primes in turn, rotated by a per-pixel hash shift
  (Cranley-Patterson), where the upstream permutes Halton digits; the
  radical inverse is summed here in float64 and rounded once, where the
  program sums in float32, so the two may differ in the last bit;
- the pixel's jitter is the hash of its stratum it % spp, so the film's
  strata repeat every spp iterations;
- photon streams: the 32-bit hash of (seed + 77, photon, iteration,
  bounce, dim), photon ids counting on from one iteration to the next;
- M counts every deposit within the radius, the BSDF's zeros too, and
  there is no cap on deposits;
- every light plainref.scene reads is a delta light, so direct light's MIS
  weight is 1 and a continuation never hits a light; nothing that a camera
  ray meets emits;
- only a positive initial_radius (no automatic radius).
dtype is the precision of the arithmetic: float32 is the configuration's,
a lower one makes the benchmark's control.
"""

from __future__ import annotations

import json
import math

import numpy as np
import torch

from plainref import pathtrace, scene as rscene
from plainref.pathtrace import BIG_T, cross, dot, sqrt0, uniform, unit

ALPHA = 0.7
PHOTON_SEED = 77
MAX_T = 3.0e37
PHOTON_EPS = 1e-3
# the camera side's streams: one prime base a (bounce, dim), 7 dims a
# bounce, the shift hashed from (pixel, salt + bounce, dim)
QMC_SALT = 0x51C
QMC_DIMS = 7
QMC_PRIMES = (
    2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53,
    59, 61, 67, 71, 73, 79, 83, 89, 97, 101, 103, 107, 109, 113, 127, 131,
    137, 139, 149, 151, 157, 163, 167, 173, 179, 181, 191, 193, 197, 199,
    211, 223, 227, 229, 233, 239, 241, 251, 257, 263, 269, 271, 277, 281,
    283, 293, 307, 311,
)
Q_PICK, Q_U1, Q_U2, Q_UC = 1, 4, 5, 6
# the photon side's dims: the light pick and direction at bounce 0, the
# BSDF sample at bounces 1 ..
P_PICK, P_DIR1, P_DIR2, P_U1, P_U2, P_UC = 4, 7, 8, 9, 10, 11


def load(path, overrides=None, film=None):
    """The scene through plainref.scene.load, whose gate passes path
    tracing only: render_method is overridden for the load and put back,
    and the SPPM settings are the file's and the overrides'."""
    sc = rscene.load(path, dict(overrides or {},
                                render_method="path_tracing"), film=film)
    with open(path) as f:
        method = json.load(f).get("render_setting", {}).get("render_method")
    sc.settings["render_method"] = (overrides or {}).get("render_method",
                                                         method)
    if float(sc.settings.get("initial_radius", -1.0)) <= 0.0:
        raise ValueError("the SPPM reference needs a positive "
                         "initial_radius")
    return sc


def radical_inverse(n, base):
    """The radical inverse of n (as uint32) in base, rounded to float32."""
    n &= 0xFFFFFFFF
    v, f = 0.0, 1.0 / base
    while n:
        v += (n % base) * f
        n //= base
        f /= base
    return float(np.float32(v))


class Renderer(pathtrace.Renderer):
    """The path tracer's tables and queries, and SPPM's two walks."""

    def __init__(self, scene, device, dtype=torch.float32):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        super().__init__(scene, device, dtype)
        self.max_len = max(2, int(scene.settings.get("max_ray_depth", 5)))
        self.spp = int(scene.settings.get("sample_per_pixel", 1))
        self.radius0 = float(scene.settings["initial_radius"])
        self.n_photons = scene.camera.x_res * scene.camera.y_res

    # -- BSDFs (Lambert, glass)

    def f_lambert(self, m, ns, wo, wi):
        same = dot(ns, wo) * dot(ns, wi) > 0.0
        return torch.where((self.is_lambert[m] & same)[..., None],
                           self.c0[m] / math.pi, 0.0)

    def sample_bsdf(self, m, ns, dpdu, wo, u1, u2, uc):
        """-> (wi, f, pdf): the Lambert cosine lobe, or glass's Fresnel
        pick of reflection and refraction (radiance transport)."""
        dt = self.dt
        u1, u2, uc = u1.to(dt), u2.to(dt), uc.to(dt)
        c0, c1, eta = self.c0[m], self.c1[m], self.eta[m]
        ndo = dot(ns, wo)
        tg = dpdu - dot(dpdu, ns)[..., None] * ns
        tg = torch.where((dot(tg, tg) < 1e-16)[..., None], pathtrace.frame(ns),
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

        glass = self.is_glass[m]
        return (torch.where(glass[..., None], wi_g, wi_d),
                torch.where(glass[..., None], f_g, f_d),
                torch.where(glass, pdf_g, pdf_d))

    def spot(self, lid, w):
        """The light's falloff along w leaving it: a spot's cone, 1 for a
        point light."""
        cos_t = dot(w, self.l_dir[lid])
        cmax, cstart = self.l_cmax[lid], self.l_cstart[lid]
        x = torch.clamp((cos_t - cmax) / torch.clamp(cstart - cmax,
                                                     min=1e-12), 0.0, 1.0)
        fall = torch.where(cos_t < cmax, 0.0,
                           torch.where(cos_t > cstart, 1.0,
                                       (x * x) * (x * x)))
        return torch.where(self.l_spot[lid], fall, 1.0)

    def pick(self, u):
        lid = torch.clamp((self.l_cdf[None] <= u[:, None]).sum(-1), 0,
                          self.l_cdf.shape[0] - 1)
        return lid, self.l_pick[lid].to(self.dt)

    # -- the camera side

    def qmc(self, seed, pix, it, b, k):
        """Camera dim k of bounce b at iteration it, for pixels pix."""
        base = QMC_PRIMES[(b * QMC_DIMS + k) % len(QMC_PRIMES)]
        shift = uniform(seed, pix, QMC_SALT + b, 0, k)
        return torch.remainder(radical_inverse(it, base) + shift, 1.0)

    def camera_paths(self, seed, pix, it):
        """One camera path a pixel of pix (int64) at iteration it ->
        (Ld (R, 3), visible points: p, ns, wo, tp, mat, len, valid)."""
        dt, R, dev = self.dt, pix.shape[0], self.dev
        g = pathtrace.grid(self.spp)
        s = torch.full_like(pix, it % (g * g))
        o, d, _, _ = self.camera_rays(seed, pix, s, g)
        full = torch.zeros(R, dtype=dt, device=dev)
        frag = self.intersect(o, d, full + pathtrace.CAMERA_MINT,
                              full + BIG_T)
        wo = -d
        Ld = torch.zeros((R, 3), dtype=dt, device=dev)
        tp = torch.ones((R, 3), dtype=dt, device=dev)
        active = frag["hit"]
        vp = {"p": torch.zeros((R, 3), dtype=dt, device=dev),
              "ns": torch.zeros((R, 3), dtype=dt, device=dev),
              "wo": torch.zeros((R, 3), dtype=dt, device=dev),
              "tp": torch.zeros((R, 3), dtype=dt, device=dev),
              "mat": torch.zeros(R, dtype=torch.int64, device=dev),
              "len": torch.zeros(R, dtype=torch.int64, device=dev),
              "valid": torch.zeros(R, dtype=torch.bool, device=dev)}
        for b in range(self.max_len):
            p, ns, eps, m = frag["p"], frag["ns"], frag["eps"], frag["mat"]

            # direct light: one light picked by power, a shadow ray
            lid, pick_pdf = self.pick(self.qmc(seed, pix, it, b, Q_PICK))
            to_l = self.l_pos[lid] - p
            dist2 = torch.clamp(dot(to_l, to_l), min=1e-20)
            dist = torch.sqrt(dist2)
            wl = to_l / dist[..., None]
            Li = self.l_col[lid] / dist2[..., None] \
                * self.spot(lid, -wl)[..., None]
            f = self.f_lambert(m, ns, wo, wl)
            go = active & (Li > 0.0).any(-1) & (f > 0.0).any(-1)
            occ = self.clusters.occluded(
                p, wl, torch.where(go, eps, BIG_T),
                torch.where(go, dist - eps, 0.0))
            nee = torch.where((go & ~occ)[..., None],
                              f * Li * dot(ns, wl).abs()[..., None], 0.0)
            Ld = Ld + torch.where(active[..., None],
                                  tp * nee / pick_pdf[..., None], 0.0)

            # the continuation
            wi, f_b, pdf_b = self.sample_bsdf(
                m, ns, frag["dpdu"], wo, self.qmc(seed, pix, it, b, Q_U1),
                self.qmc(seed, pix, it, b, Q_U2),
                self.qmc(seed, pix, it, b, Q_UC))
            ok = active & (pdf_b > 0.0) & (f_b > 0.0).any(-1)
            nxt = self.intersect(p, wi, torch.where(ok, eps, BIG_T),
                                 torch.where(ok, MAX_T, 0.0).to(dt))

            # the visible point: the first diffuse vertex, or path length
            # max_len - 1
            record = active if b + 1 == self.max_len - 1 else \
                active & self.is_lambert[m]
            for key, v in (("p", p), ("ns", ns), ("wo", wo), ("tp", tp)):
                vp[key] = torch.where(record[..., None], v, vp[key])
            vp["mat"] = torch.where(record, m, vp["mat"])
            vp["len"] = torch.where(record, b + 1, vp["len"])
            vp["valid"] = vp["valid"] | record

            tp2 = tp * f_b * (dot(wi, ns).abs()
                              / torch.clamp(pdf_b, min=1e-20))[..., None]
            active = active & ~record & ok & nxt["hit"]
            tp = torch.where(active[..., None], tp2, tp)
            frag = {key: torch.where(
                active.reshape((R,) + (1,) * (v.ndim - 1)), nxt[key], v)
                for key, v in frag.items()}
            wo = torch.where(active[..., None], -wi, wo)
        return Ld, vp

    # -- the photon side

    def photons(self, seed, it, first, n):
        """The deposits of photons first .. first + n - 1 at iteration it
        -> (p (N, 3), wi (N, 3) toward the previous vertex, weight (N, 3),
        path length (N,)). Only live photons are traced."""
        dt, dev = self.dt, self.dev
        ps = seed + PHOTON_SEED
        ids = torch.arange(first, first + n, dtype=torch.int64, device=dev)

        lid, pick_pdf = self.pick(uniform(ps, ids, it, 0, P_PICK))
        ax = self.l_dir[lid]
        ax1 = pathtrace.frame(ax)
        ax2 = cross(ax, ax1)
        u1 = uniform(ps, ids, it, 0, P_DIR1).to(dt)
        u2 = uniform(ps, ids, it, 0, P_DIR2).to(dt)
        spot = self.l_spot[lid]
        cmax = self.l_cmax[lid]
        # a spot's uniform cone, a point light's uniform sphere
        cos_t = torch.where(spot, 1.0 - u1 + u1 * cmax, 1.0 - 2.0 * u1)
        sin_t = sqrt0(1.0 - cos_t * cos_t)
        phi = 2.0 * math.pi * u2
        d_cone = ((sin_t * torch.cos(phi))[..., None] * ax1
                  + (sin_t * torch.sin(phi))[..., None] * ax2
                  + cos_t[..., None] * ax)
        d_sph = torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi),
                             cos_t], -1)
        d = torch.where(spot[..., None], d_cone, d_sph)
        pdf_dir = torch.where(spot, 1.0 / (2.0 * math.pi * (1.0 - cmax)),
                              1.0 / (4.0 * math.pi))
        tp = ((1.0 / torch.clamp(pick_pdf, min=1e-20))
              * (1.0 / torch.clamp(pdf_dir, min=1e-20)))[..., None] \
            .expand(n, 3)
        le = self.spot(lid, d)[..., None] * self.l_col[lid]
        o = self.l_pos[lid]
        eps = torch.full((n,), PHOTON_EPS, dtype=dt, device=dev)
        lane = torch.arange(n, device=dev)
        out = []
        for b in range(1, self.max_len + 1):
            frag = self.intersect(o, d, eps, torch.full_like(eps, MAX_T))
            hit = frag["hit"]
            if b >= 2:
                out.append((frag["p"][hit], -d[hit], (tp * le[lane])[hit],
                            torch.full((int(hit.sum()),), b, device=dev)))
            if b == self.max_len:
                break
            pid = ids[lane]
            wi, f, pdf = self.sample_bsdf(
                frag["mat"], frag["ns"], frag["dpdu"], -d,
                uniform(ps, pid, it, b, P_U1), uniform(ps, pid, it, b, P_U2),
                uniform(ps, pid, it, b, P_UC))
            cont = hit & (pdf > 0.0) & (f > 0.0).any(-1)
            tp = (tp * f * (dot(wi, frag["ns"]).abs()
                            / torch.clamp(pdf, min=1e-20))[..., None])[cont]
            o, d, eps = frag["p"][cont], wi[cont], frag["eps"][cont]
            lane = lane[cont]
            if lane.numel() == 0:
                break
        if not out:
            z = torch.zeros((0, 3), dtype=dt, device=dev)
            return z, z, z, torch.zeros(0, dtype=torch.int64, device=dev)
        return tuple(torch.cat(parts) for parts in zip(*out))

    # -- the gather and the update

    def gather(self, vp, radius, deposits, block=1 << 24):
        """Phi (K, 3) and M (K,) at the visible points: every deposit
        within the radius whose path length fits the camera path's
        budget, by a distance test over all deposits."""
        dp, wi, wgt, plen = deposits
        K = vp["p"].shape[0]
        Phi = torch.zeros((K, 3), dtype=self.dt, device=self.dev)
        M = torch.zeros(K, dtype=self.dt, device=self.dev)
        r2 = (radius * radius)[:, None]
        budget = (self.max_len - vp["len"])[:, None]
        fc = torch.where(self.is_lambert[vp["mat"]][..., None],
                         self.c0[vp["mat"]] / math.pi, 0.0)
        ndo = dot(vp["ns"], vp["wo"])[:, None]
        step = max(1, block // max(1, K))
        for a in range(0, dp.shape[0], step):
            sl = slice(a, a + step)
            diff = dp[None, sl] - vp["p"][:, None]
            ok = ((dot(diff, diff) <= r2) & (plen[None, sl] <= budget)
                  & vp["valid"][:, None])
            same = ndo * dot(vp["ns"][:, None], wi[None, sl]) > 0.0
            M = M + ok.sum(1).to(self.dt)
            Phi = Phi + fc * ((ok & same).to(self.dt) @ wgt[sl])
        return Phi, M


def update(Ni, Tau, radius, Phi, M, vp):
    """N, tau and the radius after an iteration's gather (alpha 0.7)."""
    has = vp["valid"] & (M > 0)
    new_n = Ni + ALPHA * M
    new_r = radius * torch.sqrt(new_n / torch.clamp(Ni + M, min=1e-12))
    q = new_r / torch.clamp(radius, min=1e-20)
    ratio = torch.where(has, q * q, 1.0)
    new_tau = (Tau + vp["tp"] * Phi) * ratio[:, None]
    return (torch.where(has, new_n, Ni),
            torch.where(has[:, None], new_tau, Tau),
            torch.where(has, new_r, radius))


def state_at(ren, seed, pix, it0, n_it):
    """The SPPM state (Ld_acc, Ni, Tau, radius (K, ...), emitted) of pixels
    pix (K,) after iterations it0 .. it0 + n_it - 1 of a fresh state."""
    dt, dev, K = ren.dt, ren.dev, pix.shape[0]
    st = {"Ld_acc": torch.zeros((K, 3), dtype=dt, device=dev),
          "Ni": torch.zeros(K, dtype=dt, device=dev),
          "Tau": torch.zeros((K, 3), dtype=dt, device=dev),
          "radius": torch.full((K,), ren.radius0, dtype=dt, device=dev),
          "emitted": 0}
    for it in range(it0, it0 + n_it):
        Ld, vp = ren.camera_paths(seed, pix, it)
        deposits = ren.photons(seed, it, st["emitted"], ren.n_photons)
        Phi, M = ren.gather(vp, st["radius"], deposits)
        st["Ld_acc"] = st["Ld_acc"] + Ld
        st["Ni"], st["Tau"], st["radius"] = update(
            st["Ni"], st["Tau"], st["radius"], Phi, M, vp)
        st["emitted"] += ren.n_photons
    return st


def radiance(state, iterations):
    """L (K, 3) of a state: Ld / iterations + tau / (emitted pi r^2)."""
    r = state["radius"]
    return state["Ld_acc"] / max(iterations, 1) + state["Tau"] / torch.clamp(
        state["emitted"] * math.pi * (r * r)[:, None], min=1e-20)


def reach(x_res, y_res, filter_width, targets):
    """The pixels whose centre sample the film's filter carries to the
    target pixels (flat ids): the targets padded by the filter's reach ->
    (sources (S,), pairs of (source index, target index, ox, oy))."""
    rx = int(np.floor(filter_width[0] + 0.5))
    ry = int(np.floor(filter_width[1] + 0.5))
    pairs = []
    for i, p in enumerate(np.asarray(targets, np.int64)):
        x, y = int(p % x_res), int(p // x_res)
        for oy in range(-ry, ry + 1):
            for ox in range(-rx, rx + 1):
                if 0 <= x + ox < x_res and 0 <= y + oy < y_res:
                    pairs.append(((y + oy) * x_res + x + ox, i, ox, oy))
    src, inv = np.unique(np.asarray([q[0] for q in pairs], np.int64),
                         return_inverse=True)
    return src, [(int(j), q[1], q[2], q[3])
                 for j, q in zip(inv.reshape(-1), pairs)]


def splat(ren, targets, sources, pairs, L):
    """The film (colour (K, 3), weight (K,)) at the targets from the
    sources' radiance L (S, 3), each splatted at its pixel centre."""
    sc, dev, dt = ren.scene, ren.dev, ren.dt
    q_idx = torch.as_tensor([q[0] for q in pairs], device=dev)
    t_idx = torch.as_tensor([q[1] for q in pairs], device=dev)
    ox = torch.as_tensor([float(q[2]) for q in pairs], device=dev, dtype=dt)
    oy = torch.as_tensor([float(q[3]) for q in pairs], device=dev, dtype=dt)
    fin = torch.isfinite(L.float()).all(-1)[q_idx]
    w = pathtrace.gaussian(ox, oy, sc.filter_width, sc.filter_falloff) \
        .float() * fin
    Lq = torch.where(fin[..., None], L.float()[q_idx], 0.0)
    K = len(targets)
    color = torch.zeros((K, 3), dtype=torch.float64, device=dev)
    weight = torch.zeros(K, dtype=torch.float64, device=dev)
    color.index_add_(0, t_idx, (w[..., None] * Lq).double())
    weight.index_add_(0, t_idx, w.double())
    return color, weight


def film_at(ren, seed, targets, it0, n_it):
    """The film at the target pixels (flat ids) that iterations it0 ..
    it0 + n_it - 1 of a fresh state leave -> (colour (K, 3), weight (K,),
    the state at the pixels the filter reads, those pixels)."""
    cam = ren.scene.camera
    sources, pairs = reach(cam.x_res, cam.y_res, ren.scene.filter_width,
                           targets)
    pix = torch.as_tensor(sources, device=ren.dev)
    st = state_at(ren, seed, pix, it0, n_it)
    color, weight = splat(ren, targets, sources, pairs, radiance(st, n_it))
    return color, weight, st, sources
