"""Bidirectional path tracing in wavefront form (port of
goblin_tpu/integrators/bdpt.py; reference src/GoblinBDPT.cpp).

A light walk and an eye walk store their path vertices (throughput,
forward and backward area pdfs, specular flags, G to the previous vertex),
and every (s, t) strategy of every path length connects them: s = 0 (the
eye path ends on a light), t = 0 (the light path hits the camera lens;
only with a lens primitive and a non-delta camera), t = 1 (connect to the
camera, the pixel re-projected by world_to_screen) and the inner
connections, each weighted by the reference's MIS pdf-ratio chain walked
in both directions with the specular-vertex skips and the power heuristic
(src/GoblinBDPT.cpp:376-526). debug_s / debug_t / debug_no_mis isolate
strategies (reference :59-63, 105-109).

Each lane is one (pixel, sample) of a chunk; each walk is a Python loop of
max_len closest-hit intersects, each connection one any-hit query. A lane
whose walk ended, and a connection that cannot count, go to the trace as
dead lanes (mint = 3e38, maxt = 0), where goblin_tpu traces them and masks
the result; every value such a lane touches is masked before the splat.

In a scene with an image-based light, an eye ray that escapes ends on a
virtual light vertex on the world's bounding sphere (inward normal, the
environment's light id, no BSDF), so the s = 0 strategies and the MIS
chains treat the environment as an emitting surface.

Known divergence of goblin_tpu from the reference, carried here: a thin
lens's pdf_position is the true 1 / (pi r^2), where the reference's
`1/r*r*PI` reduces to pi (src/GoblinCamera.cpp:211-214); it moves only the
MIS weights of t = 0 strategies.
"""

from __future__ import annotations

import torch

from ..camera import film as film_mod
from ..core import vecmath as vm
from ..core.rng import hash_uniform
from ..lights import lights as lt
from ..scene import intersect as scn
from ..shading import bsdf as bx
from . import direct
from .common import DIM_BASE, pixel_samples, spp_grid
from .materials import gather_material

_BIG_T = 3.0e38
LIGHT_SALT = DIM_BASE + 10  # the light walk's sample streams
EYE_SALT = DIM_BASE + 20  # the eye walk's


def _inv_dist(v):
    """(1 / |v|^2, v / |v|) of segments v, guarded as goblin_tpu guards."""
    inv_l2 = 1.0 / torch.clamp(vm.squared_length(v), min=1e-20)
    return inv_l2, v * torch.sqrt(inv_l2)[:, None]


def _walk(scene, meta, ids, s_idx, seed, start_p, start_d, tp0, mode,
          max_len, salt, env_sphere=None):
    """A random walk of max_len bounces -> its surface vertices stacked
    (max_len, R, ...): p, ns, uv, mat, light, dpdu, eps, wo (toward the
    previous vertex), tp, pdf_fwd and pdf_bwd (directional pdfs over
    |cos|; pdf_bwd evaluates the BSDF with wi and wo swapped), is_spec,
    G (to the previous vertex), valid, is_env, is_lens. Streams
    (seed, id, s_idx, bounce, salt .. salt + 3).

    env_sphere: (world centre, world radius, the environment's light id)
    for the eye walk of a scene with an image-based light: a ray that
    escapes ends on the bounding sphere's far root, a vertex with the
    inward normal and that light id, and the walk stops there."""
    R = ids.shape[0]
    dev = ids.device

    def u(b, k):
        return hash_uniform(seed, ids, s_idx, b, salt + k)

    o, d = start_p, start_d
    eps = torch.full((R,), 1e-3, dtype=torch.float32, device=dev)
    tp = tp0
    active = torch.ones(R, dtype=torch.bool, device=dev)
    prev_p, prev_ns = start_p, start_d
    verts = []
    for b in range(1, max_len + 1):
        frag = scn.intersect(scene, meta, o, d, torch.where(active, eps, _BIG_T),
                             torch.where(active, 3.0e37, 0.0))
        escaped = torch.zeros_like(active)
        if env_sphere is not None:
            wc, wr, env_lid = env_sphere
            escaped = active & ~frag["hit"]
            oc = o - wc
            bq = vm.dot(d, oc)
            disc = torch.clamp(bq * bq - (vm.squared_length(oc) - wr * wr),
                               min=0.0)
            t_sph = torch.clamp(-bq + torch.sqrt(disc), min=1e-3)  # far root
            p_sph = o + t_sph[:, None] * d
            e = escaped[:, None]
            frag = dict(frag)
            frag["p"] = torch.where(e, p_sph, frag["p"])
            frag["ns"] = torch.where(e, vm.normalize(wc - p_sph, eps=1e-30),
                                     frag["ns"])
            frag["light"] = torch.where(escaped, env_lid, frag["light"])
        valid = active & (frag["hit"] | escaped)
        mat = gather_material(scene, meta, frag,
                              u_mask=u(b, 3) if meta.has_null else None)
        ns, wo = frag["ns"], frag["wo"]
        bs = bx.bsdf_sample(mat, ns, frag["dpdu"], wo, u(b, 0), u(b, 1),
                            u(b, 2), bx.BSDF_ALL, mode=mode)
        pdf_fwd = bs["pdf"] / torch.clamp(vm.absdot(bs["wi"], ns), min=1e-20)
        pdf_bwd = torch.where(
            bs["is_specular"], pdf_fwd,
            bx.bsdf_pdf(mat, ns, bs["wi"], wo, bx.BSDF_ALL)
            / torch.clamp(vm.absdot(wo, ns), min=1e-20))
        # G to the previous vertex; the first vertex's origin normal is
        # patched by _fix_G_first
        inv_l2, dab = _inv_dist(frag["p"] - prev_p)
        G = vm.absdot(ns, dab) * vm.absdot(prev_ns, dab) * inv_l2
        verts.append({
            "p": frag["p"], "ns": ns, "uv": frag["uv"], "mat": frag["mat"],
            "light": frag["light"], "dpdu": frag["dpdu"], "eps": frag["eps"],
            "wo": wo, "tp": torch.where(valid[:, None], tp, 0.0),
            "pdf_fwd": pdf_fwd, "pdf_bwd": pdf_bwd,
            "is_spec": bs["is_specular"], "G": G, "valid": valid,
            "is_env": escaped, "is_lens": frag["is_lens"] & valid,
        })
        cont = valid & ~escaped & bs["valid"] & (bs["f"] > 0.0).any(dim=-1)
        tp = torch.where(cont[:, None],
                         tp * bs["f"] / torch.clamp(pdf_fwd, min=1e-20)[:, None],
                         0.0)
        o, d, eps, active = frag["p"], bs["wi"], frag["eps"], cont
        prev_p, prev_ns = frag["p"], ns
    return {k: torch.stack([v[k] for v in verts]) for k in verts[0]}


def _fix_G_first(verts, origin_p, origin_n, origin_is_delta):
    """The first vertex's G with the origin's normal (reference evalG: the
    light's or camera's cosine, 1 for a delta light)."""
    inv_l2, dab = _inv_dist(verts["p"][0] - origin_p)
    cos_a = torch.where(origin_is_delta, 1.0, vm.absdot(origin_n, dab))
    cos_b = vm.absdot(verts["ns"][0], dab)
    verts["G"] = verts["G"].clone()
    verts["G"][0] = cos_a * cos_b * inv_l2
    return verts


def _eval_g(pa, na, pb, nb, a_delta=None):
    inv_l2, dab = _inv_dist(pb - pa)
    cos_a = vm.absdot(na, dab)
    if a_delta is not None:
        cos_a = torch.where(a_delta, 1.0, cos_a)
    return cos_a * vm.absdot(nb, dab) * inv_l2


def _cos_or_tiny(a, b):
    """dot(a, b), with 1e-20 where it is 0 (goblin_tpu's divisor guard)."""
    c = vm.dot(a, b)
    return torch.where(c == 0, 1e-20, c)


def bdpt_contributions(scene, meta, pixel_ids, s_idx, seed, max_len,
                       debug_s=-1, debug_t=-1, debug_no_mis=False):
    """Every strategy's splat of a chunk of camera samples -> (x, y,
    contribution), the strategies one after another; lanes that do not
    count go to x = y = -1e9 with contribution 0."""
    lights = scene["lights"]
    cam = meta.camera
    spec = cam.film
    R = pixel_ids.shape[0]
    dev = pixel_ids.device
    n_grid = spp_grid(int(meta.settings.get("sample_per_pixel", 1)))

    def u(k):
        return hash_uniform(seed, pixel_ids, s_idx, 0, DIM_BASE + k)

    # ---- the light path's start
    lid, pick_pdf = lt.pick_light(lights, u(0))
    em = lt.sample_emission(lights, direct.em_tri_data(scene), lid, u(1),
                            u(2), u(3), u(4))
    pdf_bwd_l0 = em["pdf_pos"] * pick_pdf
    pdf_fwd_l0 = torch.where(
        em["is_delta"], em["pdf_dir"],
        em["pdf_dir"] / torch.clamp(vm.absdot(em["n"], em["dir"]), min=1e-20))
    # only a directional light samples a direction whose pdfDirection is 0
    l0_spec = lights["type"][lid] == lt.LIGHT_DIRECTIONAL
    l0_tp = 1.0 / torch.clamp(pdf_bwd_l0, min=1e-20)
    Le0 = lt.eval_emission(lights, lid, em["n"], em["dir"],
                           env_le=direct.env_le_at(scene, meta, em["dir"]))
    walk_tp_l = (l0_tp / torch.clamp(pdf_fwd_l0, min=1e-20))[:, None] * Le0
    lverts = _walk(scene, meta, pixel_ids, s_idx, seed, em["p"], em["dir"],
                   walk_tp_l, bx.MODE_IMPORTANCE, max_len, LIGHT_SALT)
    # a delta light cannot be hit: the first vertex's pdf_bwd is 0
    # (reference :206-208)
    lverts["pdf_bwd"] = lverts["pdf_bwd"].clone()
    lverts["pdf_bwd"][0] = torch.where(em["is_delta"], 0.0,
                                       lverts["pdf_bwd"][0])
    lverts = _fix_G_first(lverts, em["p"], em["n"], em["is_delta"])

    # ---- the eye path's start
    x, y = pixel_samples(seed, pixel_ids, spec.x_res, s_idx, n_grid)
    p_cam, n_cam, pdf_cam = cam.sample_position(u(5), u(6))
    dir_e, We, pdf_dir_e = cam.sample_direction(x, y, p_cam)
    pdf_fwd_e0 = pdf_dir_e / torch.clamp(vm.absdot(n_cam, dir_e), min=1e-20)
    e0_tp = 1.0 / torch.clamp(pdf_cam, min=1e-20)
    walk_tp_e = (e0_tp * We / torch.clamp(pdf_fwd_e0, min=1e-20))[:, None]
    env_sphere = None
    if meta.has_env:
        env_sphere = (lights["world_center"], lights["world_radius"],
                      meta.env_light_id)
    look = torch.tensor(cam.look.tolist(), dtype=torch.float32,
                        device=dev).expand(R, 3)
    everts = _walk(scene, meta, pixel_ids, s_idx, seed, p_cam, dir_e,
                   walk_tp_e.expand(R, 3), bx.MODE_RADIANCE, max_len, EYE_SALT,
                   env_sphere=env_sphere)
    everts["pdf_bwd"] = everts["pdf_bwd"].clone()
    if cam.is_delta:
        everts["pdf_bwd"][0] = 0.0
    everts = _fix_G_first(everts, p_cam, look,
                          torch.zeros(R, dtype=torch.bool, device=dev))

    l_count = 1 + lverts["valid"].sum(dim=0)
    e_count = 1 + everts["valid"].sum(dim=0)
    zeros_b = torch.zeros(R, dtype=torch.bool, device=dev)
    light0 = {"p": em["p"], "ns": em["n"], "tp": l0_tp[:, None].expand(R, 3),
              "pdf_fwd": pdf_fwd_l0, "pdf_bwd": pdf_bwd_l0, "is_spec": l0_spec,
              "light": lid, "is_lens": zeros_b}
    eye0 = {"p": p_cam, "ns": look, "tp": e0_tp[:, None].expand(R, 3),
            "pdf_fwd": pdf_fwd_e0, "pdf_bwd": pdf_cam, "is_spec": zeros_b,
            "light": torch.full((R,), -1, dtype=lid.dtype, device=dev),
            "is_lens": zeros_b}

    def lv_get(field, i):
        """Light path vertex i (0 = the light itself)."""
        return light0[field] if i == 0 else lverts[field][i - 1]

    def ev_get(field, i):
        """Eye path vertex i (0 = the camera)."""
        return eye0[field] if i == 0 else everts[field][i - 1]

    # a vertex's material, gathered from (mat, uv) alone as goblin_tpu
    # does (no mask sample, no footprint), once for all its strategies
    mats = {}

    def vertex_mat(verts, tag, i):
        if (tag, i) not in mats:
            mats[tag, i] = gather_material(
                scene, meta, {"mat": verts["mat"][i - 1],
                              "uv": verts["uv"][i - 1]})
        return mats[tag, i]

    def vertex_bsdf(verts, tag, i, wo, wi, mode):
        f = bx.bsdf_eval(vertex_mat(verts, tag, i), verts["ns"][i - 1], wo, wi,
                         bx.BSDF_ALL, mode=mode)
        # a virtual environment vertex has no BSDF
        return torch.where(verts["is_env"][i - 1][:, None], 0.0, f)

    def vertex_pdf(verts, tag, i, wo, wi):
        pdf = bx.bsdf_pdf(vertex_mat(verts, tag, i), verts["ns"][i - 1], wo,
                          wi, bx.BSDF_ALL)
        return torch.where(verts["is_env"][i - 1], 0.0, pdf)

    pick_table = lights["power"] / lights["power"].sum()
    xs, ys, cs = [], [], []
    for path_length in range(1, max_len + 1):
        pvc = path_length + 1
        for s in range(0, pvc + 1):
            t = pvc - s
            if debug_s != -1 and s != debug_s:
                continue
            if debug_t != -1 and t != debug_t:
                continue
            if (s == 0 and t < 2) or (t == 0 and s < 2) or s + t < 2:
                continue
            if t == 0 and (cam.is_delta or not meta.has_lens):
                continue  # the lens-hit strategies need a lens primitive
            ok = (s <= l_count) & (t <= e_count)
            Gc = torch.ones(R, dtype=torch.float32, device=dev)

            # ---- the unweighted contribution
            if s == 0:
                # the eye path's end vertex is a light (reference
                # src/GoblinBDPT.cpp:119-122)
                end_light = ev_get("light", t - 1)
                ok = ok & (end_light >= 0)
                wo = vm.normalize(ev_get("p", t - 2) - ev_get("p", t - 1),
                                  eps=1e-30)
                cst = lt.eval_emission(
                    lights, torch.clamp(end_light, min=0),
                    ev_get("ns", t - 1), wo,
                    env_le=direct.env_le_at(scene, meta, wo))
                contrib = cst * ev_get("tp", t - 1)
                sx, sy = x, y
            elif t == 0:
                # the light path's end vertex hit the lens: splat where it
                # re-projects (reference :127-133, :303-306)
                ok = ok & lv_get("is_lens", s - 1)
                p_s1, p_s2 = lv_get("p", s - 1), lv_get("p", s - 2)
                sx, sy, _, scr_ok = cam.world_to_screen(p_s2, p_s1)
                ok = ok & scr_ok
                contrib = lv_get("tp", s - 1) * cam.eval_we(p_s1, p_s2)[:, None]
            else:
                sp_ = lv_get("p", s - 1)
                tp_ = ev_get("p", t - 1)
                conn = tp_ - sp_
                dist = torch.clamp(vm.squared_length(conn).sqrt(), min=1e-20)
                cd = conn / dist[:, None]
                if s == 1:
                    fsL = lt.eval_emission(
                        lights, lid, em["n"], cd,
                        env_le=direct.env_le_at(scene, meta, cd))
                else:
                    woL = vm.normalize(lv_get("p", s - 2) - sp_, eps=1e-30)
                    fsL = vertex_bsdf(lverts, "l", s - 1, woL, cd,
                                      bx.MODE_IMPORTANCE)
                if t == 1:
                    fsE = cam.eval_we(tp_, sp_)[:, None]
                    sx, sy, _, scr_ok = cam.world_to_screen(sp_, tp_)
                    ok = ok & scr_ok
                else:
                    woE = vm.normalize(ev_get("p", t - 2) - tp_, eps=1e-30)
                    fsE = vertex_bsdf(everts, "e", t - 1, woE, -cd,
                                      bx.MODE_RADIANCE)
                    sx, sy = x, y
                Gc = _eval_g(sp_, lv_get("ns", s - 1), tp_, ev_get("ns", t - 1),
                             em["is_delta"] if s == 1 else None)
                contrib = lv_get("tp", s - 1) * (fsL * fsE * Gc[:, None]) \
                    * ev_get("tp", t - 1)
                # the visibility query, for the lanes that can count
                ok = ok & (Gc > 0.0) & (contrib != 0.0).any(dim=-1)
                eps_c = 1e-3 * dist
                ok = ok & ~scn.occluded(scene, meta, sp_, cd,
                                        torch.where(ok, eps_c, _BIG_T),
                                        torch.where(ok, dist - eps_c, 0.0))
            ok = ok & (contrib != 0.0).any(dim=-1)

            # ---- the MIS weight
            if debug_no_mis:
                weight = 1.0
            else:
                weight = _mis_weight(cam, lights, pick_table, lv_get, ev_get,
                                     lverts, everts, vertex_pdf, em, lid, s,
                                     t, Gc, R)[:, None]
            cs.append(torch.where(ok[:, None], weight * contrib, 0.0))
            xs.append(torch.where(ok, sx, -1e9))
            ys.append(torch.where(ok, sy, -1e9))

    if not xs:  # the debug filters can exclude every strategy
        off = torch.full((R,), -1e9, dtype=torch.float32, device=dev)
        return off, off, torch.zeros((R, 3), dtype=torch.float32, device=dev)
    return torch.cat(xs), torch.cat(ys), torch.cat(cs)


def _mis_weight(cam, lights, pick_table, lv_get, ev_get, lverts, everts,
                vertex_pdf, em, lid, s, t, Gc, R):
    """The reference's evalMIS as masked vector ops: the end vertices' pdfs
    re-evaluated toward each other, then the ratio chain toward the eye and
    toward the light, summing the squared ratios of the strategies that are
    not skipped for a specular vertex."""
    dev = Gc.device
    zero = torch.zeros(R, dtype=torch.float32, device=dev)
    if s == 0:
        end_light = torch.clamp(ev_get("light", t - 1), min=0)
        p, n = ev_get("p", t - 1), ev_get("ns", t - 1)
        pdfT_fwd = pick_table[end_light] * lt.pdf_emission_position(
            lights, end_light)
        wo = vm.normalize(ev_get("p", t - 2) - p, eps=1e-30)
        pdfT_bwd = lt.pdf_emission_direction(lights, end_light, n, wo) \
            / _cos_or_tiny(n, wo)
        pdfS_fwd = pdfS_bwd = zero
    elif t == 0:
        # the light path ends on the lens (reference :397-405)
        p, n = lv_get("p", s - 1), lv_get("ns", s - 1)
        pdfS_fwd = torch.full((R,), cam.pdf_position(), dtype=torch.float32,
                              device=dev)
        wo = vm.normalize(lv_get("p", s - 2) - p, eps=1e-30)
        pdfS_bwd = cam.pdf_direction(wo) / _cos_or_tiny(n, wo)
        pdfT_fwd = pdfT_bwd = zero
    else:
        sp_, tp_ = lv_get("p", s - 1), ev_get("p", t - 1)
        d_st = vm.normalize(tp_ - sp_, eps=1e-30)
        nS, nT = lv_get("ns", s - 1), ev_get("ns", t - 1)
        if s == 1:
            pdfW = lt.pdf_emission_direction(lights, lid, em["n"], d_st)
            pdfS_fwd = torch.where(em["is_delta"], pdfW,
                                   pdfW / _cos_or_tiny(nS, d_st))
            pdfS_bwd = lv_get("pdf_bwd", 0)
        else:
            woS = vm.normalize(lv_get("p", s - 2) - sp_, eps=1e-30)
            pdfS_fwd = vertex_pdf(lverts, "l", s - 1, woS, d_st) \
                / _cos_or_tiny(d_st, nS)
            pdfS_bwd = vertex_pdf(lverts, "l", s - 1, d_st, woS) \
                / _cos_or_tiny(woS, nS)
        d_ts = -d_st
        if t == 1:
            pdfT_fwd = cam.pdf_direction(d_ts) / _cos_or_tiny(nT, d_ts)
            pdfT_bwd = ev_get("pdf_bwd", 0)
        else:
            woT = vm.normalize(ev_get("p", t - 2) - tp_, eps=1e-30)
            pdfT_fwd = vertex_pdf(everts, "e", t - 1, woT, d_ts) \
                / _cos_or_tiny(d_ts, nT)
            pdfT_bwd = vertex_pdf(everts, "e", t - 1, d_ts, woT) \
                / _cos_or_tiny(woT, nT)

    # the reference's misNodes: pdfs toward the light and toward the eye
    k = s + t - 1
    pL = [zero] * (k + 1)
    pE = [zero] * (k + 1)
    spec = [torch.zeros(R, dtype=torch.bool, device=dev)] * (k + 1)
    for i in range(0, s - 1):
        pL[i] = (lv_get("pdf_bwd", 0) if i == 0
                 else lv_get("pdf_bwd", i) * lv_get("G", i))
        pE[i] = lv_get("pdf_fwd", i) * lv_get("G", i + 1)
        spec[i] = lv_get("is_spec", i)
    if s > 0:
        pL[s - 1] = pdfS_bwd if s == 1 else pdfS_bwd * lv_get("G", s - 1)
        pE[s - 1] = pdfS_fwd if (s - 1) == k else pdfS_fwd * Gc
        spec[s - 1] = lv_get("is_spec", s - 1)
    for i in range(0, t - 1):
        pE[k - i] = (ev_get("pdf_bwd", 0) if i == 0
                     else ev_get("pdf_bwd", i) * ev_get("G", i))
        pL[k - i] = ev_get("pdf_fwd", i) * ev_get("G", i + 1)
        spec[k - i] = ev_get("is_spec", i)
    if t > 0:
        pE[k - (t - 1)] = pdfT_bwd if t == 1 else pdfT_bwd * ev_get("G", t - 1)
        pL[k - (t - 1)] = pdfT_fwd if (t - 1) == k else pdfT_fwd * Gc
        spec[k - (t - 1)] = ev_get("is_spec", t - 1)

    def safe_div(a, b):
        return a / torch.where(b.abs() < 1e-30, 1e-30, b)

    ones_b = torch.ones(R, dtype=torch.bool, device=dev)
    mis_sum = torch.ones(R, dtype=torch.float32, device=dev)
    # toward the eye
    pK = torch.ones(R, dtype=torch.float32, device=dev)
    for i in range(s, k + 1):
        if i == 0:
            pK = pK * safe_div(pL[0], pL[1])
            add = ~spec[1]
        elif i == k:
            if cam.is_delta:
                break
            pK = pK * safe_div(pE[k - 1], pE[k])
            add = ones_b
        else:
            pK = pK * safe_div(pE[i - 1], pL[i + 1])
            add = ~(spec[i] | spec[i + 1])
        mis_sum = mis_sum + torch.where(add, pK * pK, 0.0)
    # toward the light
    pK = torch.ones(R, dtype=torch.float32, device=dev)
    for i in range(s, 0, -1):
        if i == k + 1:
            pK = pK * safe_div(pE[k], pE[k - 1])
            add = ~spec[k - 1]
        elif i == 1:
            pK = pK * safe_div(pL[1], pL[0])
            add = ~em["is_delta"]  # an eye path cannot hit a delta light
        else:
            pK = pK * safe_div(pL[i], pE[i - 2])
            add = ~(spec[i - 1] | spec[i - 2])
        mis_sum = mis_sum + torch.where(add, pK * pK, 0.0)
    return 1.0 / mis_sum


def render_bdpt(scene, meta, chunk_size=1 << 16, spp=None, seed=None,
                report=None):
    """A BDPT render -> image (H, W, 3): spp samples of every crop pixel in
    chunks of chunk_size camera samples, each chunk's strategies splatted
    with the filter's normalization, the film resolved without its weights
    and scaled by pixels / samples (reference :553-558). The last chunk is
    padded with the last pixel's id and the padding masked; a chunk is no
    larger than the crop. The streams key on pixel id, so the chunk size
    moves only the film's summation order. report(done, total) after each
    chunk."""
    spec = meta.camera.film
    if spp is None:
        spp = int(meta.settings.get("sample_per_pixel", 1))
    if seed is None:
        seed = int(meta.settings.get("seed", 0))
    max_len = max(1, int(meta.settings.get("max_ray_depth", 5)))
    debug = (int(meta.settings.get("debug_s", -1)),
             int(meta.settings.get("debug_t", -1)),
             bool(meta.settings.get("debug_no_mis", False)))
    n_spp = spp_grid(spp) ** 2
    dev = scene["tri_rows"].device
    xs_, xc, ys_, yc = spec.crop_window()
    n_pix = xc * yc
    chunk_size = min(chunk_size, n_pix)
    rows = torch.arange(ys_, ys_ + yc, dtype=torch.int32, device=dev)
    cols = torch.arange(xs_, xs_ + xc, dtype=torch.int32, device=dev)
    pixel_ids = (rows[:, None] * spec.x_res + cols[None, :]).reshape(-1)
    n_chunks = (n_pix + chunk_size - 1) // chunk_size
    pad = n_chunks * chunk_size - n_pix
    valid = torch.ones(n_pix + pad, dtype=torch.bool, device=dev)
    if pad:
        pixel_ids = torch.cat([pixel_ids, pixel_ids[-1:].expand(pad)])
        valid[n_pix:] = False
    with torch.inference_mode():
        color, weight = film_mod.new_film(spec, dev)
        for s in range(n_spp):
            for ci in range(n_chunks):
                sl = slice(ci * chunk_size, (ci + 1) * chunk_size)
                x, y, c = bdpt_contributions(scene, meta, pixel_ids[sl], s,
                                             seed, max_len, *debug)
                v = valid[sl].repeat(x.shape[0] // chunk_size)
                film_mod.splat(spec, color, weight, torch.where(v, x, -1e9), y,
                               torch.where(v[:, None], c, 0.0), normalized=True)
                if report is not None:
                    report(s * n_chunks + ci + 1, n_spp * n_chunks)
        img = film_mod.to_image(color, weight, normalize=False)
        return img * (float(n_pix) / float(n_spp * n_pix))
