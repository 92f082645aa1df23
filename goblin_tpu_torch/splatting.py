"""Splatting integrators: the light walk that SPPM and the light tracer
share, the light tracer, and the dispatch (port of goblin_tpu/splatting.py).

Wavefront light tracing (reference splatFilmT1,
src/GoblinLightTracer.cpp:73-171): a batch of light paths walks the scene
with importance transport, every surface vertex and the light vertex
itself are connected to the camera by a visibility ray, and the
contribution is filter-splatted at the pixel it projects to. The film is
resolved without its weights and scaled by pixels / paths
(src/GoblinLightTracer.cpp:360-365). The reference's two cross-checking
estimators are here too: t0 (a path deposits only where it hits the lens
disk) and s1 (a camera walk, each vertex connected to one light sample).
BDPT (integrators/bdpt.py) and SPPM (integrators/sppm.py) are dispatched
from here.
"""

from __future__ import annotations

import torch

from .camera import film as film_mod
from .core import vecmath as vm
from .core.rng import hash_uniform
from .integrators import direct
from .integrators.common import DIM_BASE
from .integrators.materials import gather_material
from .lights import lights as lt
from .scene import intersect as scn
from .shading import bsdf as bx

# dim layout for the light walk
DIM_PICK = DIM_BASE + 0
DIM_POS1 = DIM_BASE + 1
DIM_POS2 = DIM_BASE + 2
DIM_DIR1 = DIM_BASE + 3
DIM_DIR2 = DIM_BASE + 4
DIM_B1 = DIM_BASE + 5
DIM_B2 = DIM_BASE + 6
DIM_BC = DIM_BASE + 7

_BIG_T = 3.0e38


def walk_light_paths(scene, meta, path_ids, s_idx, seed, max_path_length,
                     mode=bx.MODE_IMPORTANCE):
    """Run the light walk. Returns (emission dict, stacked vertices).

    The vertices are stacked (D, R, ...) with D = max_path_length - 1
    surface vertices; verts["tp"] is the path throughput up to each vertex
    (the light's positional and directional terms and every preceding
    bsdf * cos / pdf). A lane whose walk ended is not traced again (its
    vertices are invalid either way). mode is the BSDF's transport
    mode: importance for the light tracer, radiance for SPPM's photons,
    which pass it.
    """
    lights = scene["lights"]
    R = path_ids.shape[0]
    dev = path_ids.device

    def u(bounce, dim):
        return hash_uniform(seed, path_ids, s_idx, bounce, dim)

    lid, pick_pdf = lt.pick_light(lights, u(0, DIM_PICK))
    em = lt.sample_emission(lights, direct.em_tri_data(scene), lid,
                            u(0, DIM_POS1), u(0, DIM_POS2), u(0, DIM_DIR1),
                            u(0, DIM_DIR2))
    em["lid"] = lid
    em["pick_pdf"] = pick_pdf
    # throughput of the light vertex itself: 1 / (pdf_pos * pick_pdf)
    em["vertex_tp"] = 1.0 / torch.clamp(em["pdf_pos"] * pick_pdf, min=1e-20)
    # walk throughput after leaving the light (delta lights skip |cos|:
    # reference splatFilmT1 throughput init)
    tp0 = em["vertex_tp"] * torch.where(
        em["is_delta"],
        1.0 / torch.clamp(em["pdf_dir"], min=1e-20),
        vm.absdot(em["n"], em["dir"]) / torch.clamp(em["pdf_dir"], min=1e-20),
    )

    o, d = em["p"], em["dir"]
    eps = torch.full((R,), 1e-3, dtype=torch.float32, device=dev)
    tp = tp0[:, None].expand(R, 3)
    active = torch.ones(R, dtype=torch.bool, device=dev)
    verts = []
    for b in range(1, max_path_length):
        frag = scn.intersect(scene, meta, o, d, torch.where(active, eps, _BIG_T),
                             torch.where(active, 3.0e37, 0.0))
        valid = active & frag["hit"]
        verts.append({
            "p": frag["p"],
            "ns": frag["ns"],
            "dpdu": frag["dpdu"],
            "uv": frag["uv"],
            "mat": frag["mat"],
            "light": frag["light"],
            "eps": frag["eps"],
            "wo_prev": frag["wo"],
            "tp": torch.where(valid[:, None], tp, 0.0),
            "valid": valid,
            "is_lens": frag["is_lens"] & valid,
        })
        mat = gather_material(
            scene, meta, frag,
            u_mask=u(b, DIM_BC + 1) if meta.has_null else None)
        bs = bx.bsdf_sample(mat, frag["ns"], frag["dpdu"], frag["wo"],
                            u(b, DIM_B1), u(b, DIM_B2), u(b, DIM_BC),
                            bx.BSDF_ALL, mode=mode)
        cont = valid & bs["valid"] & (bs["f"] > 0.0).any(dim=-1)
        tp2 = tp * bs["f"] * (vm.absdot(bs["wi"], frag["ns"])
                              / torch.clamp(bs["pdf"], min=1e-20))[:, None]
        o, d, eps = frag["p"], bs["wi"], frag["eps"]
        tp = torch.where(cont[:, None], tp2, 0.0)
        active = cont
    return em, {k: torch.stack([v[k] for v in verts]) for k in verts[0]}


def _connection(ok, x, y, c):
    """One connection's splat (x, y, c): lanes that are not ok go off the
    film with no contribution."""
    return (torch.where(ok, x, -1e9), torch.where(ok, y, -1e9),
            torch.where(ok[:, None], c, 0.0))


def _cat(parts):
    return tuple(torch.cat(v) for v in zip(*parts))


def _unoccluded(scene, meta, ok, p, w, dist):
    """ok lanes whose segment of length dist from p along w is free (the
    plain any-hit query: masks occlude); lanes that are not ok are not
    traced."""
    eps = 1e-3 * dist
    return ok & ~scn.occluded(scene, meta, p, w, torch.where(ok, eps, _BIG_T),
                              torch.where(ok, dist - eps, 0.0))


def light_trace_contributions(scene, meta, path_ids, s_idx, seed,
                              max_path_length):
    """t1, the light tracer proper: every vertex of the light walk, the
    light's own included, connected to a sampled camera position -> (x, y,
    contribution), the connections of all vertices one after another."""
    lights = scene["lights"]
    cam = meta.camera
    lu = hash_uniform(seed, path_ids, s_idx, 0x7FFE, 0)
    lv = hash_uniform(seed, path_ids, s_idx, 0x7FFE, 1)
    p_cam, n_cam, pdf_cam = cam.sample_position(lu, lv)
    cam_tp = 1.0 / torch.clamp(pdf_cam, min=1e-20)

    em, verts = walk_light_paths(scene, meta, path_ids, s_idx, seed,
                                 max_path_length)
    lid = em["lid"]
    p_light, n_light = em["p"], em["n"]

    # ---- s == 1: the light vertex itself
    to_cam = p_cam - p_light
    dist = torch.clamp(vm.squared_length(to_cam).sqrt(), min=1e-20)
    wo = to_cam / dist[:, None]
    sx, sy, _, scr_ok = cam.world_to_screen(p_light, p_cam)
    fsl = lt.eval_emission(lights, lid, n_light, wo,
                           env_le=direct.env_le_at(scene, meta, wo))
    ok = _unoccluded(scene, meta, scr_ok & (fsl > 0).any(dim=-1), p_light, wo,
                     dist)
    G = vm.absdot(n_cam, wo) / torch.clamp(dist * dist, min=1e-20)
    G = G * torch.where(em["is_delta"], 1.0, vm.absdot(n_light, wo))
    we = cam.eval_we(p_cam, p_light)
    out = [_connection(
        ok, sx, sy, fsl * (we * G * cam_tp * em["vertex_tp"])[:, None])]

    # ---- s >= 2: the surface vertices
    fsl_light = lt.eval_emission(
        lights, lid, n_light, em["dir"],
        env_le=direct.env_le_at(scene, meta, em["dir"]))
    for d in range(max_path_length - 1):
        p, ns = verts["p"][d], verts["ns"][d]
        to_cam = p_cam - p
        dist = torch.clamp(vm.squared_length(to_cam).sqrt(), min=1e-20)
        wo = to_cam / dist[:, None]
        sx, sy, _, scr_ok = cam.world_to_screen(p, p_cam)
        mat = gather_material(scene, meta,
                              {"mat": verts["mat"][d], "uv": verts["uv"][d]})
        f = bx.bsdf_eval(mat, ns, wo, verts["wo_prev"][d], bx.BSDF_ALL,
                         mode=bx.MODE_IMPORTANCE)
        fsl = f * fsl_light
        ok = _unoccluded(
            scene, meta, verts["valid"][d] & scr_ok & (fsl > 0).any(dim=-1),
            p, wo, dist)
        G = vm.absdot(ns, wo) * vm.absdot(n_cam, wo) / torch.clamp(
            dist * dist, min=1e-20)
        we = cam.eval_we(p_cam, p)
        out.append(_connection(
            ok, sx, sy, fsl * verts["tp"][d] * (we * G * cam_tp)[:, None]))
    return _cat(out)


def light_trace_t0_contributions(scene, meta, path_ids, s_idx, seed,
                                 max_path_length):
    """t0 (reference splatFilmT0, src/GoblinLightTracer.cpp:180-238): the
    light walk deposits only where a vertex lies on the camera-lens disk,
    light emission x We x the throughput at the lens, splatted where the
    segment into the lens projects. Needs a lens (lens_radius > 0)."""
    cam = meta.camera
    em, verts = walk_light_paths(scene, meta, path_ids, s_idx, seed,
                                 max_path_length)
    fsl = lt.eval_emission(scene["lights"], em["lid"], em["n"], em["dir"],
                           env_le=direct.env_le_at(scene, meta, em["dir"]))
    out = []
    for d in range(max_path_length - 1):
        p_lens = verts["p"][d]
        p_prev = em["p"] if d == 0 else verts["p"][d - 1]
        sx, sy, _, scr_ok = cam.world_to_screen(p_prev, p_lens)
        c = fsl * verts["tp"][d] * cam.eval_we(p_lens, p_prev)[:, None]
        ok = verts["is_lens"][d] & scr_ok & (c > 0).any(dim=-1)
        out.append(_connection(ok, sx, sy, c))
    return _cat(out)


def light_trace_s1_contributions(scene, meta, path_ids, s_idx, seed,
                                 max_path_length):
    """s1 (reference splatFilmS1, src/GoblinLightTracer.cpp:239-333): a
    camera walk in radiance mode, every vertex connected to one sampled
    light position without MIS: the path-tracer-shaped estimator of the
    three."""
    lights = scene["lights"]
    cam = meta.camera
    R = path_ids.shape[0]
    dev = path_ids.device

    def u(bounce, dim):
        return hash_uniform(seed, path_ids, s_idx, bounce, dim)

    lid, pick_pdf = lt.pick_light(lights, u(0, DIM_PICK))
    em = lt.sample_emission(lights, direct.em_tri_data(scene), lid,
                            u(0, DIM_POS1), u(0, DIM_POS2), u(0, DIM_DIR1),
                            u(0, DIM_DIR2))
    p_light, n_light = em["p"], em["n"]
    l_tp = 1.0 / torch.clamp(em["pdf_pos"] * pick_pdf, min=1e-20)

    # the camera start: a film position inside the crop window, which the
    # other two estimators and the render's path count are based on
    xs_, xc, ys_, yc = cam.film.crop_window()
    px = xs_ + u(0x7FFD, 0) * xc
    py = ys_ + u(0x7FFD, 1) * yc
    p_cam, n_cam, pdf_cam = cam.sample_position(u(0x7FFE, 0), u(0x7FFE, 1))
    dir_e, We, pdf_dir_e = cam.sample_direction(px, py, p_cam)
    cam_tp = 1.0 / torch.clamp(pdf_cam, min=1e-20)
    tp = (cam_tp * vm.absdot(n_cam, dir_e)
          / torch.clamp(pdf_dir_e, min=1e-20))[:, None].expand(R, 3)

    def connect(ok, p, light_side):
        """The connection from p to the light sample -> (ok and unoccluded,
        wi, the light's emission toward p, G x the light vertex's
        throughput); light_side is |cos| at p."""
        to_l = p_light - p
        dist = torch.clamp(vm.squared_length(to_l).sqrt(), min=1e-20)
        wi = to_l / dist[:, None]
        fsL = lt.eval_emission(lights, lid, n_light, -wi,
                               env_le=direct.env_le_at(scene, meta, -wi))
        G = light_side(wi) / (dist * dist)
        G = G * torch.where(em["is_delta"], 1.0, vm.absdot(n_light, wi))
        return _unoccluded(scene, meta, ok, p, wi, dist), wi, fsL, G * l_tp

    # the eye walk
    o, dseg = p_cam, dir_e
    eps = torch.full((R,), 1e-3, dtype=torch.float32, device=dev)
    active = torch.ones(R, dtype=torch.bool, device=dev)
    verts = []
    for b in range(1, max_path_length):
        frag = scn.intersect(scene, meta, o, dseg,
                             torch.where(active, eps, _BIG_T),
                             torch.where(active, 3.0e37, 0.0))
        valid = active & frag["hit"]
        verts.append({"p": frag["p"], "ns": frag["ns"], "mat": frag["mat"],
                      "uv": frag["uv"], "wo": frag["wo"],
                      "tp": torch.where(valid[:, None], tp, 0.0),
                      "valid": valid})
        mat = gather_material(scene, meta, frag)
        bs = bx.bsdf_sample(mat, frag["ns"], frag["dpdu"], frag["wo"],
                            u(b, DIM_B1), u(b, DIM_B2), u(b, DIM_BC),
                            bx.BSDF_ALL)
        active = valid & bs["valid"] & (bs["f"] > 0.0).any(dim=-1)
        tp = torch.where(
            active[:, None],
            tp * bs["f"] * (vm.absdot(bs["wi"], frag["ns"])
                            / torch.clamp(bs["pdf"], min=1e-20))[:, None],
            0.0)
        o, dseg, eps = frag["p"], bs["wi"], frag["eps"]

    # t = 1: the light sample seen from the camera vertex, splatted where
    # it projects
    sx, sy, _, scr_ok = cam.world_to_screen(p_light, p_cam)
    ok, wi, fsL, g_tp = connect(scr_ok, p_cam, lambda w: vm.absdot(n_cam, w))
    c = fsL * cam.eval_we(p_cam, p_light)[:, None] * (g_tp * cam_tp)[:, None]
    out = [_connection(ok & (c > 0).any(dim=-1), sx, sy, c)]
    # t >= 2: the surface vertices, splatted at the sampled film position
    for v in verts:
        ok, wi, fsL, g_tp = connect(v["valid"], v["p"],
                                    lambda w, v=v: vm.absdot(v["ns"], w))
        mat = gather_material(scene, meta, {"mat": v["mat"], "uv": v["uv"]})
        f = bx.bsdf_eval(mat, v["ns"], v["wo"], wi, bx.BSDF_ALL)
        c = fsL * (f * We[:, None]) * v["tp"] * g_tp[:, None]
        out.append(_connection(ok & (c > 0).any(dim=-1), px, py, c))
    return _cat(out)


LT_STRATEGIES = {"t1": light_trace_contributions,
                 "t0": light_trace_t0_contributions,
                 "s1": light_trace_s1_contributions}


def render_light_tracer(scene, meta, chunk_size=1 << 14, spp=None, seed=None,
                        strategy=None, report=None):
    """A light-traced render -> image (H, W, 3), from spp x crop pixels
    light paths in chunks of chunk_size (the last chunk is whole too, and
    the scale counts it so).

    strategy: "t1" (connect every vertex to the camera, the reference's
    default), "t0" (lens hits only; needs lens_radius > 0) or "s1" (camera
    walk and light connection), the reference's three estimators that
    check one another (src/GoblinLightTracer.h:30-46); it defaults to the
    scene's lt_strategy setting. report(done, total) after each chunk."""
    spec = meta.camera.film
    if spp is None:
        spp = int(meta.settings.get("sample_per_pixel", 1))
    if seed is None:
        seed = int(meta.settings.get("seed", 0))
    max_len = max(1, int(meta.settings.get("max_ray_depth", 5)))
    if strategy is None:
        strategy = str(meta.settings.get("lt_strategy", "t1"))
    contrib_fn = LT_STRATEGIES[strategy]
    dev = scene["tri_rows"].device
    _, xc, _, yc = spec.crop_window()
    n_pix = xc * yc
    n_chunks = (spp * n_pix + chunk_size - 1) // chunk_size
    with torch.inference_mode():
        color, weight = film_mod.new_film(spec, dev)
        for ci in range(n_chunks):
            ids = torch.arange(ci * chunk_size, (ci + 1) * chunk_size,
                               dtype=torch.int32, device=dev)
            x, y, c = contrib_fn(scene, meta, ids, 0, seed, max_len)
            film_mod.splat(spec, color, weight, x, y, c, normalized=True)
            if report is not None:
                report(ci + 1, n_chunks)
        img = film_mod.to_image(color, weight, normalize=False)
        return img * (float(n_pix) / float(n_chunks * chunk_size))


def render_dispatch(scene, meta, method, report=None):
    """Render a splatting method -> image (H, W, 3); report(done, total)
    after each iteration (SPPM) or chunk of paths (light tracing, BDPT)."""
    if method == "sppm":
        from .integrators.sppm import render_sppm

        return render_sppm(scene, meta, report=report)
    if method == "light_tracing":
        return render_light_tracer(scene, meta, report=report)
    if method == "bdpt":
        from .integrators.bdpt import render_bdpt

        return render_bdpt(scene, meta, report=report)
    raise ValueError(f"render_method {method!r} is not a splatting method")
