"""Light-path machinery of the splatting integrators and their dispatch
(port of goblin_tpu/splatting.py's light walk and render_dispatch).

SPPM is the splatting method ported so far; the light tracer and BDPT
come with ROADMAP Queue 1 item 10.
"""

from __future__ import annotations

import torch

from .core import vecmath as vm
from .core.rng import hash_uniform
from .integrators.common import DIM_BASE
from .integrators.materials import gather_material
from .integrators.path import _em_tri_data
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


def _env_le_at(scene, meta, wo):
    """Environment radiance for emission eval (goblin_tpu looks the map up
    at -wo): None, since the loader refuses image-based lights."""
    return None


def walk_light_paths(scene, meta, path_ids, s_idx, seed, max_path_length):
    """Run the light walk. Returns (emission dict, stacked vertices).

    The vertices are stacked (D, R, ...) with D = max_path_length - 1
    surface vertices; verts["tp"] is the path throughput up to each vertex
    (the light's positional and directional terms and every preceding
    bsdf * cos / pdf). A lane whose walk ended is not traced again (its
    vertices are invalid either way). The BSDF samples in radiance mode,
    SPPM's photons (goblin_tpu's mode=MODE_RADIANCE); the importance-mode
    walk of the light tracer and BDPT comes with ROADMAP Queue 1 item 10.
    """
    lights = scene["lights"]
    R = path_ids.shape[0]
    dev = path_ids.device

    def u(bounce, dim):
        return hash_uniform(seed, path_ids, s_idx, bounce, dim)

    lid, pick_pdf = lt.pick_light(lights, u(0, DIM_PICK))
    em = lt.sample_emission(lights, _em_tri_data(scene), lid, u(0, DIM_POS1),
                            u(0, DIM_POS2), u(0, DIM_DIR1), u(0, DIM_DIR2))
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
                            bx.BSDF_ALL, mode=bx.MODE_RADIANCE)
        cont = valid & bs["valid"] & (bs["f"] > 0.0).any(dim=-1)
        tp2 = tp * bs["f"] * (vm.absdot(bs["wi"], frag["ns"])
                              / torch.clamp(bs["pdf"], min=1e-20))[:, None]
        o, d, eps = frag["p"], bs["wi"], frag["eps"]
        tp = torch.where(cont[:, None], tp2, 0.0)
        active = cont
    return em, {k: torch.stack([v[k] for v in verts]) for k in verts[0]}


def render_dispatch(scene, meta, method, report=None):
    """Render a splatting method -> image (H, W, 3); report(done, total)
    after each iteration."""
    if method == "sppm":
        from .integrators.sppm import render_sppm

        return render_sppm(scene, meta, report=report)
    if method in ("light_tracing", "bdpt"):
        raise NotImplementedError(
            f"render_method {method!r} is not in goblin_tpu_torch yet "
            "(ROADMAP Queue 1 item 10)")
    raise ValueError(f"render_method {method!r} is not a splatting method")
