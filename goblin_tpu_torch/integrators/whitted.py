"""Whitted-style direct lighting integrator (port of
goblin_tpu/integrators/whitted.py; reference src/GoblinWhitted.cpp:13-71
and the shared estimateLd, GoblinRenderer.cpp:502-564).

Wavefront form: the reference's recursive ray tree (at every hit, Le plus
direct light from every light over the non-specular lobes, then recursion
into both the specular reflection and the specular refraction,
GoblinWhitted.cpp:33-38, GoblinRenderer.cpp:598-656) is walked node by
node; each node is a masked segment of the whole wavefront, and its
children are the same function one level down. The nodes are numbered in
the order they are made, the reflection child and all below it before the
refraction child, and a node's number keys its sample streams.

The tree is pruned by what the scene's materials can do: reflection
children exist only where a specular-reflective material (transparent,
mirror or subsurface, mask-wrapped included) is present, refraction
children only with a transparent one. A Lambert / Blinn scene is a single node; with a
transparent material the tree is the reference's own, 2^(depth + 1) - 1
nodes. A node whose ray escapes takes the environment map's radiance, and
the image-based light's direct light samples the map. A subsurface
material adds its BSSRDF term at every node, keyed by the node's number.
"""

from __future__ import annotations

import torch

from ..core import vecmath as vm
from ..core.rng import hash_uniform
from ..core.sampling import power_heuristic
from ..lights import envmap
from ..lights import lights as lt
from ..scene import intersect as scn
from ..shading import bsdf as bx
from ..shading.bsdf import MAT_MIRROR, MAT_SUBSURFACE, MAT_TRANSPARENT
from . import direct
from .bssrdf import subsurface_L
from .common import DIM_BASE
from .materials import gather_material

# a child's sample streams are keyed by this plus its number in the tree
NODE_TAG_BASE = 0x100


def _specular_caps(meta):
    """(can_reflect, can_transmit): the specular branches that some
    material of the scene can produce. A mask wraps a material that is a
    row of the table itself, so its kind is among them already."""
    kinds = set(meta.material_kinds)
    if not kinds:
        return True, True  # the table is unknown: prune nothing
    return (bool(kinds & {MAT_TRANSPARENT, MAT_MIRROR, MAT_SUBSURFACE}),
            MAT_TRANSPARENT in kinds)


def _direct_light(scene, meta, frag, mat, active, pixel_ids, s_idx, seed,
                  node_tag):
    """Direct light from every light, each over its sample_num samples with
    MIS, for the non-specular lobes (reference multiSampleLd,
    GoblinRenderer.cpp:474-564, with the type mask Whitted passes,
    GoblinWhitted.cpp:30-32). Each sample takes a light-side shadow query,
    which punches through mask surfaces, and a BSDF-side intersect."""
    lights = scene["lights"]
    R = frag["p"].shape[0]
    dev = frag["p"].device
    p, ns, wo, eps = frag["p"], frag["ns"], frag["wo"], frag["eps"]
    nee_type = bx.BSDF_ALL & ~bx.BSDF_SPECULAR
    Ld = torch.zeros((R, 3), dtype=torch.float32, device=dev)
    dim0 = DIM_BASE + 16

    def u(dim):
        return hash_uniform(seed, pixel_ids, s_idx, node_tag, dim)

    for li_id in range(max(1, meta.n_lights)):
        sn = 1
        if li_id < len(meta.light_sample_nums):
            sn = max(1, meta.light_sample_nums[li_id])
        is_env_light = meta.has_env and li_id == meta.env_light_id
        lid = torch.full((R,), li_id, dtype=torch.int32, device=dev)
        Ld_i = torch.zeros((R, 3), dtype=torch.float32, device=dev)
        for _ in range(sn):
            # --- the light-sample side
            if is_env_light:
                li_e, wi_e, pdf_e = envmap.sample_env(scene, meta, u(dim0),
                                                      u(dim0 + 1))
                ls = {"Li": li_e, "wi": wi_e, "pdf": pdf_e,
                      "shadow_maxt": torch.full((R,), 3.0e37, device=dev),
                      "is_delta": torch.zeros(R, dtype=torch.bool,
                                              device=dev)}
            else:
                ls = direct.sample_light(scene, meta, lid, p, eps, u(dim0),
                                         u(dim0 + 1), ibl=False)
            Ld_l, _ = direct.light_side(scene, meta, mat, frag, ls, active,
                                        lobes=nee_type)
            Ld_i = Ld_i + Ld_l
            # --- the BSDF-sample side (masked for delta lights)
            bsn = bx.bsdf_sample(mat, ns, frag["dpdu"], wo, u(dim0 + 2),
                                 u(dim0 + 3), u(dim0 + 4), nee_type)
            b_ok = (active & ~ls["is_delta"] & bsn["valid"]
                    & (bsn["f"] > 0.0).any(dim=-1) & ~bsn["is_specular"])
            fragb = scn.intersect(scene, meta, p, bsn["wi"],
                                  torch.where(b_ok, eps, scn.BIG_T),
                                  torch.where(b_ok, 3.0e37, 0.0))
            if is_env_light:
                # the map, where the BSDF ray escapes
                pdf_l_b = envmap.pdf_env(scene, meta, bsn["wi"])
                Li_b = direct.env_le(scene, meta, bsn["wi"])
                got = b_ok & ~fragb["hit"] & (pdf_l_b > 0.0)
            else:
                cos_l = vm.dot(fragb["ns"], -bsn["wi"])
                pdf_l_b = lt.pdf_li(lights, lid, p, bsn["wi"], fragb["t"],
                                    cos_l, fragb["light"])
                Li_b = direct.area_light_le(scene, fragb, -bsn["wi"])
                got = (b_ok & fragb["hit"] & (fragb["light"] == lid)
                       & (pdf_l_b > 0.0))
            w_f = power_heuristic(1.0, bsn["pdf"], 1.0, pdf_l_b)
            Ld_i = Ld_i + torch.where(
                got[:, None],
                bsn["f"] * Li_b
                * (vm.absdot(bsn["wi"], ns) * w_f
                   / torch.clamp(bsn["pdf"], min=1e-20))[:, None],
                0.0)
            dim0 += 8
        Ld = Ld + Ld_i / float(sn)
    return Ld


def make_li(meta, max_depth=None):
    """Build li(scene, meta, ray, pixel_ids, s_idx, seed) -> (R, 3). The
    primary ray has depth 0 and a node spawns children while its depth is
    below max_depth (reference RayDifferential.depth, GoblinWhitted.cpp:33,
    GoblinRenderer.cpp:618-620)."""
    if max_depth is None:
        max_depth = int(meta.settings.get("max_ray_depth", 5))
    can_reflect, can_transmit = _specular_caps(meta)

    def li(scene, meta_, ray, pixel_ids, s_idx, seed):
        R = ray["o"].shape[0]
        node_counter = [0]

        def radiance(frag, d_in, active, depth, node_tag):
            """Li of a wavefront segment that is intersected already (the
            reference's Li body, GoblinWhitted.cpp:13-42); d_in, the
            incoming direction, looks the environment up on a miss."""
            hit = frag["hit"] & active
            L = torch.where(hit[:, None],
                            direct.area_light_le(scene, frag, frag["wo"]),
                            0.0)
            if meta.has_env:
                L = L + torch.where((active & ~frag["hit"])[:, None],
                                    direct.env_le(scene, meta, d_in), 0.0)
            if meta.n_lights == 0:
                return L

            if meta.has_bssrdf:
                L = L + subsurface_L(scene, meta, frag, hit, pixel_ids,
                                     s_idx, seed, bounce=node_tag)

            def u(dim):
                return hash_uniform(seed, pixel_ids, s_idx, node_tag, dim)

            mat = gather_material(
                scene, meta, frag,
                u_mask=u(DIM_BASE + 9) if meta.has_null else None)
            L = L + torch.where(
                hit[:, None],
                _direct_light(scene, meta, frag, mat, hit, pixel_ids, s_idx,
                              seed, node_tag),
                0.0)
            if depth >= max_depth:
                return L

            def spec_child(type_mask):
                bs = bx.bsdf_sample(mat, frag["ns"], frag["dpdu"], frag["wo"],
                                    u(DIM_BASE + 5), u(DIM_BASE + 6),
                                    u(DIM_BASE + 7), type_mask)
                ok = (hit & bs["is_specular"] & bs["valid"]
                      & (bs["f"] > 0.0).any(dim=-1))
                frag2 = scn.intersect(scene, meta, frag["p"], bs["wi"],
                                      torch.where(ok, frag["eps"], scn.BIG_T),
                                      torch.where(ok, 3.0e37, 0.0))
                node_counter[0] += 1
                Lr = radiance(frag2, bs["wi"], ok, depth + 1,
                              NODE_TAG_BASE + node_counter[0])
                w = bs["f"] * (vm.absdot(bs["wi"], frag["ns"])
                               / torch.clamp(bs["pdf"], min=1e-20))[:, None]
                return torch.where(ok[:, None], w * Lr, 0.0)

            # the reflection child, and all below it, before the refraction
            if can_reflect:
                L = L + spec_child(bx.BSDF_SPECULAR | bx.BSDF_REFLECTION)
            if can_transmit:
                L = L + spec_child(bx.BSDF_SPECULAR | bx.BSDF_TRANSMISSION)
            return L

        frag = scn.intersect(scene, meta, ray["o"], ray["d"], ray["mint"],
                             ray["maxt"], dxd=ray.get("dxd"),
                             dyd=ray.get("dyd"))
        return radiance(frag, ray["d"],
                        torch.ones(R, dtype=torch.bool,
                                   device=frag["hit"].device), 0, 0)

    return li
