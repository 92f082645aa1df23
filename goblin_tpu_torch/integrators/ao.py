"""Ambient occlusion integrator (port of goblin_tpu/integrators/ao.py;
reference src/GoblinAO.cpp:12-42).

Wavefront form: the primary hits spawn all their N hemisphere occlusion
rays as one flat (R * N,) any-hit batch through the BVH, where the
reference loops over them hit by hit.
"""

from __future__ import annotations

import torch

from ..core.rng import hash_uniform
from ..core.sampling import uniform_sample_hemisphere
from ..scene import intersect as scn
from ..shading.bsdf import shading_frame, to_world
from .common import DIM_BASE


def make_li(ao_sample_num: int):
    """Build li(scene, meta, ray, pixel_ids, s_idx, seed) -> (R, 3): the
    share of ao_sample_num uniform hemisphere directions about the shading
    normal that reach nothing; 0 where the primary ray misses."""
    n = ao_sample_num

    def li(scene, meta, ray, pixel_ids, s_idx, seed):
        frag = scn.intersect(scene, meta, ray["o"], ray["d"], ray["mint"],
                             ray["maxt"])
        R = ray["o"].shape[0]
        t, b = shading_frame(frag["ns"], frag["dpdu"])
        # (R, n) occlusion directions: two dimensions a direction
        dims = DIM_BASE + 2 * torch.arange(n, device=pixel_ids.device)[None, :]
        u1 = hash_uniform(seed, pixel_ids[:, None], s_idx, 1, dims)
        u2 = hash_uniform(seed, pixel_ids[:, None], s_idx, 1, dims + 1)
        d_local = uniform_sample_hemisphere(u1, u2)  # (R, n, 3)
        d_world = to_world(t[:, None, :], b[:, None, :], frag["ns"][:, None, :],
                           d_local)
        # the directions of a primary miss are not traced (its lane is 0)
        live = frag["hit"][:, None].expand(R, n).reshape(-1)
        o = frag["p"][:, None, :].expand(R, n, 3).reshape(-1, 3)
        mint = frag["eps"][:, None].expand(R, n).reshape(-1)
        occ = scn.occluded(
            scene, meta, o, d_world.reshape(-1, 3),
            torch.where(live, mint, scn.BIG_T),
            torch.where(live, 3.0e37, 0.0)).reshape(R, n)
        vis = (1.0 - occ.to(torch.float32)).mean(dim=-1)
        L = torch.where(frag["hit"], vis, 0.0)
        return L[:, None].expand(R, 3)

    return li
