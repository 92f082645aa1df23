"""Per-lane material resolution: a row gather of the material table plus
texture lookups (port of goblin_tpu/integrators/materials.py)."""

from __future__ import annotations

import torch

from ..shading.bsdf import MAT_MASK

# columns of scene["mat_rows"] (goblin_tpu's _pack_mat_rows order, with the
# integer columns stored as float values instead of bit patterns)
COL_TYPE, COL_C0, COL_C1, COL_F0, COL_F1, COL_ETA, COL_K, COL_INNER = range(8)


def _pick(stack, ids):
    """stack (X, R, C) selected per lane by ids (R,) -> (R, C)."""
    return stack[ids, torch.arange(ids.shape[0], device=ids.device)]


def gather_material(scene, meta, frag, u_mask=None):
    """Per-lane material parameters for bsdf_eval / bsdf_pdf / bsdf_sample:
    mtype (R,) i32, c0 / c1 (R, 3), f0, eta, k (R,), and the scene's
    material kinds for the BSDF's branch pruning.

    A mask material is flattened (reference MaskMaterial wrapping,
    src/GoblinMaterial.cpp:747-811): the lane carries its inner material's
    row, with is_masked, mask_alpha, the transparent colour in c1 and
    mask_u, the sample that picks between the inner lobe and the
    punch-through (u_mask; zeros when not given). Scenes without a mask
    material (meta.has_null false) skip the second gather and carry none
    of the mask keys. frag needs mat and uv; p (spherical mappings) and
    duv / duv4 (the filtered lookups' footprint) are read where present."""
    table = scene["mat_rows"]
    rows = table[frag["mat"]]  # (R, 8)
    where = {"p": frag.get("p"), "duv": frag.get("duv"),
             "duv4": frag.get("duv4")}
    tex = meta.texture_system.eval_all(
        frag["uv"], scene["tex_atlas"], scene["tex_const"], **where)
    ftex = meta.float_texture_system.eval_all(
        frag["uv"], scene["ftex_atlas"], scene["ftex_const"], **where)
    mask = {}
    if meta.has_null:
        rows_mid = rows
        is_masked = rows_mid[:, COL_TYPE] == MAT_MASK
        rows = torch.where(
            is_masked[:, None],
            table[torch.clamp(rows_mid[:, COL_INNER], min=0.0).long()],
            rows_mid)
        alpha = _pick(ftex, rows_mid[:, COL_F1].long())[..., 0]
        mask = {
            "is_masked": is_masked,
            "mask_alpha": alpha,
            "mask_u": torch.zeros_like(alpha) if u_mask is None else u_mask,
        }
    c1 = _pick(tex, rows[:, COL_C1].long())
    if meta.has_null:
        c1 = torch.where(is_masked[:, None],
                         _pick(tex, rows_mid[:, COL_C1].long()), c1)
    return {
        "kinds": meta.material_kinds,
        "mtype": rows[:, COL_TYPE].to(torch.int32),
        "c0": _pick(tex, rows[:, COL_C0].long()),
        "c1": c1,
        "f0": _pick(ftex, rows[:, COL_F0].long())[..., 0],
        "eta": rows[:, COL_ETA],
        "k": rows[:, COL_K],
        **mask,
    }
