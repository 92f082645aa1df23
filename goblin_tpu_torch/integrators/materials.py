"""Per-lane material resolution: a row gather of the material table plus
texture lookups (port of goblin_tpu/integrators/materials.py)."""

from __future__ import annotations

import torch

# columns of scene["mat_rows"] (goblin_tpu's _pack_mat_rows order, with the
# integer columns stored as float values instead of bit patterns)
COL_TYPE, COL_C0, COL_C1, COL_F0, COL_F1, COL_ETA, COL_K, COL_INNER = range(8)


def _pick(stack, ids):
    """stack (X, R, C) selected per lane by ids (R,) -> (R, C)."""
    return stack[ids, torch.arange(ids.shape[0], device=ids.device)]


def gather_material(scene, meta, frag):
    """Per-lane material parameters for bsdf_eval / bsdf_pdf / bsdf_sample:
    mtype (R,) i32, c0 / c1 (R, 3), eta (R,), and the scene's material
    kinds for the BSDF's branch pruning."""
    rows = scene["mat_rows"][frag["mat"]]  # (R, 8)
    tex = meta.texture_system.eval_all(frag["uv"], scene["tex_const"])
    return {
        "kinds": meta.material_kinds,
        "mtype": rows[:, COL_TYPE].to(torch.int32),
        "c0": _pick(tex, rows[:, COL_C0].long()),
        "c1": _pick(tex, rows[:, COL_C1].long()),
        "eta": rows[:, COL_ETA],
    }
