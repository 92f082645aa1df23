"""goblin_tpu_torch's Blinn, mirror and mask materials against goblin_tpu's
on the CPU: eval / pdf / sample lane by lane, the conductor Fresnel, and
gather_material's flattening of a mask over its inner material.

Inputs are made with numpy from a seed and handed to both packages. The
flags (is_specular, is_null, valid) and the mask pick are equal on every
lane. Values are held to rtol 1e-5 / atol 1e-6, and Blinn's to rtol 2e-4:
its cosh ** e and u ** (1 / (e + 1)) go through pow, which XLA on the CPU
and PyTorch round differently, and e up to 200 multiplies the difference.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goblin_tpu.integrators.materials import gather_material as j_gather
from goblin_tpu.scene import loader as jloader
from goblin_tpu.shading import bsdf as jb
from goblin_tpu_torch.integrators.materials import gather_material as t_gather
from goblin_tpu_torch.scene import loader as tloader
from goblin_tpu_torch.shading import bsdf as tb

TOL = dict(rtol=1e-5, atol=1e-6)
POW_TOL = dict(rtol=2e-4, atol=1e-6)
KEYS = ("mtype", "c0", "c1", "f0", "eta", "k", "is_masked", "mask_alpha",
        "mask_u")
# name -> (material kinds on the lanes, masked share, conductor share)
CASES = {
    "blinn_dielectric": ((1,), 0.0, 0.0),
    "blinn_conductor": ((1,), 0.0, 1.0),
    "mirror": ((3,), 0.0, 1.0),
    "mask_over_lambert": ((0,), 0.7, 0.0),
    "mask_over_all": ((0, 1, 2, 3), 0.5, 0.5),
    "all_unmasked": ((0, 1, 2, 3), 0.0, 0.5),
}


def _t(a):
    return torch.as_tensor(np.array(a))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _unit(rng, n):
    v = rng.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _mats(rng, n, kinds, masked_share, conductor_share):
    """Flattened material lanes as gather_material makes them. The scene's
    kinds list the mask kind where any lane is masked."""
    mtype = rng.choice(np.asarray(kinds, np.int32), n).astype(np.int32)
    cols = {
        "mtype": mtype,
        "c0": rng.uniform(0, 1, (n, 3)).astype(np.float32),
        "c1": rng.uniform(0, 1, (n, 3)).astype(np.float32),
        "f0": rng.choice(np.float32([1.0, 10.0, 40.0, 200.0]), n),
        "eta": rng.uniform(0.5, 2.0, n).astype(np.float32),
        "k": np.where(rng.uniform(0, 1, n) < conductor_share,
                      rng.uniform(0.5, 6.0, n), -1.0).astype(np.float32),
        "is_masked": rng.uniform(0, 1, n) < masked_share,
        "mask_alpha": rng.choice(np.float32([0.0, 0.3, 0.5, 1.0]), n),
        "mask_u": rng.uniform(0, 1, n).astype(np.float32),
    }
    scene_kinds = tuple(sorted(set(kinds) | ({5} if masked_share else set())))
    jmat = {"kinds": scene_kinds, **{k: jnp.asarray(v) for k, v in cols.items()}}
    tmat = {"kinds": scene_kinds, **{k: _t(v) for k, v in cols.items()}}
    if not masked_share:  # a scene without masks carries none of their keys
        for k in ("is_masked", "mask_alpha", "mask_u"):
            del tmat[k]
    return jmat, tmat


def test_fresnel_conductor_matches():
    rng = np.random.default_rng(9)
    cosi = rng.uniform(0, 1, 10000).astype(np.float32)
    eta = rng.uniform(0.1, 3, 10000).astype(np.float32)
    k = rng.uniform(0.1, 7, 10000).astype(np.float32)
    np.testing.assert_allclose(
        _np(tb.fresnel_conductor(_t(cosi), _t(eta), _t(k))),
        np.asarray(jb.fresnel_conductor(jnp.asarray(cosi), jnp.asarray(eta),
                                        jnp.asarray(k))), **TOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_bsdf_eval_and_pdf_match(name):
    rng = np.random.default_rng(sum(map(ord, name)))
    n = 4096
    jmat, tmat = _mats(rng, n, *CASES[name])
    ns, wo, wi = (_unit(rng, n) for _ in range(3))
    wi[:256] = -wo[:256]  # wh = 0: the normalize guard
    J = [jnp.asarray(a) for a in (ns, wo, wi)]
    T = [_t(a) for a in (ns, wo, wi)]
    tol = POW_TOL if 1 in CASES[name][0] else TOL
    for mask in (tb.BSDF_ALL, tb.BSDF_ALL & ~tb.BSDF_GLOSSY,
                 tb.BSDF_ALL & ~tb.BSDF_SPECULAR):
        np.testing.assert_allclose(
            _np(tb.bsdf_eval(tmat, *T, mask)),
            np.asarray(jb.bsdf_eval(jmat, *J, mask)), **tol)
        np.testing.assert_allclose(
            _np(tb.bsdf_pdf(tmat, *T, mask)),
            np.asarray(jb.bsdf_pdf(jmat, *J, mask)), **tol)
    assert (_np(tb.bsdf_eval(tmat, *T, tb.BSDF_ALL)) > 0).any() == (
        CASES[name][0] != (3,))


@pytest.mark.parametrize("mode", [tb.MODE_RADIANCE, tb.MODE_IMPORTANCE])
@pytest.mark.parametrize("name", sorted(CASES))
def test_bsdf_sample_matches(name, mode):
    rng = np.random.default_rng(sum(map(ord, name)) + mode)
    n = 4096
    jmat, tmat = _mats(rng, n, *CASES[name])
    ns, wo, dpdu = (_unit(rng, n) for _ in range(3))
    dpdu[:64] = 0.0  # degenerate tangents take the coordinate_system frame
    u1, u2, uc = (rng.uniform(0, 1, n).astype(np.float32) for _ in range(3))
    tol = POW_TOL if 1 in CASES[name][0] else TOL
    masks = [tb.BSDF_ALL]
    if CASES[name][1]:
        masks += [tb.BSDF_NULL, tb.BSDF_ALL & ~tb.BSDF_NULL]
    for mask in masks:
        ref = jb.bsdf_sample(jmat, *(jnp.asarray(a) for a in
                                     (ns, dpdu, wo, u1, u2, uc)), mask,
                             mode=mode)
        got = tb.bsdf_sample(tmat, *(_t(a) for a in
                                     (ns, dpdu, wo, u1, u2, uc)), mask,
                             mode=mode)
        for k in ("is_specular", "is_null"):
            np.testing.assert_array_equal(_np(got[k]), np.asarray(ref[k]),
                                          err_msg=k)
        # a Blinn sample that grazes the horizon can flip validity
        valid_same = _np(got["valid"]) == np.asarray(ref["valid"])
        assert valid_same.mean() >= 0.999
        ok = valid_same & np.asarray(ref["valid"])
        for k in ("f", "wi", "pdf"):
            np.testing.assert_allclose(_np(got[k])[ok], np.asarray(ref[k])[ok],
                                       rtol=tol["rtol"], atol=1e-5, err_msg=k)
        if mask == tb.BSDF_ALL and CASES[name][1]:
            null = _np(got["is_null"])
            assert 0 < null.sum() < n
            # the punch-through continues straight on
            np.testing.assert_allclose(_np(got["wi"])[null], -wo[null],
                                       atol=1e-6)
    if CASES[name][0] == (3,):
        # the mirror reflects about the normal, on the front face only
        front = (ns * wo).sum(axis=-1) > 0
        assert (_np(got["valid"]) == front).all()
        refl = 2.0 * (ns * wo).sum(axis=-1, keepdims=True) * ns - wo
        np.testing.assert_allclose(_np(got["wi"])[front], refl[front],
                                   atol=1e-6)


MASK_SCENE = {
    "render_setting": {"sample_per_pixel": 1, "max_ray_depth": 3,
                       "render_method": "path_tracing"},
    "camera": {"position": [0, 0, -3], "fov": 60,
               "film": {"resolution": [4, 4]},
               "filter": {"type": "gaussian", "width": [2, 2]}},
    "geometries": [{"name": "quad", "type": "mesh", "file": "quad.obj"}],
    "textures": [
        {"format": "color", "name": "w", "type": "constant",
         "color": [0.8, 0.7, 0.6]},
        {"format": "color", "name": "tint", "type": "constant",
         "color": [0.9, 1.0, 0.5]},
        {"format": "float", "name": "a", "type": "constant", "float": 0.25},
        {"format": "float", "name": "e", "type": "constant", "float": 30.0}],
    "materials": [
        {"name": "m", "type": "lambert", "Kd": "w"},
        {"name": "b", "type": "blinn", "Kg": "tint", "exponent": "e",
         "index": 1.3, "k": 2.5},
        {"name": "veil", "type": "mask", "alpha": "a",
         "transparent_color": "tint", "material": "b"},
        {"name": "veil2", "type": "mask", "material": "m"},
        {"name": "mi", "type": "mirror"}],
    "lights": [{"type": "point", "intensity": [5, 5, 5],
                "position": [0, 0, -2]}],
    "primitives": [{"type": "model", "name": "q", "geometry": "quad",
                    "material": "veil"},
                   {"type": "instance", "name": "q", "model": "q"}],
}


def test_gather_material_flattens_masks(tmp_path, monkeypatch):
    """A lane on a mask carries its inner material's row, the mask's alpha
    and transparent colour and the u it was given; rows of both packages
    agree for every material id, the defaults of absent keys included."""
    (tmp_path / "quad.obj").write_text(
        "v -1 -1 0\nv 1 -1 0\nv 1 1 0\nv -1 1 0\nf 1 2 3\nf 1 3 4\n")
    path = tmp_path / "m.json"
    path.write_text(json.dumps(MASK_SCENE))
    monkeypatch.setenv("GOBLIN_TRACE", "pallas")
    js, jm = jloader.load_scene(str(path))
    ts, tm = tloader.load_scene(str(path), device="cpu")
    assert tm.has_null and tm.material_kinds == jm.material_kinds
    assert tm.n_materials == jm.n_materials == 7  # error, 5 named, black
    rng = np.random.default_rng(0)
    n = 700
    mat = (np.arange(n) % tm.n_materials).astype(np.int32)
    uv = rng.uniform(0, 1, (n, 2)).astype(np.float32)
    u = rng.uniform(0, 1, n).astype(np.float32)
    jfrag = {"mat": jnp.asarray(mat), "uv": jnp.asarray(uv),
             "p": jnp.zeros((n, 3)), "duv": jnp.zeros((n, 2)),
             "duv4": jnp.zeros((n, 4))}
    ref = j_gather(js, jm, jfrag, u_mask=jnp.asarray(u))
    got = t_gather(ts, tm, {"mat": _t(mat), "uv": _t(uv)}, u_mask=_t(u))
    assert got["kinds"] == ref["kinds"]
    for k in KEYS:
        np.testing.assert_array_equal(_np(got[k]), np.asarray(ref[k]),
                                      err_msg=k)
    veil = mat == 3
    assert _np(got["is_masked"])[veil].all()
    assert (_np(got["mtype"])[veil] == tb.MAT_BLINN).all()
    assert (_np(got["mask_alpha"])[veil] == 0.25).all()
    np.testing.assert_array_equal(_np(got["c1"])[veil][0],
                                  np.float32([0.9, 1.0, 0.5]))
    assert (_np(got["k"])[veil] == 2.5).all()
    # without u_mask the pick sample is zero: the inner lobe always
    assert not _np(t_gather(ts, tm, {"mat": _t(mat), "uv": _t(uv)})
                   ["mask_u"]).any()
