"""goblin_tpu_torch's subsurface scattering against goblin_tpu's on the CPU:
the mirrors of tests/test_bssrdf.py, the dipole and the albedo inversion,
subsurface_L lane by lane on the new scenes' camera fragments, the
subsurface material's surface lobe in both transport modes, the bake's
tables, and whole renders: Whitted on examples/bunny_fog.json, and the fog
scene under BDPT and SPPM, which see only the surface lobe and no volume
in both packages.

Bars: subsurface_L lane by lane within rtol 1e-4 / atol 1e-6 (exp, log and
sqrt of per-lane sigmas round differently in XLA and PyTorch); the lobe
within rtol 1e-5; images >= 99% of pixels within 1e-4 + 1e-3 rel, means
within 1e-3 rel.
"""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goblin_tpu import splatting as jsplat
from goblin_tpu.integrators import bdpt as jbdpt
from goblin_tpu.integrators import bssrdf as jss
from goblin_tpu.integrators import sppm as jsppm
from goblin_tpu.integrators import volume as jv
from goblin_tpu.integrators.path import make_li as j_path_li
from goblin_tpu.integrators.whitted import make_li as j_whitted_li
from goblin_tpu.scene import intersect as jscn
from goblin_tpu.shading import bsdf as jb
from goblin_tpu.shading import bssrdf as jbss
from goblin_tpu_torch import splatting as tsplat
from goblin_tpu_torch.integrators import bdpt as tbdpt
from goblin_tpu_torch.integrators import bssrdf as tss
from goblin_tpu_torch.integrators import common as tcommon
from goblin_tpu_torch.integrators import sppm as tsppm
from goblin_tpu_torch.integrators import volume as tv
from goblin_tpu_torch.integrators.path import make_li as t_path_li
from goblin_tpu_torch.integrators.whitted import make_li as t_whitted_li
from goblin_tpu_torch.scene import intersect as tscn
from goblin_tpu_torch.shading import bsdf as tb
from goblin_tpu_torch.shading import bssrdf as tbss
from test_torch_materials import _mats, _unit
from test_torch_studio import PLANE_OBJ, _bar, _load_both, _np
from test_torch_textures import (_camera_rays,  # noqa: F401
                                 few_torch_threads, jax_render_unjitted)
from test_torch_volume import fog, light_gap_in_goblin_tpu, smoke  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-6)


def _t(a):
    return torch.as_tensor(np.array(a))


def test_fdr_continuity_and_range():
    """The polynomial's branches meet near eta = 1 and give a sane
    reflectivity; the port's values are goblin_tpu's."""
    assert abs(tbss.fdr(1.0001) - tbss.fdr(0.9999)) < 0.02
    assert 0.0 < tbss.fdr(1.5) < 1.0
    for eta in (0.5, 0.8, 0.9999, 1.0, 1.3, 1.5, 2.4):
        assert tbss.fdr(eta) == jbss.fdr(eta)
        assert tbss.fresnel_a(eta) == jbss.fresnel_a(eta)


def test_convert_from_diffuse_roundtrip():
    """The bisection inverts diffuse_reflectance: the converted sigmas give
    back the albedo and sigma_tr = 1 / mean free path; equal to
    goblin_tpu's bit for bit."""
    A = tbss.fresnel_a(1.5)
    kd = np.array([0.2, 0.5, 0.8])
    mfp = np.array([1.0, 0.5, 2.0])
    sa, ssp = tbss.convert_from_diffuse(kd, mfp, A)
    assert (sa > 0).all() and (ssp > 0).all()
    np.testing.assert_allclose(
        tbss.diffuse_reflectance(ssp / (sa + ssp), A), kd, atol=1e-3)
    np.testing.assert_allclose(np.sqrt(3.0 * sa * (sa + ssp)), 1.0 / mfp,
                               rtol=1e-3)
    jsa, jssp = jbss.convert_from_diffuse(kd, mfp, A)
    np.testing.assert_array_equal(sa, jsa)
    np.testing.assert_array_equal(ssp, jssp)


def test_rd_dipole_formula():
    """rd_dipole against a numpy transcription of the Donner 06 dipole, and
    lane by lane against goblin_tpu's on random media and distances."""
    sa = np.array([[0.0021, 0.0041, 0.0071]], np.float32)
    ssp = np.array([[2.19, 2.62, 3.00]], np.float32)
    A = np.array([tbss.fresnel_a(1.5)], np.float32)
    for d in (0.01, 0.1, 0.5):
        got = _np(tbss.rd_dipole(_t(sa), _t(ssp), _t(A), _t([d * d])))
        stp = sa + ssp
        str_ = np.sqrt(3 * sa * stp)
        zr = 1.0 / stp
        zv = zr * (1 + 4.0 / 3.0 * A[0])
        dr = np.sqrt(zr ** 2 + d * d)
        dv = np.sqrt(zv ** 2 + d * d)
        want = (ssp / stp) / (4 * np.pi) * (
            zr * (1 + str_ * dr) * np.exp(-str_ * dr) / dr ** 3
            + zv * (1 + str_ * dv) * np.exp(-str_ * dv) / dv ** 3)
        np.testing.assert_allclose(got, want, rtol=1e-4)
    r = _np(tbss.rd_dipole(_t(sa), _t(ssp), _t(A), _t([0.01])))
    r2 = _np(tbss.rd_dipole(_t(sa), _t(ssp), _t(A), _t([1.0])))
    assert (r > r2).all()
    rng = np.random.default_rng(2)
    n = 5000
    sa = rng.uniform(0.001, 20, (n, 3)).astype(np.float32)
    ssp = rng.uniform(0.5, 3000, (n, 3)).astype(np.float32)
    A = rng.uniform(1.0, 4.0, n).astype(np.float32)
    d2 = rng.uniform(0, 0.3, n).astype(np.float32) ** 2
    np.testing.assert_allclose(
        _np(tbss.rd_dipole(*(_t(a) for a in (sa, ssp, A, d2)))),
        np.asarray(jbss.rd_dipole(*(jnp.asarray(a) for a in (sa, ssp, A, d2)))),
        rtol=1e-4, atol=1e-12)


def _ss_scene(tmp_path, method="path_tracing", extra=None):
    doc = {
        "render_setting": {"render_method": method, "sample_per_pixel": 1,
                           "max_ray_depth": 2, "bssrdf_sample_num": 2},
        "camera": {"position": [0, 0, -3.0], "fov": 45.0,
                   "film": {"resolution": [24, 16]},
                   "filter": {"type": "box", "width": [0.5, 0.5]}},
        "geometries": [{"name": "blob", "type": "sphere", "radius": 1.0}],
        "textures": [],
        "materials": [{"name": "marble", "type": "subsurface", "index": 1.5}],
        "primitives": [
            {"type": "model", "name": "bm", "geometry": "blob",
             "material": "marble"},
            {"type": "instance", "name": "bi", "model": "bm"}],
        "lights": [{"name": "key", "type": "point", "intensity": [40, 40, 40],
                    "position": [2, 2, -3]}],
    }
    for key, value in (extra or {}).items():
        doc[key] = doc[key] + value if isinstance(value, list) else value
    (tmp_path / "plane.obj").write_text(PLANE_OBJ)
    p = tmp_path / "scene.json"
    p.write_text(json.dumps(doc))
    return str(p)


@pytest.mark.parametrize("method", ["path_tracing", "whitted"])
def test_subsurface_sphere_renders(tmp_path, method):
    """tests/test_bssrdf.py's marble sphere under a point light: finite,
    non-zero radiance through the BSSRDF (the surface lobe alone is a
    specular reflector, black nearly everywhere), the image goblin_tpu's."""
    js, jm, ts, tm = _load_both(_ss_scene(tmp_path, method))
    assert tm.has_bssrdf and jm.has_bssrdf
    li = (j_path_li if method == "path_tracing" else j_whitted_li)(jm)
    ref = jax_render_unjitted(js, jm, li)
    got = tcommon.render(ts, tm, (t_path_li if method == "path_tracing"
                                  else t_whitted_li)(tm)).numpy()
    assert np.isfinite(got).all()
    c = got[4:12, 8:16]
    assert c.mean() > 1e-4, f"no subsurface contribution: mean={c.mean()}"
    frac, rel = _bar(got, ref)
    assert frac >= 0.99 and rel <= 1e-3


def _fragments(both):
    js, jm, ts, tm = both
    jray, jids, tray, tids = _camera_rays(jm, tm)
    jf = jscn.intersect(js, jm, jray["o"], jray["d"], jray["mint"],
                        jray["maxt"])
    tf = tscn.intersect(ts, tm, tray["o"], tray["d"], tray["mint"],
                        tray["maxt"])
    return jf, jids, tf, tids


@pytest.mark.parametrize("which", ["fog", "smoke"])
def test_subsurface_L_matches(request, which):
    """subsurface_L at the camera hits of the 24 x 18 frame, lane by lane:
    the jade bunny (Kd and mean free path) and the marble one (the defaults
    arm, sigmas named by constant textures); at bounce 0 as PT calls it and
    at a Whitted node's tag."""
    js, jm, ts, tm = request.getfixturevalue(which)
    jf, jids, tf, tids = _fragments(request.getfixturevalue(which))
    for bounce in (0, 0x101):
        ref = np.asarray(jss.subsurface_L(js, jm, jf, jf["hit"], jids, 0, 0,
                                          bounce=bounce))
        got = _np(tss.subsurface_L(ts, tm, tf, tf["hit"], tids, 0, 0,
                                   bounce=bounce))
        np.testing.assert_allclose(got, ref, **TOL)
        ss = _np(ts["mat_rows"])[_np(tf["mat"]), 0] == tb.MAT_SUBSURFACE
        assert ss.sum() > 10 and (got[ss] > 0).any(axis=-1).mean() > 0.5
        assert not got[~ss].any()


LOBE_CASES = {"subsurface": ((4,), 0.0), "subsurface_and_glass": ((2, 4), 0.0),
              "mask_over_subsurface": ((0, 4), 0.5)}


@pytest.mark.parametrize("mode", [tb.MODE_RADIANCE, tb.MODE_IMPORTANCE])
@pytest.mark.parametrize("name", sorted(LOBE_CASES))
def test_subsurface_lobe_matches(name, mode):
    """The surface lobe: the dielectric's specular reflection only (F / cos,
    wi mirrored about the facing normal, pdf 1), in sample, f and pdf, in
    both transport modes, alone, beside glass and under a mask."""
    kinds, masked = LOBE_CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)) + mode)
    n = 4096
    jmat, tmat = _mats(rng, n, kinds, masked, 0.0)
    ns, wo, dpdu, wi = (_unit(rng, n) for _ in range(4))
    u1, u2, uc = (rng.uniform(0, 1, n).astype(np.float32) for _ in range(3))
    masks = [tb.BSDF_ALL, tb.BSDF_SPECULAR | tb.BSDF_REFLECTION,
             tb.BSDF_ALL & ~tb.BSDF_SPECULAR]
    for mask in masks:
        ref = jb.bsdf_sample(jmat, *(jnp.asarray(a) for a in
                                     (ns, dpdu, wo, u1, u2, uc)), mask,
                             mode=mode)
        got = tb.bsdf_sample(tmat, *(_t(a) for a in
                                     (ns, dpdu, wo, u1, u2, uc)), mask,
                             mode=mode)
        for k in ("is_specular", "is_null", "valid"):
            np.testing.assert_array_equal(_np(got[k]), np.asarray(ref[k]),
                                          err_msg=k)
        ok = np.asarray(ref["valid"])
        for k in ("f", "wi", "pdf"):
            np.testing.assert_allclose(_np(got[k])[ok], np.asarray(ref[k])[ok],
                                       rtol=1e-5, atol=1e-6, err_msg=k)
        for fn in ("bsdf_eval", "bsdf_pdf"):
            np.testing.assert_allclose(
                _np(getattr(tb, fn)(tmat, *(_t(a) for a in (ns, wo, wi)),
                                    mask)),
                np.asarray(getattr(jb, fn)(jmat, *(jnp.asarray(a) for a in
                                                   (ns, wo, wi)), mask)),
                rtol=1e-5, atol=1e-6)
    # the subsurface lanes reflect about the facing normal with F / cos
    got = tb.bsdf_sample(tmat, *(_t(a) for a in (ns, dpdu, wo, u1, u2, uc)),
                         tb.BSDF_ALL, mode=mode)
    ss = (_np(tmat["mtype"]) == tb.MAT_SUBSURFACE) & ~_np(got["is_null"])
    cos = (ns * wo).sum(-1, keepdims=True)
    refl = 2.0 * np.abs(cos) * np.where(cos > 0, ns, -ns) - wo
    np.testing.assert_allclose(_np(got["wi"])[ss], refl[ss], atol=1e-5)
    assert _np(got["is_specular"])[ss].all()


def test_bake_tables_match(fog, smoke, tmp_path):
    """mat_sigma_a, mat_sigma_sp, mat_ss_g, mat_ss_A and has_bssrdf equal
    goblin_tpu's on both scenes (the Kd arm, the defaults arm with texture
    names) and on the marble sphere (the defaults themselves)."""
    scenes = [fog, smoke, _load_both(_ss_scene(tmp_path))]
    for js, jm, ts, tm in scenes:
        assert tm.has_bssrdf and jm.has_bssrdf
        assert tm.settings["bssrdf_sample_num"] == jm.settings[
            "bssrdf_sample_num"]
        for k in ("mat_sigma_a", "mat_sigma_sp", "mat_ss_g", "mat_ss_A"):
            np.testing.assert_array_equal(_np(ts[k]), np.asarray(js[k]),
                                          err_msg=k)
    ts = scenes[2][2]
    np.testing.assert_allclose(_np(ts["mat_sigma_a"])[1],
                               [0.0021, 0.0041, 0.0071], rtol=1e-6)
    np.testing.assert_allclose(_np(ts["mat_sigma_sp"])[1], [2.19, 2.62, 3.0],
                               rtol=1e-6)
    np.testing.assert_allclose(_np(smoke[2]["mat_sigma_sp"]).max(0),
                               [2190, 2620, 3000])


def _both_renders(both, overrides, render_j, render_t):
    js, jm, ts, tm = both
    jm = dataclasses.replace(jm, settings=dict(jm.settings, **overrides))
    tm = dataclasses.replace(tm, settings=dict(tm.settings, **overrides))
    return render_t(ts, tm), render_j(js, jm)


def test_fog_whitted_matches_goblin_tpu(fog):
    """24 x 18, depth 2: the BSSRDF term at each of the tree's nodes (the
    jade lobe reflects), keyed by the node's tag; the volume is not
    applied."""
    got, ref = _both_renders(
        fog, {"max_ray_depth": 2},
        lambda js, jm: jax_render_unjitted(js, jm, j_whitted_li(jm)),
        lambda ts, tm: tcommon.render(ts, tm, t_whitted_li(tm)).numpy())
    assert got.shape == ref.shape == (18, 24, 3) and np.isfinite(got).all()
    frac, rel = _bar(got, ref)
    assert frac >= 0.99 and rel <= 1e-3 and got.mean() > 0.05


@pytest.mark.parametrize("method", ["bdpt", "sppm", "light_tracing"])
def test_fog_splatting_methods_match_goblin_tpu(fog, method):
    """The fog scene under BDPT (depth 2), SPPM (1 iteration, depth 2) and
    light tracing (depth 2), 24 x 18: both packages ignore the volume and
    see the jade material's surface lobe alone."""
    if method == "light_tracing":
        got, ref = _both_renders(
            fog, {"max_ray_depth": 2},
            lambda js, jm: np.asarray(jsplat.render_light_tracer(
                js, jm, chunk_size=256)),
            lambda ts, tm: tsplat.render_light_tracer(
                ts, tm, chunk_size=256).numpy())
    elif method == "bdpt":
        got, ref = _both_renders(
            fog, {"max_ray_depth": 2},
            lambda js, jm: np.asarray(jbdpt.render_bdpt(js, jm,
                                                        chunk_size=512)),
            lambda ts, tm: tbdpt.render_bdpt(ts, tm, chunk_size=512).numpy())
    else:
        got, ref = _both_renders(
            fog, {"max_ray_depth": 2, "sample_per_pixel": 1,
                  "initial_radius": 0.05},
            lambda js, jm: np.asarray(jsppm.render_sppm(js, jm)),
            lambda ts, tm: tsppm.render_sppm(ts, tm).numpy())
    assert got.shape == ref.shape == (18, 24, 3) and np.isfinite(got).all()
    frac, rel = _bar(got, ref)
    assert frac >= 0.99 and rel <= 1e-3 and got.mean() > 0


def test_shadow_rays_take_a_mask_as_opaque(tmp_path):
    """In both packages the BSSRDF's and the volume's shadow rays take the
    plain occluded(): a mask of alpha 0 (which a path tracer's shadow ray
    passes untouched) between the light and the marble sphere blocks them.
    Its lanes' subsurface_L and in-scatter are zero with the mask and not
    without, equal in both packages."""
    mask = {"textures": [{"format": "float", "name": "zero",
                          "type": "constant", "float": 0.0},
                         {"format": "color", "name": "w", "type": "constant",
                          "color": [1, 1, 1]}],
            "materials": [{"name": "w", "type": "lambert", "Kd": "w"},
                          {"name": "hole", "type": "mask", "alpha": "zero",
                           "transparent_color": "w", "material": "w"}],
            "geometries": [{"name": "panel", "type": "mesh",
                            "file": "plane.obj"}],
            "primitives": [{"type": "model", "name": "pm",
                            "geometry": "panel", "material": "hole"},
                           {"type": "instance", "name": "pi", "model": "pm",
                            "position": [0, 1.6, 0], "scale": [6, 6, 6]}],
            "lights": [],
            "volume": {"type": "homogeneous", "box_min": [-3, -3, -3.5],
                       "box_max": [3, 1.5, 3], "attenuation": [0.3, 0.3, 0.3],
                       "albedo": [0.9, 0.9, 0.9]}}
    light = {"lights": [{"name": "top", "type": "point",
                         "intensity": [40, 40, 40], "position": [0, 3, 0]}]}
    results = {}
    for name, extra in (("open", dict(mask, primitives=[])),
                        ("masked", mask)):
        out = tmp_path / name
        out.mkdir()
        extra = dict(extra, lights=light["lights"])
        js, jm, ts, tm = _load_both(_ss_scene(out, extra=extra))
        jf, jids, tf, tids = _fragments((js, jm, ts, tm))
        ss = (np.asarray(jss.subsurface_L(js, jm, jf, jf["hit"], jids, 0, 0)),
              _np(tss.subsurface_L(ts, tm, tf, tf["hit"], tids, 0, 0)))
        jray, _, tray, _ = _camera_rays(jm, tm)
        jmax = jnp.minimum(jf["t"], 3.0e37)
        tmax = torch.clamp(tf["t"], max=3.0e37)
        with light_gap_in_goblin_tpu():
            lv = (np.asarray(jv.eval_lv(js, jm, jm.volume, jray["o"],
                                        jray["d"], jray["mint"], jmax, jids,
                                        0, 0)),
                  _np(tv.eval_lv(ts, tm, tm.volume, tray["o"], tray["d"],
                                 tray["mint"], tmax, tids, 0, 0)))
        for a, b in (ss, lv):
            np.testing.assert_allclose(b, a, **TOL)
        results[name] = (ss[1], lv[1])
    assert results["open"][0].mean() > 1e-4 and results["open"][1].mean() > 0
    assert not results["masked"][0].any()
    assert not results["masked"][1].any()


def test_whitted_launches_a_chunk(fog, monkeypatch):
    """Whitted on the fog scene at depth 3: no transparent material, so a
    node has a reflection child only and the tree is 4 nodes deep; each
    node is the trace that made it, the BSSRDF's 4 trace calls for each of
    4 samples, and for each of the 3 lights 4 punch-through rounds and a
    BSDF-side intersect."""
    from test_torch_volume import _count_traces
    _, _, ts, tm = fog
    tm = dataclasses.replace(tm, settings=dict(tm.settings, max_ray_depth=3))
    seen = _count_traces(monkeypatch)
    tcommon.render(ts, tm, t_whitted_li(tm))
    per_node = 1 + 4 * 4 + 3 * (4 + 1)
    assert len(seen) == 4 * per_node
