"""goblin_tpu_torch's light tracer against goblin_tpu's on the CPU: the
camera's importance side function by function, the film's normalized
splat, bsdf_eval in importance mode, the importance-mode light walk, the
contributions (x, y, c) of the three estimators lane by lane, whole renders
at 24 x 18, the mirrors of tests/test_lighttracer.py's point and area cases
and of tests/test_lens_t0.py's estimator cross-checks.
(examples/bunny_gallery.json under light_tracing: tests/test_torch_gallery.py.)

Same sample streams and the same tree in both packages. Camera values are
held to rtol 1e-5 (screen positions to 1e-3 of a pixel) with the validity
flags equal except within 1e-3 of a pixel of the film's edge; contributions
and images to PERF.md's image bar (>= 99% within 1e-4 + 1e-3 rel, means
within 1e-3 rel). The film scatter adds in another order in each package,
which that bar covers. Estimators are compared with one another to the
statistical tolerances goblin_tpu's own tests state.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goblin_tpu import splatting as jsplat
from goblin_tpu.camera import camera as jcam
from goblin_tpu.camera import film as jfilm
from goblin_tpu.shading import bsdf as jb
from goblin_tpu_torch import render as trender
from goblin_tpu_torch import splatting as tsplat
from goblin_tpu_torch.camera import camera as tcam
from goblin_tpu_torch.camera import film as tfilm
from goblin_tpu_torch.integrators import common as tcommon
from goblin_tpu_torch.ops import trace as ttrace
from goblin_tpu_torch.scene import loader as tloader
from goblin_tpu_torch.shading import bsdf as tb
from test_torch_materials import CASES, POW_TOL, TOL, _mats, _unit
from test_torch_studio import (PLANE_OBJ, STUDIO, _bar, _load_both, _np,
                               _resized)
from test_torch_textures import few_torch_threads  # noqa: F401


def _t(a):
    return torch.as_tensor(np.array(a))


# --- the camera's importance side -------------------------------------------

CAMERAS = {
    "pinhole": dict(position=(0.3, 1.5, -2.5),
                    orientation=(0.9848, 0.1736, 0.0, 0.0), fov=0.8),
    "thin_lens": dict(position=(1.77, 0.77, 0.83),
                      orientation=(0.352428, 0.114509, -0.883349, 0.287014),
                      fov=0.7, lens_radius=0.3, focal_distance=2.5),
    "orthographic": dict(kind="orthographic", position=(0.0, 2.0, -1.0),
                         orientation=(0.9659, 0.2588, 0.0, 0.0),
                         film_width=6.0),
}


def _cameras(name, crop=(0.0, 1.0, 0.0, 1.0)):
    kw = dict(x_res=40, y_res=30, crop=crop)
    jf = jfilm.FilmSpec(filter=jfilm.FilterSpec(x_width=2.0, y_width=1.5), **kw)
    tf = tfilm.FilmSpec(filter=tfilm.FilterSpec(x_width=2.0, y_width=1.5), **kw)
    return (jcam.CameraSpec(film=jf, **CAMERAS[name]),
            tcam.CameraSpec(film=tf, **CAMERAS[name]))


def _points_in_view(cam, rng, n):
    """World points scattered about the camera's axis, some behind it."""
    look, pos = np.asarray(cam.look), np.float32(cam.position)
    depth = rng.uniform(-1.0, 6.0, (n, 1))
    return (pos + depth * look + rng.normal(size=(n, 3)) * 1.2).astype(
        np.float32)


@pytest.mark.parametrize("name", sorted(CAMERAS))
def test_camera_host_quantities_match(name):
    jc, tc = _cameras(name)
    np.testing.assert_array_equal(tc.view, jc.view)
    np.testing.assert_array_equal(tc.look, jc.look)
    np.testing.assert_array_equal(tc.proj, jc.proj)
    assert tc.film_area == jc.film_area and tc.film_area > 0
    assert tc.pdf_position() == jc.pdf_position()
    assert (tc.pdf_position() > 0) == (name == "thin_lens")
    assert tc.film.sample_range() == jc.film.sample_range()
    jc2, tc2 = _cameras(name, crop=(0.25, 0.75, 0.1, 0.6))
    assert tc2.film.sample_range() == jc2.film.sample_range() == (8, 32, 2, 20)


@pytest.mark.parametrize("name", sorted(CAMERAS))
def test_world_to_screen_matches(name):
    jc, tc = _cameras(name)
    rng = np.random.default_rng(len(name))
    n = 4000
    p = _points_in_view(jc, rng, n)
    u1, u2 = rng.uniform(0, 1, (2, n)).astype(np.float32)
    jl = jc.sample_position(jnp.asarray(u1), jnp.asarray(u2))[0]
    tl = tc.sample_position(_t(u1), _t(u2))[0]
    lens_off = rng.uniform(0, 1, n) < 0.1  # lens points off the lens disk
    off = np.where(lens_off[:, None], np.asarray(jc.right) * 1.0, 0.0
                   ).astype(np.float32)
    for jlens, tlens in ((None, None), (jl + off, tl + _t(off))):
        ref = [np.asarray(v) for v in jc.world_to_screen(jnp.asarray(p), jlens)]
        got = [_np(v) for v in tc.world_to_screen(_t(p), tlens)]
        xs, xe, ys, ye = tc.film.sample_range()
        edge = np.minimum.reduce([abs(ref[0] - xs), abs(ref[0] - xe),
                                  abs(ref[1] - ys), abs(ref[1] - ye)]) < 1e-3
        settled = ~edge & (abs(ref[2]) > 1e-5)
        np.testing.assert_array_equal(got[3][settled], ref[3][settled])
        ok = ref[3] & got[3]
        assert 0.1 < ok.mean() < 0.9
        for k in range(3):
            np.testing.assert_allclose(got[k][ok], ref[k][ok], rtol=1e-5,
                                       atol=1e-3)
    if name == "thin_lens":
        assert not got[3][lens_off].any()


@pytest.mark.parametrize("name", ["pinhole", "thin_lens"])
def test_camera_sampling_and_importance_match(name):
    jc, tc = _cameras(name)
    rng = np.random.default_rng(7 + len(name))
    n = 4000
    u1, u2 = rng.uniform(0, 1, (2, n)).astype(np.float32)
    jp, jn, jpdf = jc.sample_position(jnp.asarray(u1), jnp.asarray(u2))
    tp, tn, tpdf = tc.sample_position(_t(u1), _t(u2))
    for a, b in ((tp, jp), (tn, jn), (tpdf, jpdf)):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-6, atol=1e-6)
    if name == "thin_lens":
        r = np.linalg.norm(_np(tp) - np.float32(tc.position), axis=-1)
        assert r.max() <= 0.3 + 1e-6 and r.std() > 0.01
        np.testing.assert_allclose(_np(tpdf), 1 / (np.pi * 0.09), rtol=1e-6)
    else:
        assert (_np(tp) == np.float32(tc.position)).all()
        assert (_np(tpdf) == 1.0).all()

    x = rng.uniform(0, 40, n).astype(np.float32)
    y = rng.uniform(0, 30, n).astype(np.float32)
    ref = jc.sample_direction(jnp.asarray(x), jnp.asarray(y), jp)
    got = tc.sample_direction(_t(x), _t(y), tp)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(_np(got[0]), axis=-1), 1.0,
                               atol=1e-5)
    assert (_np(got[1]) > 0).all() and (_np(got[2]) > 0).all()
    # the sampled direction lands on the film where it was aimed
    hit = _np(tp) + 3.0 * _np(got[0])
    sx, sy, _, valid = tc.world_to_screen(_t(hit), tp)
    assert bool(valid.all())
    np.testing.assert_allclose(_np(sx), x, atol=2e-3)
    np.testing.assert_allclose(_np(sy), y, atol=2e-3)

    p = _points_in_view(jc, rng, n)
    ref_we = np.asarray(jc.eval_we(jp, jnp.asarray(p)))
    got_we = _np(tc.eval_we(tp, _t(p)))
    same = (got_we > 0) == (ref_we > 0)
    assert same.mean() >= 0.999 and 0.1 < (got_we > 0).mean() < 0.9
    np.testing.assert_allclose(got_we[same], ref_we[same], rtol=1e-4)
    # We of a sampled direction is eval_we of a point along it
    np.testing.assert_allclose(_np(tc.eval_we(tp, _t(hit))), _np(got[1]),
                               rtol=1e-3)

    wo = _unit(rng, n)
    np.testing.assert_allclose(
        _np(tc.pdf_direction(_t(wo))),
        np.asarray(jc.pdf_direction(jnp.asarray(wo))), rtol=1e-5)


# --- the film's normalized splat --------------------------------------------

FILTER_KINDS = {"box": {}, "triangle": {}, "gaussian": {"falloff": 1.5},
                "mitchell": {"b": 1 / 3, "c": 1 / 3}}


@pytest.mark.parametrize("kind", sorted(FILTER_KINDS))
def test_normalized_splat_matches(kind):
    kw = dict(kind=kind, x_width=2.0, y_width=1.5, **FILTER_KINDS[kind])
    jspec = jfilm.FilmSpec(x_res=20, y_res=14, filter=jfilm.FilterSpec(**kw))
    tspec = tfilm.FilmSpec(x_res=20, y_res=14, filter=tfilm.FilterSpec(**kw))
    assert tspec.filter.normalize_term() == jspec.filter.normalize_term() > 0
    rng = np.random.default_rng(3)
    n = 600
    x = rng.uniform(-3, 23, n).astype(np.float32)
    y = rng.uniform(-3, 17, n).astype(np.float32)
    x[:20] = -1e9  # a connection that failed lands far off the film
    L = rng.uniform(0, 2, (n, 3)).astype(np.float32)
    L[20:24] = np.nan
    for normalized in (False, True):
        jc, jw = jfilm.splat(jspec, *jfilm.new_film(jspec), jnp.asarray(x),
                             jnp.asarray(y), jnp.asarray(L),
                             normalized=normalized)
        tcw = tfilm.splat(tspec, *tfilm.new_film(tspec, "cpu"), _t(x), _t(y),
                          _t(L), normalized=normalized)
        np.testing.assert_allclose(_np(tcw[0]), np.asarray(jc), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(_np(tcw[1]), np.asarray(jw), rtol=1e-5,
                                   atol=1e-6)
        assert np.isfinite(_np(tcw[0])).all() and _np(tcw[0]).sum() > 0
    raw = tfilm.to_image(*tcw, normalize=False)
    assert raw is tcw[0]
    np.testing.assert_allclose(
        _np(tfilm.to_image(*tcw)),
        np.asarray(jfilm.to_image(jc, jw)), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("kind", sorted(FILTER_KINDS))
def test_zero_taps_add_nothing_wherever_they_land(kind):
    """splat_taps spreads its zero-weight taps over the film; the film is
    bit for bit the one made with every zero tap added into pixel 0 (where
    clamping the index puts the taps of a sample sent off the film) or
    into the last pixel."""
    kw = dict(kind=kind, x_width=2.0, y_width=1.5, **FILTER_KINDS[kind])
    spec = tfilm.FilmSpec(x_res=20, y_res=14, filter=tfilm.FilterSpec(**kw))
    rng = np.random.default_rng(4)
    n = 600
    x = rng.uniform(-3, 23, n).astype(np.float32)
    y = rng.uniform(-3, 17, n).astype(np.float32)
    x[:200] = -1e9
    L = rng.uniform(0, 2, (n, 3)).astype(np.float32)
    L[200:204] = np.nan
    for normalized in (False, True):
        got = tfilm.splat(spec, *tfilm.new_film(spec, "cpu"), _t(x), _t(y),
                          _t(L), normalized=normalized)
        idx, w, wL = tfilm.splat_taps(spec, _t(x), _t(y), _t(L), normalized)
        zero = w == 0.0
        assert zero.any() and (~zero).any() and not wL[zero].any()
        for target in (0, spec.x_res * spec.y_res - 1):
            ref = tfilm.splat_accum(*tfilm.new_film(spec, "cpu"),
                                    torch.where(zero, target, idx), w, wL)
            assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


# --- the BSDF in importance mode --------------------------------------------

@pytest.mark.parametrize("name", sorted(CASES))
def test_bsdf_eval_in_importance_mode_matches(name):
    """Light tracing's connections evaluate the BSDF with
    mode=MODE_IMPORTANCE: every material kind, masked lanes included. The
    smooth lobes are symmetric, so the mode changes nothing."""
    rng = np.random.default_rng(sum(map(ord, name)) + 17)
    n = 4096
    jmat, tmat = _mats(rng, n, *CASES[name])
    ns, wo, wi = (_unit(rng, n) for _ in range(3))
    tol = POW_TOL if 1 in CASES[name][0] else TOL
    got = tb.bsdf_eval(tmat, _t(ns), _t(wo), _t(wi), tb.BSDF_ALL,
                       mode=tb.MODE_IMPORTANCE)
    ref = jb.bsdf_eval(jmat, jnp.asarray(ns), jnp.asarray(wo),
                       jnp.asarray(wi), jb.BSDF_ALL, mode=jb.MODE_IMPORTANCE)
    np.testing.assert_allclose(_np(got), np.asarray(ref), **tol)
    assert torch.equal(got, tb.bsdf_eval(tmat, _t(ns), _t(wo), _t(wi),
                                         tb.BSDF_ALL))


# --- the light walk and the contributions -----------------------------------

def _dof_scene(tmp_path, lens_radius=0.4, depth=3, res=(24, 18), light=None,
               **settings):
    """tests/test_lens_t0.py's scene (and, with lens_radius 0 and a light,
    tests/test_lighttracer.py's): a floor under a small quad light, seen by
    a camera with a lens disk."""
    cam = {"position": [0, 1.5, -2.5], "euler": [20, 0, 0],
           "rotation_order": "xyz", "fov": 45.0,
           "film": {"resolution": list(res)},
           "filter": {"type": "box", "width": [0.5, 0.5]}}
    if lens_radius:
        cam.update(lens_radius=lens_radius, focal_distance=3.0)
    doc = {
        "render_setting": {"render_method": "light_tracing",
                           "sample_per_pixel": 4, "max_ray_depth": depth,
                           **settings},
        "camera": cam,
        "geometries": [{"name": "floor", "type": "mesh", "file": "plane.obj"}],
        "textures": [{"format": "color", "name": "grey", "type": "constant",
                      "color": [0.7, 0.7, 0.7]}],
        "materials": [{"name": "diffuse", "type": "lambert", "Kd": "grey"}],
        "primitives": [{"type": "model", "name": "fm", "geometry": "floor",
                        "material": "diffuse"},
                       {"type": "instance", "name": "fi", "model": "fm",
                        "scale": [30, 30, 30]}],
        "lights": [light or {
            "name": "panel", "type": "area", "radiance": [30, 30, 30],
            "geometry": "floor", "position": [0.0, 2.5, 0.0],
            "euler": [180.0, 0.0, 0.0], "scale": [0.4, 0.4, 0.4]}],
    }
    (tmp_path / "plane.obj").write_text(PLANE_OBJ)
    path = tmp_path / "scene.json"
    path.write_text(json.dumps(doc))
    return str(path)


POINT_LIGHT = {"name": "key", "type": "point", "intensity": [12, 12, 12],
               "position": [0.5, 3.0, 0.0]}


@pytest.fixture(scope="module")
def studio():
    js, jm, ts, tm = _load_both(STUDIO, {"sample_per_pixel": 1})
    return js, _resized(jm, 32, 24), ts, _resized(tm, 32, 24)


def test_light_walk_defaults_to_importance_mode(studio):
    """walk_light_paths' default is goblin_tpu's: importance transport,
    which drops the eta^2 of a refraction (the radiance-mode walk against
    goblin_tpu: tests/test_torch_studio.py)."""
    js, jm, ts, tm = studio
    ids = np.arange(3000, dtype=np.int32)
    _, jv = jsplat.walk_light_paths(js, jm, jnp.asarray(ids), jnp.int32(1),
                                    2, 5)
    _, tv = tsplat.walk_light_paths(ts, tm, _t(ids), 1, 2, 5)
    both = np.asarray(jv["valid"]) & _np(tv["valid"])
    assert (np.asarray(jv["valid"]) != _np(tv["valid"])).mean() <= 2e-3
    a, b = _np(tv["tp"])[both], np.asarray(jv["tp"])[both]
    close = (np.abs(a - b) <= 1e-4 + 1e-3 * np.abs(b)).all(axis=-1)
    assert close.mean() >= 0.99
    _, rad = tsplat.walk_light_paths(ts, tm, _t(ids), 1, 2, 5,
                                     mode=tb.MODE_RADIANCE)
    assert np.abs(_np(tv["tp"]) - _np(rad["tp"])).max() > 1e-3


def _lanes_match(got, ref, min_live):
    """(x, y, c) of both packages: the live lanes (those not sent off the
    film) agree on >= 99.5% of lanes, and on the common ones x and y are
    within 1e-3 of a pixel and c within the image bar on >= 99%."""
    gx, gy, gc = (_np(v) for v in got)
    rx, ry, rc = (np.asarray(v) for v in ref)
    assert gx.shape == rx.shape and gc.shape == rc.shape
    glive, rlive = gx > -1e8, rx > -1e8
    assert (glive == rlive).mean() >= 0.995
    both = glive & rlive
    assert both.sum() >= min_live
    np.testing.assert_allclose(gx[both], rx[both], atol=1e-3)
    np.testing.assert_allclose(gy[both], ry[both], atol=1e-3)
    close = (np.abs(gc - rc) <= 1e-4 + 1e-3 * np.abs(rc)).all(axis=-1)
    assert close[both].mean() >= 0.99
    assert not gc[~glive].any()
    rel = abs(gc[both].sum() - rc[both].sum()) / rc[both].sum()
    assert rel <= 2e-3
    return both


def test_t1_contributions_match_on_the_studio_scene(studio):
    """Every connection of 4,000 light paths of the studio scene (three
    light kinds, glass, Blinn, mirror, the mask, a thin lens), depth 5:
    (1 + 4) x 4,000 lanes."""
    js, jm, ts, tm = studio
    ids = np.arange(4000, dtype=np.int32)
    ref = jsplat.light_trace_contributions(js, jm, jnp.asarray(ids),
                                           jnp.int32(0), 0, 5)
    got = tsplat.light_trace_contributions(ts, tm, _t(ids), 0, 0, 5)
    assert got[0].shape == (5 * 4000,)
    both = _lanes_match(got, ref, min_live=1000)
    per_vertex = both.reshape(5, 4000).sum(axis=1)
    assert (per_vertex > 0).all()  # the light vertex and all four bounces


@pytest.mark.parametrize("strategy", ["t1", "t0", "s1"])
def test_contributions_match_lane_by_lane(tmp_path, strategy):
    """The three estimators on tests/test_lens_t0.py's scene, 30,000
    paths, depth 3. Few paths find the lens, so t0's live lanes are few."""
    js, jm, ts, tm = _load_both(_dof_scene(tmp_path, lens_radius=0.5))
    ids = np.arange(30000, dtype=np.int32)
    name = {"t1": "light_trace_contributions",
            "t0": "light_trace_t0_contributions",
            "s1": "light_trace_s1_contributions"}[strategy]
    ref = getattr(jsplat, name)(js, jm, jnp.asarray(ids), jnp.int32(0), 4, 3)
    got = tsplat.LT_STRATEGIES[strategy](ts, tm, _t(ids), 0, 4, 3)
    n_conn = {"t1": 3, "t0": 2, "s1": 3}[strategy]
    assert got[0].shape == (n_conn * 30000,) and got[2].shape[1] == 3
    _lanes_match(got, ref, min_live=20 if strategy == "t0" else 5000)


def test_ended_lanes_are_not_traced(tmp_path, monkeypatch):
    """A lane whose walk ended, or whose connection cannot count, reaches
    the trace with mint = 3e38 and maxt = 0, which the kernels skip."""
    scene, meta = tloader.load_scene(_dof_scene(tmp_path), device="cpu")
    seen = []
    real = ttrace.trace

    def spy(scene, o, d, mint, maxt, **kw):
        dead = mint >= maxt
        assert bool(((mint[dead] == 3.0e38) & (maxt[dead] == 0.0)).all())
        seen.append((kw.get("any_hit", False), int((~dead).sum())))
        return real(scene, o, d, mint, maxt, **kw)

    import goblin_tpu_torch.scene.intersect as tscn
    monkeypatch.setattr(tscn, "trace", spy)
    ids = torch.arange(2000, dtype=torch.int32)
    tsplat.light_trace_contributions(scene, meta, ids, 0, 0, 3)
    # the walk's 2 closest-hit traces and 3 connections; later ones thin out
    assert [s[0] for s in seen] == [False, False, True, True, True]
    assert seen[0][1] == 2000 and seen[1][1] < seen[0][1]
    assert all(s[1] < 2000 for s in seen[2:]) and seen[3][1] > 0


# --- whole renders ----------------------------------------------------------

@pytest.mark.parametrize("light", ["area", "point"])
def test_light_tracer_render_matches_goblin_tpu(tmp_path, light):
    """24 x 18, 4 spp in chunks of 500 paths (the last chunk is whole too,
    and the scale counts it), with a lens and without."""
    if light == "point":
        path = _dof_scene(tmp_path, lens_radius=0, light=POINT_LIGHT, depth=2)
    else:
        path = _dof_scene(tmp_path)
    js, jm, ts, tm = _load_both(path)
    ref = np.asarray(jsplat.render_light_tracer(js, jm, chunk_size=500))
    got = tsplat.render_light_tracer(ts, tm, chunk_size=500).numpy()
    assert got.shape == ref.shape == (18, 24, 3) and np.isfinite(got).all()
    frac, rel = _bar(got, ref)
    assert frac >= 0.99 and rel <= 1e-3 and got.mean() > 0.01


def _floor_means(path, runs):
    """Mean of the image's floor half for each (strategy, spp) or "pt"."""
    scene, meta = tloader.load_scene(path, device="cpu")
    out = []
    for run in runs:
        if run == "pt":
            meta_pt = tloader.load_scene(
                path, {"render_method": "path_tracing"}, device="cpu")[1]
            img = tcommon.render(scene, meta_pt, trender.make_li(meta_pt),
                                 spp=16, chunk_size=512)
        else:
            img = tsplat.render_light_tracer(scene, meta, chunk_size=1 << 15,
                                             spp=run[1], strategy=run[0])
        out.append(img[9:, :, 0].numpy())
    return out


@pytest.mark.parametrize("light", ["point", "area"])
def test_lt_matches_pt(tmp_path, light):
    """tests/test_lighttracer.py's oracle: the light tracer and the path
    tracer converge to one image (means within 10% / 15%)."""
    if light == "point":
        path = _dof_scene(tmp_path, lens_radius=0, light=POINT_LIGHT, depth=2)
    else:
        path = _dof_scene(tmp_path, lens_radius=0)
    a, b = _floor_means(path, ["pt", ("t1", 600)])
    assert a.mean() > 0.01
    np.testing.assert_allclose(b.mean(), a.mean(),
                               rtol=0.1 if light == "point" else 0.15)
    if light == "point":
        assert np.corrcoef(a.reshape(-1), b.reshape(-1))[0, 1] > 0.7


def test_lt_t0_matches_t1(tmp_path):
    """tests/test_lens_t0.py:128: lens hits alone converge to t1's image
    (means within 30%)."""
    path = _dof_scene(tmp_path, lens_radius=0.5)
    a, b = _floor_means(path, [("t1", 400), ("t0", 4000)])
    assert a.mean() > 0.01 and b.mean() > 0.0
    np.testing.assert_allclose(b.mean(), a.mean(), rtol=0.3)


def test_lt_s1_matches_t1(tmp_path):
    """tests/test_lens_t0.py:144: the camera-walk estimator against t1
    (means within 20%)."""
    path = _dof_scene(tmp_path, lens_radius=0.2)
    a, b = _floor_means(path, [("t1", 400), ("s1", 400)])
    assert a.mean() > 0.01 and b.mean() > 0.01
    np.testing.assert_allclose(b.mean(), a.mean(), rtol=0.2)


def test_render_context_dispatches_light_tracing(tmp_path):
    """render_context -> render_dispatch -> render_light_tracer with the
    scene's lt_strategy, in chunks of 16,384 paths, reporting each."""
    path = _dof_scene(tmp_path, res=(64, 48), sample_per_pixel=6,
                      lt_strategy="s1")
    marks = []
    img, meta = trender.render_context(
        path, device="cpu", report=lambda done, total: marks.append(
            (done, total)))
    # 6 x 64 x 48 = 18,432 paths: two chunks
    assert marks == [(1, 2), (2, 2)] and meta.settings["lt_strategy"] == "s1"
    scene, _ = tloader.load_scene(path, device="cpu")
    want = tsplat.render_light_tracer(scene, meta, strategy="s1")
    assert torch.equal(img, want) and float(img.mean()) > 0.01
    t1 = tsplat.render_light_tracer(scene, meta, strategy="t1")
    assert not torch.equal(img, t1)
    with pytest.raises(KeyError):
        tsplat.render_light_tracer(scene, meta, strategy="t2")


def test_cli_renders_light_tracing_on_cpu(tmp_path):
    """light_tracing and bdpt, which the CLI refused until it was ported."""
    path = _dof_scene(tmp_path)
    for method in ("light_tracing", "bdpt"):
        assert trender.main([path, method, "--device", "cpu"]) == 0
        assert os.path.getsize(tmp_path / "scene.exr") > 0
