"""goblin_tpu_torch's BDPT against goblin_tpu's on the CPU: both walks with
every stored field, every (s, t) strategy's contributions lane by lane
with and without MIS (tests/test_bdpt.py's plane under its area and point
lights, tests/test_lens_t0.py's thin-lens scene for t = 0, a floor under
a sky map for the environment's virtual vertex), renders at 24 x 18 to
32 x 24 of those scenes and of the studio scene, the port-only mirrors of
goblin_tpu's estimator checks, BDPT and PT parting under a mask disk in
both packages, the dead lanes and the trace launches of a chunk, and the
dispatch. (BDPT on the map-lit scenes and on
examples/bunny_sky.json: tests/test_torch_envmap.py.)

Same sample streams and the same tree in both packages. goblin_tpu's
bdpt_contributions runs op by op; its render_bdpt is its own jitted one
(20-35 s of XLA compile a scene at depth 2-3). The MIS chain multiplies
pdf ratios whose squares can overflow float32 to inf (a weight of 0) in
either package, so contributions are held to PERF.md's image bar on >= 99%
of the lanes that count in both (>= 99.5% of lanes agree on counting),
and screen positions within 1e-3 of a pixel. Renders to the image bar
(>= 99% of pixels within 1e-4 + 1e-3 rel, means within 1e-3 rel).
Estimators against one another at goblin_tpu's own statistical tolerances.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goblin_tpu.integrators import bdpt as jbdpt
from goblin_tpu.integrators import common as jcommon
from goblin_tpu.integrators.path import make_li as j_make_li
from goblin_tpu.io.exr import write_exr as j_write_exr
from goblin_tpu.shading import bsdf as jb
from goblin_tpu_torch import render as trender
from goblin_tpu_torch import splatting as tsplat
from goblin_tpu_torch.integrators import bdpt as tbdpt
from goblin_tpu_torch.integrators import common as tcommon
from goblin_tpu_torch.ops import trace as ttrace
from goblin_tpu_torch.scene import loader as tloader
from goblin_tpu_torch.shading import bsdf as tb
from test_torch_studio import (PLANE_OBJ, STUDIO, _bar, _load_both, _np,
                               _resized)
from test_torch_textures import few_torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SKY = os.path.join(REPO, "examples", "bunny_sky.json")

# tests/test_bdpt.py's lights
AREA_LIGHT = {"name": "panel", "type": "area", "radiance": [25, 25, 25],
              "geometry": "floor", "position": [0.0, 2.2, 0.2],
              "euler": [180.0, 0.0, 0.0], "scale": [0.35, 0.35, 0.35]}
POINT_LIGHT = {"name": "key", "type": "point", "intensity": [10, 10, 10],
               "position": [0.6, 2.5, -0.3]}


def _t(a):
    return torch.as_tensor(np.array(a))


def _scene(tmp_path, lights, spp=4, depth=3, res=(20, 16), cam=None,
           **settings):
    """tests/test_bdpt.py's floor (tests/test_lens_t0.py's with a lens)."""
    camera = {"position": [0, 1.4, -2.4], "euler": [20, 0, 0],
              "rotation_order": "xyz", "fov": 48.0,
              "film": {"resolution": list(res)},
              "filter": {"type": "box", "width": [0.5, 0.5]}}
    camera.update(cam or {})
    doc = {
        "render_setting": {"render_method": "bdpt", "sample_per_pixel": spp,
                           "max_ray_depth": depth, **settings},
        "camera": camera,
        "geometries": [{"name": "floor", "type": "mesh", "file": "plane.obj"}],
        "textures": [{"format": "color", "name": "grey", "type": "constant",
                      "color": [0.65, 0.65, 0.65]}],
        "materials": [{"name": "diffuse", "type": "lambert", "Kd": "grey"}],
        "primitives": [{"type": "model", "name": "fm", "geometry": "floor",
                        "material": "diffuse"},
                       {"type": "instance", "name": "fi", "model": "fm",
                        "scale": [30, 30, 30]}],
        "lights": lights,
    }
    (tmp_path / "plane.obj").write_text(PLANE_OBJ)
    path = tmp_path / "scene.json"
    path.write_text(json.dumps(doc))
    return str(path)


LENS = {"position": [0, 1.5, -2.5], "fov": 45.0, "lens_radius": 0.4,
        "focal_distance": 3.0}
LENS_LIGHT = {"name": "panel", "type": "area", "radiance": [30, 30, 30],
              "geometry": "floor", "position": [0.0, 2.5, 0.0],
              "euler": [180.0, 0.0, 0.0], "scale": [0.4, 0.4, 0.4]}


def _sky_scene(tmp_path, **kw):
    """The floor under tests/test_lighttracer.py:96's smooth sky map."""
    h, w = 16, 32
    ys = np.linspace(0, np.pi, h)[:, None]
    img = np.stack([0.6 + 0.4 * np.cos(ys) * np.ones((h, w)),
                    0.5 + 0.3 * np.cos(ys) * np.ones((h, w)),
                    0.8 * np.ones((h, w))], axis=-1).astype(np.float32)
    j_write_exr(str(tmp_path / "sky.exr"), img)
    return _scene(tmp_path, [{"name": "sky", "type": "ibl",
                              "file": "sky.exr"}], **kw)


SCENES = {
    "area": lambda p: _scene(p, [AREA_LIGHT]),
    "point": lambda p: _scene(p, [POINT_LIGHT]),
    "lens": lambda p: _scene(p, [LENS_LIGHT], cam=LENS, res=(24, 18)),
    "sky": lambda p: _sky_scene(p),
}


def _strategies(max_len, lens):
    """(s, t) in bdpt_contributions' order."""
    out = []
    for length in range(1, max_len + 1):
        for s in range(0, length + 2):
            t = length + 1 - s
            if (s == 0 and t < 2) or (t == 0 and s < 2) or (t == 0 and not lens):
                continue
            out.append((s, t))
    return out


def _block_match(got, ref):
    """One strategy's (x, y, c) of both packages -> lanes counting in
    both. A lane may count in one package alone only with a contribution
    below 1e-10: a connection that grazes a plane (G ~ 0), whose
    visibility and cosines rounding decides."""
    gx, gy, gc = got
    rx, ry, rc = ref
    glive, rlive = gx > -1e8, rx > -1e8
    tiny = np.maximum(np.abs(gc), np.abs(rc)).max(axis=-1) <= 1e-10
    assert ((glive != rlive) & ~tiny).mean() <= 0.005
    both = glive & rlive
    np.testing.assert_allclose(gx[both], rx[both], atol=1e-3)
    np.testing.assert_allclose(gy[both], ry[both], atol=1e-3)
    close = (np.abs(gc - rc) <= 1e-4 + 1e-3 * np.abs(rc)).all(axis=-1)
    assert not both.any() or close[both].mean() >= 0.99
    assert not gc[~glive].any() and np.isfinite(gc).all()
    return both


@pytest.mark.parametrize("case", ["area", "area-no_mis", "point", "lens",
                                  "sky"])
def test_contributions_match_for_every_strategy(tmp_path, case):
    """2,000 camera samples at depth 3 through both packages' whole
    bdpt_contributions, compared strategy by strategy; and every (s, t)
    that debug_s / debug_t isolate in the port is its block of the whole,
    bit for bit."""
    name, _, mode = case.partition("-")
    no_mis = mode == "no_mis"
    js, jm, ts, tm = _load_both(SCENES[name](tmp_path))
    ids = np.arange(2000, dtype=np.int32)
    ref = jbdpt.bdpt_contributions(js, jm, jnp.asarray(ids), jnp.int32(1), 3,
                                   3, debug_no_mis=no_mis)
    got = tbdpt.bdpt_contributions(ts, tm, _t(ids), 1, 3, 3,
                                   debug_no_mis=no_mis)
    strategies = _strategies(3, name == "lens")
    assert got[0].shape == (len(strategies) * 2000,)
    live = {}
    for k, st in enumerate(strategies):
        sl = slice(k * 2000, (k + 1) * 2000)
        live[st] = _block_match([_np(v)[sl] for v in got],
                                [np.asarray(v)[sl] for v in ref]).sum()
        one = tbdpt.bdpt_contributions(ts, tm, _t(ids), 1, 3, 3,
                                       debug_s=st[0], debug_t=st[1],
                                       debug_no_mis=no_mis)
        for a, b in zip(one, got):
            assert torch.equal(a, b[sl]), st
    # the strategies that must find light on each scene do
    must = {"area": [(0, 3), (1, 2), (2, 1)],
            "point": [(1, 2), (2, 1)],
            "lens": [(0, 3), (1, 2), (2, 1), (3, 0)],
            "sky": [(0, 2), (1, 2), (0, 3)]}[name]
    assert all(live[st] > 0 for st in must), live
    if name == "point":  # an eye path cannot hit a delta light
        assert live[0, 2] == live[0, 3] == 0


def test_strategy_filters_can_exclude_every_strategy(tmp_path):
    ts, tm = tloader.load_scene(SCENES["area"](tmp_path), device="cpu")
    x, y, c = tbdpt.bdpt_contributions(ts, tm, torch.arange(50,
                                       dtype=torch.int32), 0, 0, 3, debug_s=9)
    assert x.shape == (50,) and (x == -1e9).all() and not c.any()


def _fields_match(got, ref, light_walk):
    valid_g, valid_r = _np(got["valid"]), np.asarray(ref["valid"])
    assert (valid_g == valid_r).mean() >= 0.998
    both = valid_g & valid_r
    assert both[0].mean() > 0.3 and both[-1].any()
    for k in ("mat", "light", "is_env", "is_lens"):
        assert (_np(got[k])[both] == np.asarray(ref[k])[both]).mean() >= 0.999, k
    surf = both & ~np.asarray(ref["is_env"])
    if not light_walk:
        assert (both & np.asarray(ref["is_env"])).any()  # escaped to the sky
    for k, lanes in (("p", both), ("ns", both), ("wo", both), ("uv", surf),
                     ("G", both), ("tp", both), ("pdf_fwd", surf),
                     ("pdf_bwd", surf)):
        a, b = _np(got[k])[lanes], np.asarray(ref[k])[lanes]
        close = np.abs(a - b) <= 1e-4 + 1e-3 * np.abs(b)
        if close.ndim > 1:
            close = close.all(axis=-1)
        assert close.mean() >= 0.99, k
    assert (_np(got["is_spec"])[surf] == np.asarray(ref["is_spec"])[surf]
            ).mean() >= 0.999
    assert not _np(got["tp"])[~valid_g].any()


@pytest.fixture(scope="module")
def sky_scene():
    return _load_both(SKY, {"max_ray_depth": 4})


@pytest.mark.parametrize("walk", ["light", "eye"])
def test_walks_match(sky_scene, walk):
    """examples/bunny_sky.json (glass, Blinn, mirror, mask, the map), 3,000
    lanes, 4 bounces, both packages' _walk from the same starts: the light
    walk in importance mode, the eye walk in radiance mode with the
    environment's virtual vertex; every stored field."""
    js, jm, ts, tm = sky_scene
    rng = np.random.default_rng(5 if walk == "eye" else 6)
    n = 3000
    ids = np.arange(n, dtype=np.int32)
    if walk == "eye":
        cam = tm.camera
        x = rng.uniform(0, 512, n).astype(np.float32)
        y = rng.uniform(0, 384, n).astype(np.float32)
        p0, _, _ = cam.sample_position(*(_t(v) for v in
                                         rng.uniform(0, 1, (2, n)).astype(
                                             np.float32)))
        d0, _, _ = cam.sample_direction(_t(x), _t(y), p0)
        tp0 = rng.uniform(0.5, 2.0, (n, 3)).astype(np.float32)
        lights = ts["lights"]
        env = (lights["world_center"], lights["world_radius"], tm.env_light_id)
        jenv = (js["lights"]["world_center"], js["lights"]["world_radius"],
                jnp.int32(jm.env_light_id))
        mode, jmode, salt = tb.MODE_RADIANCE, jb.MODE_RADIANCE, tbdpt.EYE_SALT
    else:
        p0 = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32) \
            + np.float32([0.2, 0.5, 0.1])
        d0 = rng.normal(size=(n, 3)).astype(np.float32)
        d0 /= np.linalg.norm(d0, axis=-1, keepdims=True)
        tp0 = rng.uniform(0.5, 2.0, (n, 3)).astype(np.float32)
        env = jenv = None
        mode, jmode, salt = (tb.MODE_IMPORTANCE, jb.MODE_IMPORTANCE,
                             tbdpt.LIGHT_SALT)
    p0, d0 = _np(p0), _np(d0)
    got = tbdpt._walk(ts, tm, _t(ids), 2, 3, _t(p0), _t(d0), _t(tp0), mode, 4,
                      salt, env_sphere=env)
    ref = jbdpt._walk(js, jm, jnp.asarray(ids), jnp.int32(2), 3,
                      jnp.asarray(p0), jnp.asarray(d0), jnp.asarray(tp0),
                      jmode, 4, salt, env_sphere=jenv)
    assert got["p"].shape == (4, n, 3) and set(got) == set(ref)
    _fields_match(got, ref, walk == "light")


# --- renders ----------------------------------------------------------------

@pytest.mark.parametrize("name", ["area", "point", "lens"])
def test_bdpt_render_matches_goblin_tpu(tmp_path, name):
    """4 spp (the thin-lens scene: t = 0 strategies too) in chunks of 128
    camera samples, the last one padded."""
    js, jm, ts, tm = _load_both(SCENES[name](tmp_path))
    ref = np.asarray(jbdpt.render_bdpt(js, jm, chunk_size=128))
    got = tbdpt.render_bdpt(ts, tm, chunk_size=128).numpy()
    assert got.shape == ref.shape and np.isfinite(got).all()
    frac, rel = _bar(got, ref)
    assert frac >= 0.99 and rel <= 1e-3 and got.mean() > 0.005


def test_studio_bdpt_matches_goblin_tpu():
    """examples/bunny_studio.json at 24 x 18, 1 spp, depth 3: glass, Blinn,
    mirror and the mask on both walks, three light kinds, the thin lens."""
    js, jm, ts, tm = _load_both(STUDIO, {"sample_per_pixel": 1,
                                         "max_ray_depth": 3})
    jm, tm = _resized(jm, 24, 18), _resized(tm, 24, 18)
    ref = np.asarray(jbdpt.render_bdpt(js, jm, chunk_size=512))
    got = tbdpt.render_bdpt(ts, tm, chunk_size=512).numpy()
    frac, rel = _bar(got, ref)
    assert frac >= 0.99 and rel <= 1e-3 and got.mean() > 0.05


def test_chunks_move_only_the_summation_order(tmp_path):
    """The streams key on pixel id: one chunk and 7 padded ones give the
    same image within float32 summation."""
    ts, tm = tloader.load_scene(SCENES["lens"](tmp_path), device="cpu")
    a = tbdpt.render_bdpt(ts, tm, chunk_size=1 << 16, spp=1)
    b = tbdpt.render_bdpt(ts, tm, chunk_size=70, spp=1)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-7)


# --- the estimators against one another (port-only mirrors) -----------------

def _pt(scene, path, spp):
    meta = tloader.load_scene(path, {"render_method": "path_tracing"},
                              device="cpu")[1]
    return tcommon.render(scene, meta, trender.make_li(meta), spp=spp,
                          chunk_size=512).numpy()


@pytest.mark.parametrize("light", ["area", "point"])
def test_bdpt_matches_pt(tmp_path, light):
    """tests/test_bdpt.py::test_bdpt_matches_pt_area_light / _point_light:
    means within 15% (area: correlation > 0.8)."""
    path = SCENES[light](tmp_path)
    scene, meta = tloader.load_scene(path, device="cpu")
    a = _pt(scene, path, 32 if light == "area" else 16)[..., 0]
    b = tbdpt.render_bdpt(scene, meta, chunk_size=512, spp=16).numpy()[..., 0]
    assert np.isfinite(b).all() and a.mean() > 0.005
    np.testing.assert_allclose(b.mean(), a.mean(), rtol=0.15)
    if light == "area":
        assert np.corrcoef(a.reshape(-1), b.reshape(-1))[0, 1] > 0.8


def test_bdpt_strategy_isolation_sums_to_full(tmp_path):
    """tests/test_bdpt.py:98: the MIS-weighted s = 0, 1, 2 images at depth
    2 partition the full estimate (within 10%)."""
    path = _scene(tmp_path, [AREA_LIGHT], depth=2)
    scene, meta = tloader.load_scene(path, device="cpu")
    full = tbdpt.render_bdpt(scene, meta, chunk_size=512, spp=16).numpy()
    parts = []
    for s in range(3):
        meta_s = tloader.load_scene(path, {"debug_s": s}, device="cpu")[1]
        assert meta_s.settings["debug_s"] == s
        parts.append(tbdpt.render_bdpt(scene, meta_s, chunk_size=512,
                                       spp=16).numpy())
    assert parts[0].mean() > 0 and parts[1].mean() > 0
    np.testing.assert_allclose(sum(p.mean() for p in parts), full.mean(),
                               rtol=0.1)


def test_bdpt_t0_contributes_and_total_matches_pt(tmp_path):
    """tests/test_lens_t0.py:157: t = 0 alone is finite and not zero, and
    the whole of BDPT meets PT on the thin-lens scene's floor (15%)."""
    path = _scene(tmp_path, [LENS_LIGHT], cam=LENS, res=(24, 18))
    scene, meta = tloader.load_scene(path, device="cpu")
    meta0 = tloader.load_scene(path, {"debug_t": 0}, device="cpu")[1]
    t0 = tbdpt.render_bdpt(scene, meta0, chunk_size=2048, spp=16).numpy()
    assert np.isfinite(t0).all() and t0.sum() > 0.0
    a = _pt(scene, path, 32)[9:, :, 0]
    b = tbdpt.render_bdpt(scene, meta, chunk_size=2048, spp=16).numpy()[9:, :, 0]
    assert a.mean() > 0.01
    np.testing.assert_allclose(b.mean(), a.mean(), rtol=0.15)


def test_bdpt_matches_pt_env_light(tmp_path):
    """tests/test_lighttracer.py:127: under a sky map alone, BDPT (the
    virtual vertex on the bounding sphere, photons from it) meets PT on the
    floor (means within 15%)."""
    path = _sky_scene(tmp_path, depth=2, res=(24, 18))
    scene, meta = tloader.load_scene(path, device="cpu")
    a = _pt(scene, path, 16)[9:].mean(axis=-1)
    b = tbdpt.render_bdpt(scene, meta, chunk_size=512, spp=16).numpy()[9:]
    assert a.mean() > 0.01
    np.testing.assert_allclose(b.mean(axis=-1).mean(), a.mean(), rtol=0.15)


def _mask_scene(tmp_path):
    """tests/test_bdpt.py's plane and area light at depth 2, with the
    studio scene's mask disk (r 0.5, alpha 0.5 over white) level between
    the two."""
    path = _scene(tmp_path, [AREA_LIGHT], depth=2)
    doc = json.loads(open(path).read())
    doc["geometries"].append({"name": "disk", "type": "disk", "radius": 0.5})
    doc["textures"] += [
        {"format": "float", "name": "half", "type": "constant", "float": 0.5},
        {"format": "color", "name": "white", "type": "constant",
         "color": [1, 1, 1]}]
    doc["materials"].append({"name": "mask", "type": "mask", "alpha": "half",
                             "transparent_color": "white",
                             "material": "diffuse"})
    doc["primitives"] += [
        {"type": "model", "name": "dm", "geometry": "disk", "material": "mask"},
        {"type": "instance", "name": "di", "model": "dm",
         "position": [0.0, 1.2, 0.2],
         "orientation": [0.70710678, -0.70710678, 0, 0]}]
    with open(path, "w") as fh:
        json.dump(doc, fh)
    return path


def test_bdpt_and_pt_part_at_a_mask_in_both_packages(tmp_path):
    """goblin_tpu's BDPT connections take a mask as opaque
    (scn.occluded), where its PT's shadow rays pass it attenuated
    (scn.occluded_attenuated): under a mask disk BDPT's image is more than
    15% darker than PT's in goblin_tpu, and the port renders both images
    as goblin_tpu does (the image bar). One of the causes of the studio
    scene's BDPT-PT gap (ROADMAP Queue 3); without the disk the two meet
    (test_bdpt_matches_pt)."""
    path = _mask_scene(tmp_path)
    js, jm, ts, tm = _load_both(path)
    j_bdpt = np.asarray(jbdpt.render_bdpt(js, jm, chunk_size=512, spp=16))
    j_pt = np.asarray(jcommon.render(js, jm, j_make_li(jm), spp=32,
                                     chunk_size=512))
    t_bdpt = tbdpt.render_bdpt(ts, tm, chunk_size=512, spp=16).numpy()
    t_pt = _pt(ts, path, 32)
    for got, ref in ((t_bdpt, j_bdpt), (t_pt, j_pt)):
        frac, rel = _bar(got, ref)
        assert frac >= 0.99 and rel <= 1e-3
    assert j_pt.mean() > 0.05
    assert j_bdpt.mean() < 0.85 * j_pt.mean()


# --- dead lanes, launches, dispatch -----------------------------------------

def test_dead_lanes_are_not_traced_and_the_image_is_finite(tmp_path,
                                                           monkeypatch):
    """A lane whose walk ended, and a connection that cannot count, reach
    the trace with mint = 3e38 and maxt = 0. A chunk at depth 3 makes 2 x 3
    walk intersects and 1 + 2 + 3 connections, in that order."""
    scene, meta = tloader.load_scene(SCENES["lens"](tmp_path), device="cpu")
    seen = []
    real = ttrace.trace

    def spy(scene, o, d, mint, maxt, **kw):
        dead = mint >= maxt
        assert bool(((mint[dead] == 3.0e38) & (maxt[dead] == 0.0)).all())
        seen.append((kw.get("any_hit", False), int((~dead).sum())))
        return real(scene, o, d, mint, maxt, **kw)

    import goblin_tpu_torch.scene.intersect as tscn
    monkeypatch.setattr(tscn, "trace", spy)
    ids = torch.arange(1500, dtype=torch.int32)
    x, y, c = tbdpt.bdpt_contributions(scene, meta, ids, 0, 0, 3)
    assert [s[0] for s in seen] == [False] * 6 + [True] * 6
    assert seen[0][1] == 1500 and seen[3][1] == 1500  # both walks start full
    assert all(s[1] < 1500 for s in seen[6:]) and max(s[1] for s in seen[6:]) > 0
    assert torch.isfinite(c).all() and bool((c >= 0).all())
    img = tbdpt.render_bdpt(scene, meta, chunk_size=1000, spp=1)
    assert bool(img.isfinite().all()) and float(img.mean()) > 0


def test_render_context_dispatches_bdpt(tmp_path):
    """render_context -> render_dispatch -> render_bdpt in chunks of up to
    65,536 camera samples (here the 320-pixel crop), reporting each; make_li
    has no batched Li for bdpt."""
    path = SCENES["area"](tmp_path)
    marks = []
    img, meta = trender.render_context(
        path, device="cpu", report=lambda d, t: marks.append((d, t)))
    assert meta.settings["render_method"] == "bdpt"
    assert marks == [(1, 4), (2, 4), (3, 4), (4, 4)]  # 4 spp, one chunk each
    scene, _ = tloader.load_scene(path, device="cpu")
    assert torch.equal(img, tsplat.render_dispatch(scene, meta, "bdpt"))
    with pytest.raises(ValueError, match="no batched Li"):
        trender.make_li(meta)
