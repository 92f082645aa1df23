"""The slice as a whole: examples/bunny_studio.json (area and sphere
lights, a spot light, analytic spheres and disks, a thin lens, Blinn,
mirror and mask materials) loaded, baked and rendered by goblin_tpu_torch
and by goblin_tpu on the CPU, plus the area-light and sphere-light scenes
of goblin_tpu's own tests rendered by both.

Same sample streams and the same tree (goblin_tpu bakes its production
tree, GOBLIN_TRACE=pallas, and walks it with its jnp traversal), so the
images may differ only where float rounding flips a discrete choice. The
bar is PERF.md's: >= 99% of pixels within 1e-4 + 1e-3 rel, means within
1e-3 rel. The baked tables are equal bit for bit.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from goblin_tpu import splatting as jsplat
from goblin_tpu.integrators import common as jcommon
from goblin_tpu.integrators import sppm as jsppm
from goblin_tpu.integrators.path import make_li as j_make_li
from goblin_tpu.scene import loader as jloader
from goblin_tpu.shading import bsdf as jb
from goblin_tpu_torch import splatting as tsplat
from goblin_tpu_torch.integrators import common as tcommon
from goblin_tpu_torch.integrators import sppm as tsppm
from goblin_tpu_torch.render import make_li as t_make_li
from goblin_tpu_torch.scene import loader as tloader
from goblin_tpu_torch.shading import bsdf as tb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STUDIO = os.path.join(REPO, "examples", "bunny_studio.json")
PLANE_OBJ = ("v -1 0 1\nv 1 0 1\nv -1 0 -1\nv 1 0 -1\n"
             "vn 0 1 0\nf 1//1 2//1 3//1\nf 3//1 2//1 4//1\n")


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _bar(got, ref):
    """Share of pixels within 1e-4 + 1e-3 rel, and the means' rel diff."""
    close = (np.abs(got - ref) <= 1e-4 + 1e-3 * np.abs(ref)).all(axis=-1)
    return close.mean(), abs(got.mean() - ref.mean()) / abs(ref.mean())


def _resized(meta, x_res, y_res):
    film = dataclasses.replace(meta.camera.film, x_res=x_res, y_res=y_res)
    return dataclasses.replace(
        meta, camera=dataclasses.replace(meta.camera, film=film))


def _load_both(path, overrides=None, trace_wide=8):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GOBLIN_TRACE", "pallas")
        mp.setenv("GOBLIN_WIDE", str(trace_wide))
        js, jm = jloader.load_scene(path, overrides)
    jm = dataclasses.replace(jm, trace_backend="jnp")
    ts, tm = tloader.load_scene(path, overrides, device="cpu",
                                trace_wide=trace_wide)
    return js, jm, ts, tm


@pytest.fixture(scope="module")
def studio():
    return _load_both(STUDIO, {"sample_per_pixel": 1})


def test_studio_scene_is_what_the_slice_needs(studio):
    _, _, ts, tm = studio
    with open(STUDIO) as f:
        doc = json.load(f)
    assert doc["camera"]["film"]["resolution"] == [512, 384]
    # initial_radius is read by SPPM alone (bunny.json's value: the
    # automatic radius of a scene with a 400-unit floor is far too wide)
    assert doc["render_setting"] == {"sample_per_pixel": 16,
                                     "max_ray_depth": 5,
                                     "render_method": "path_tracing",
                                     "initial_radius": 0.01}
    assert tm.n_tris > 90_000 and (tm.n_spheres, tm.n_disks) == (2, 2)
    assert tm.has_lens and tm.has_null and not tm.all_delta_lights
    assert tm.material_kinds == (0, 1, 2, 3, 5)
    lights = ts["lights"]
    assert lights["type"].tolist() == [3, 3, 2]
    assert lights["is_sphere"].tolist() == [False, True, False]
    assert lights["static"]["segments"] == ((0, 0, 2),)
    assert not tm.camera.is_delta


def test_studio_tables_match(studio):
    js, jm, ts, tm = studio
    for f in ("n_tris", "n_nodes", "max_leaf", "n_materials", "n_lights",
              "n_spheres", "n_disks", "has_lens", "has_null",
              "all_delta_lights", "material_kinds", "world_bounds"):
        assert getattr(tm, f) == getattr(jm, f), f
    assert tm.camera.lens_radius == jm.camera.lens_radius == 0.02
    assert tm.camera.focal_distance == jm.camera.focal_distance
    np.testing.assert_array_equal(_np(ts["tri_rows"])[:, :9],
                                  np.asarray(js["tri_soup"]))
    for k in ("tri_n", "tri_uv", "tri_mat", "tri_light", "em_rows",
              "tex_const", "ftex_const", "sph_center", "sph_radius", "sph_mat",
              "sph_light", "dsk_center", "dsk_n", "dsk_u", "dsk_radius",
              "dsk_mat", "dsk_light", "dsk_lens"):
        np.testing.assert_array_equal(_np(ts[k]), np.asarray(js[k]), err_msg=k)
    # goblin_tpu stores the integer columns of a material row as bit
    # patterns; decoded, the rows are equal, the mask row and the two
    # synthesised black Lamberts (lens first, area lights last) included
    jrows = np.asarray(js["mat_rows"])
    jdec = jrows.copy()
    for c in (0, 1, 2, 3, 4, 7):
        jdec[:, c] = jrows[:, c].view(np.int32)
    np.testing.assert_array_equal(_np(ts["mat_rows"]), jdec)
    assert _np(ts["mat_rows"])[:, 0].tolist() == [0, 0, 0, 2, 1, 3, 5, 0]
    assert _np(ts["mat_rows"])[6, 7] == 2  # the mask wraps "white"
    assert set(js["lights"]) == set(ts["lights"]) - {"static"}
    for k in js["lights"]:
        np.testing.assert_array_equal(_np(ts["lights"][k]),
                                      np.asarray(js["lights"][k]), err_msg=k)
    nb4 = np.asarray(js["pk_nb4"])
    assert tm.n_wide_nodes == nb4.shape[0]
    nb = _np(ts["bvh8_bounds"])
    for c in range(8):
        live = _np(ts["bvh8_child"])[:, c] != -1
        np.testing.assert_array_equal(nb[live, :, c],
                                      nb4[live, 8 * c:8 * c + 6])


def test_studio_width_4_tables_match():
    """GOBLIN_WIDE=4 in goblin_tpu, trace_wide=4 here: one 4-wide tree."""
    js, jm, ts, tm = _load_both(STUDIO, {"sample_per_pixel": 1}, trace_wide=4)
    assert jm.trace_wide == tm.trace_wide == 4
    nb4, nm4 = np.asarray(js["pk_nb4"]), np.asarray(js["pk_nm4"])
    nb, nc = _np(ts["bvh4_bounds"]), _np(ts["bvh4_child"])
    assert nb.shape == (nb4.shape[0], 6, 4) and tm.n_wide_nodes == nb.shape[0]
    assert "bvh8_child" not in ts
    for c in range(4):
        f0, cnt = nm4[:, 4 * c], nm4[:, 4 * c + 1]
        want = np.where(cnt > 0, -(((f0 // 8) << 7) | cnt) - 1,
                        np.where(cnt == 0, f0, -1))
        np.testing.assert_array_equal(nc[:, c], want)
        live = cnt >= 0
        np.testing.assert_array_equal(nb[live, :, c],
                                      nb4[live, 8 * c:8 * c + 6])
    assert tm.wide_depth == 9


def test_studio_path_tracing_matches_goblin_tpu(studio):
    """32 x 24, 1 spp, depth 5: every wavefront of the slice (thin-lens
    primary rays, MIS against the quad and the sphere light, the spot's
    delta arm, Blinn / mirror / glass continuation, mask punch-through of
    the shadow rays)."""
    js, jm, ts, tm = studio
    jm, tm = _resized(jm, 32, 24), _resized(tm, 32, 24)
    ref = np.asarray(jcommon.render(js, jm, j_make_li(jm)))
    got = tcommon.render(ts, tm, t_make_li(tm)).numpy()
    assert got.shape == ref.shape == (24, 32, 3) and np.isfinite(got).all()
    frac, rel = _bar(got, ref)
    assert frac >= 0.99 and rel <= 1e-3 and got.mean() > 0.05


def test_studio_sppm_matches_goblin_tpu():
    """24 x 18, 2 iterations, depth 5: area and sphere emission in the
    photon pass, area-light sampling and the mask pick in the ray pass,
    with the automatic initial radius. The thin lens renders as a pinhole
    under SPPM, in both packages."""
    ovr = {"render_method": "sppm", "sample_per_pixel": 2,
           "initial_radius": -1.0}
    js, jm, ts, tm = _load_both(STUDIO, ovr)
    jm, tm = _resized(jm, 24, 18), _resized(tm, 24, 18)
    ref = np.asarray(jsppm.render_sppm(js, jm))
    got = tsppm.render_sppm(ts, tm).numpy()
    assert got.shape == ref.shape == (18, 24, 3) and np.isfinite(got).all()
    frac, rel = _bar(got, ref)
    assert frac >= 0.99 and rel <= 1e-3 and got.mean() > 0.05


def test_studio_light_walk_matches(studio):
    """The photon walk from the studio scene's three lights (triangle and
    sphere emission, the spot's cone), 4 surface vertices, with the mask
    pick at each vertex and the lens flag. A vertex on glass or on the
    mask can flip a discrete pick where the packages round differently;
    nearly every lane agrees."""
    import jax.numpy as jnp
    js, jm, ts, tm = studio
    ids = np.arange(4000, dtype=np.int32)
    jem, jv = jsplat.walk_light_paths(js, jm, jnp.asarray(ids), jnp.int32(3),
                                      5, 5, mode=jb.MODE_RADIANCE)
    tem, tv = tsplat.walk_light_paths(ts, tm, torch.as_tensor(ids), 3, 5, 5,
                                      mode=tb.MODE_RADIANCE)
    np.testing.assert_array_equal(_np(tem["lid"]), np.asarray(jem["lid"]))
    assert set(_np(tem["lid"]).tolist()) == {0, 1, 2}
    for k in ("p", "dir", "pdf_pos", "pdf_dir", "vertex_tp"):
        np.testing.assert_allclose(_np(tem[k]), np.asarray(jem[k]), rtol=2e-5,
                                   atol=2e-5, err_msg=k)
    jvalid, tvalid = np.asarray(jv["valid"]), _np(tv["valid"])
    assert jvalid.shape == tvalid.shape == (4, 4000)
    assert jvalid[1].sum() > 100  # photons that reach a second surface
    assert (jvalid != tvalid).mean() <= 2e-3
    both = jvalid & tvalid
    for k in ("mat", "light", "is_lens"):
        assert (_np(tv[k])[both] == np.asarray(jv[k])[both]).mean() >= 0.99, k
    for k in ("p", "wo_prev", "tp", "ns"):
        a, b = _np(tv[k])[both], np.asarray(jv[k])[both]
        close = np.abs(a - b) <= 1e-4 + 1e-4 * np.abs(b)
        assert close.all(axis=-1).mean() >= 0.99, k


@pytest.mark.parametrize("method", ["path_tracing", "sppm"])
def test_studio_widths_agree(method):
    """The studio scene at trace widths 1, 4 and 8, 24 x 18."""
    images = []
    for w in (8, 4, 1):
        ts, tm = tloader.load_scene(
            STUDIO, {"render_method": method, "sample_per_pixel": 1},
            device="cpu", trace_wide=w)
        tm = _resized(tm, 24, 18)
        if method == "sppm":
            images.append(tsppm.render_sppm(ts, tm).numpy())
        else:
            images.append(tcommon.render(ts, tm, t_make_li(tm)).numpy())
    for other in images[1:]:
        frac, rel = _bar(other, images[0])
        assert frac >= 0.99 and rel <= 1e-3


def _floor_scene(tmp_path, lights, geometries=(), spp=4, depth=2, cam=None):
    """tests/test_path.py's scene: a camera looking straight down at a
    floor from y = 2."""
    doc = {
        "render_setting": {"render_method": "path_tracing",
                           "sample_per_pixel": spp, "max_ray_depth": depth},
        "camera": cam or {"position": [0, 2.0, 0], "euler": [90, 0, 0],
                          "rotation_order": "xyz", "fov": 30.0,
                          "film": {"resolution": [16, 16]},
                          "filter": {"type": "box", "width": [0.5, 0.5]}},
        "geometries": [{"name": "floor", "type": "mesh", "file": "plane.obj"},
                       *geometries],
        "textures": [{"format": "color", "name": "grey", "type": "constant",
                      "color": [0.6, 0.6, 0.6]}],
        "materials": [{"name": "diffuse", "type": "lambert", "Kd": "grey"}],
        "primitives": [
            {"type": "model", "name": "floor_m", "geometry": "floor",
             "material": "diffuse"},
            {"type": "instance", "name": "floor_i", "model": "floor_m",
             "scale": [50, 50, 50]}],
        "lights": lights,
    }
    (tmp_path / "plane.obj").write_text(PLANE_OBJ)
    path = tmp_path / "scene.json"
    path.write_text(json.dumps(doc))
    return str(path)


def test_area_light_scene_matches_and_far_field(tmp_path):
    """test_path.py::test_area_light_matches_far_field_approx: a small quad
    light far above the floor, E = Le A / h^2; rendered by both."""
    Le, h, side = 50.0, 5.0, 0.2
    path = _floor_scene(tmp_path, [{
        "name": "panel", "type": "area", "radiance": [Le, Le, Le],
        "geometry": "floor", "position": [0.0, h, 0.0],
        "euler": [180.0, 0.0, 0.0], "rotation_order": "xyz",
        "scale": [0.1, 0.1, 0.1]}], spp=16)
    js, jm, ts, tm = _load_both(path)
    ref = np.asarray(jcommon.render(js, jm, j_make_li(jm), spp=16,
                                    chunk_size=256))
    got = tcommon.render(ts, tm, t_make_li(tm), spp=16, chunk_size=256).numpy()
    frac, rel = _bar(got, ref)
    assert frac >= 0.99 and rel <= 1e-3
    expect = (0.6 / np.pi) * Le * side * side / (h * h)
    np.testing.assert_allclose(got[8, 8], expect, rtol=0.08)


def test_sphere_light_scene_matches(tmp_path):
    """test_sphere_light.py's scene: a floor lit only by an emissive
    sphere, seen from the side."""
    path = _floor_scene(
        tmp_path,
        [{"name": "ball", "type": "area", "radiance": [3, 3, 3],
          "geometry": "bulb", "position": [0, 2, 0]}],
        geometries=[{"name": "bulb", "type": "sphere", "radius": 0.5}],
        spp=1,
        cam={"position": [0, 0, -4.0], "fov": 45.0,
             "film": {"resolution": [16, 12]},
             "filter": {"type": "box", "width": [0.5, 0.5]}})
    js, jm, ts, tm = _load_both(path)
    assert bool(ts["lights"]["is_sphere"][0])
    np.testing.assert_allclose(float(ts["lights"]["area"][0]),
                               4 * np.pi * 0.25, rtol=1e-5)
    ref = np.asarray(jcommon.render(js, jm, j_make_li(jm), spp=1, seed=0))
    got = tcommon.render(ts, tm, t_make_li(tm), spp=1, seed=0).numpy()
    frac, rel = _bar(got, ref)
    assert frac >= 0.99 and rel <= 1e-3 and got.mean() > 1e-3


def test_two_emitters_under_one_light_are_refused(tmp_path):
    """A sphere and triangles under one light id: the bake refuses it, as
    goblin_tpu's does (a light is sampled as triangles or as one sphere)."""
    from goblin_tpu_torch.geometry.mesh import load_obj
    from goblin_tpu_torch.lights.lights import LIGHT_AREA
    from goblin_tpu_torch.scene.bake import InstanceRecord, SceneBuilder
    (tmp_path / "plane.obj").write_text(PLANE_OBJ)
    b = SceneBuilder()
    lid = b.lights.add(LIGHT_AREA, (1.0, 1.0, 1.0))
    eye = np.eye(4, dtype=np.float32)
    b.add_instance(InstanceRecord(load_obj(str(tmp_path / "plane.obj")), 0,
                                  eye, area_light=lid))
    b.add_instance(InstanceRecord(("sphere", 0.5), 0, eye, area_light=lid))
    with pytest.raises(ValueError, match="multiple emitter"):
        b.bake("cpu")
