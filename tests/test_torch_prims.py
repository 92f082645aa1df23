"""goblin_tpu_torch's analytic spheres and disks, the null (mask)
punch-through of shadow rays, and the thin-lens and orthographic cameras,
against goblin_tpu on the CPU.

Inputs are made with numpy from a seed and handed to both packages. Hit
masks, ids, materials, lights and lens flags are equal on every lane that
is not a graze (>= 99.9% of lanes); positions and t agree within 1e-5 (the
two packages round the quadratic and the plane division differently), the
sphere's and disk's frames within 1e-4 because they go through atan2, acos,
sin and cos, which XLA on the CPU and PyTorch round differently.
"""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goblin_tpu.geometry import intersect as jgeo
from goblin_tpu.integrators import common as jcommon
from goblin_tpu.integrators.path import make_li as j_make_li
from goblin_tpu.scene import intersect as jscn
from goblin_tpu.scene import loader as jloader
from goblin_tpu_torch.geometry import intersect as tgeo
from goblin_tpu_torch.integrators import common as tcommon
from goblin_tpu_torch.render import make_li as t_make_li
from goblin_tpu_torch.scene import intersect as tscn
from goblin_tpu_torch.scene import loader as tloader

PLANE_OBJ = ("v -1 0 1\nv 1 0 1\nv -1 0 -1\nv 1 0 -1\n"
             "vn 0 1 0\nf 1//1 2//1 3//1\nf 3//1 2//1 4//1\n")


def _t(a):
    return torch.as_tensor(np.array(a))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _unit(rng, n):
    v = rng.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _load_both(path, monkeypatch, overrides=None):
    monkeypatch.setenv("GOBLIN_TRACE", "pallas")
    js, jm = jloader.load_scene(str(path), overrides)
    jm = dataclasses.replace(jm, trace_backend="jnp")
    ts, tm = tloader.load_scene(str(path), overrides, device="cpu")
    return js, jm, ts, tm


def _bar(got, ref):
    """Share of pixels within 1e-4 + 1e-3 rel, and the means' rel diff."""
    close = (np.abs(got - ref) <= 1e-4 + 1e-3 * np.abs(ref)).all(axis=-1)
    return close.mean(), abs(got.mean() - ref.mean()) / max(abs(ref.mean()),
                                                            1e-20)


# --- the primitive tests


def test_intersect_sphere_matches():
    rng = np.random.default_rng(0)
    n = 8192
    c, r = np.float32([0.2, -0.1, 0.3]), np.float32(0.8)
    o = rng.normal(size=(n, 3)).astype(np.float32) * 2.0
    o[:512] *= 0.1  # origins inside the sphere: the far root
    # aimed at points around the sphere, so about half the rays hit
    d = c + rng.normal(size=(n, 3)).astype(np.float32) * 0.6 - o
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    mint = np.full(n, 1e-3, np.float32)
    maxt = np.where(np.arange(n) % 5 == 0, 1.5, 3e38).astype(np.float32)
    rh, rt = jgeo.intersect_sphere(*(jnp.asarray(a) for a in (o, d)),
                                   jnp.asarray(c), r, jnp.asarray(mint),
                                   jnp.asarray(maxt))
    th, tt_ = tgeo.intersect_sphere(_t(o), _t(d), _t(c), torch.tensor(r),
                                    _t(mint), _t(maxt))
    rh, rt = np.asarray(rh), np.asarray(rt)
    assert 1000 < rh.sum() < n
    assert (_np(th) != rh).mean() <= 1e-3
    both = rh & _np(th)
    np.testing.assert_allclose(_np(tt_)[both], rt[both], rtol=1e-5, atol=1e-5)
    assert (_np(tt_)[~_np(th)] == tgeo.BIG_T).all()


def test_intersect_disk_matches():
    rng = np.random.default_rng(1)
    n = 8192
    c, nrm, r = np.float32([0.1, 0.2, 0.0]), np.float32([0, 1, 0]), np.float32(1.5)
    o = rng.normal(size=(n, 3)).astype(np.float32) * 2.0
    # aimed at points of the disk's plane around the disk
    tgt = c + rng.normal(size=(n, 3)).astype(np.float32) * np.float32([1.5, 0, 1.5])
    d = tgt - o
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    d[:16, 1] = 0.0  # parallel to the disk's plane
    mint = np.full(n, 1e-3, np.float32)
    maxt = np.where(np.arange(n) % 5 == 0, 1.0, 3e38).astype(np.float32)
    rh, rt = jgeo.intersect_disk(jnp.asarray(o), jnp.asarray(d),
                                 jnp.asarray(c), jnp.asarray(nrm), r,
                                 jnp.asarray(mint), jnp.asarray(maxt))
    th, tt_ = tgeo.intersect_disk(_t(o), _t(d), _t(c), _t(nrm),
                                  torch.tensor(r), _t(mint), _t(maxt))
    rh, rt = np.asarray(rh), np.asarray(rt)
    assert 500 < rh.sum() < n and not rh[:16].any()
    assert (_np(th) != rh).mean() <= 1e-3
    both = rh & _np(th)
    np.testing.assert_allclose(_np(tt_)[both], rt[both], rtol=1e-5, atol=1e-5)


# --- a scene with spheres, disks, a thin lens and a mask


def _prim_scene(tmp_path, camera=None):
    """A floor, two spheres (one a light), two disks (one masked, tilted
    and scaled) and the lens disk of a thin-lens camera."""
    doc = {
        "render_setting": {"render_method": "path_tracing",
                           "sample_per_pixel": 1, "max_ray_depth": 3},
        "camera": camera or {
            "position": [0, 1.5, -4.0], "euler": [15, 0, 0],
            "rotation_order": "xyz", "fov": 50.0, "lens_radius": 0.05,
            "focal_distance": 4.0, "film": {"resolution": [24, 16]},
            "filter": {"type": "box", "width": [0.5, 0.5]}},
        "geometries": [
            {"name": "plane", "type": "mesh", "file": "plane.obj"},
            {"name": "ball", "type": "sphere", "radius": 0.5},
            {"name": "plate", "type": "disk", "radius": 0.6}],
        "textures": [
            {"format": "color", "name": "white", "type": "constant",
             "color": [0.8, 0.8, 0.8]},
            {"format": "color", "name": "tint", "type": "constant",
             "color": [1, 0.9, 0.8]},
            {"format": "float", "name": "a", "type": "constant", "float": 0.4}],
        "materials": [
            {"name": "diffuse", "type": "lambert", "Kd": "white"},
            {"name": "chrome", "type": "mirror"},
            {"name": "veil", "type": "mask", "alpha": "a",
             "material": "diffuse", "transparent_color": "tint"}],
        "primitives": [
            {"type": "model", "name": "fm", "geometry": "plane",
             "material": "diffuse"},
            {"type": "model", "name": "bm", "geometry": "ball",
             "material": "chrome"},
            {"type": "model", "name": "pm", "geometry": "plate",
             "material": "diffuse"},
            {"type": "model", "name": "vm", "geometry": "plate",
             "material": "veil"},
            {"type": "instance", "name": "fi", "model": "fm",
             "scale": [10, 10, 10]},
            {"type": "instance", "name": "bi", "model": "bm",
             "position": [-0.8, 0.75, 0.2], "scale": [1.5, 1.5, 1.5]},
            {"type": "instance", "name": "pi", "model": "pm",
             "position": [0.9, 0.6, 0.0], "euler": [-70, 20, 0],
             "rotation_order": "xyz"},
            {"type": "instance", "name": "vi", "model": "vm",
             "position": [0.0, 1.8, 0.0], "euler": [90, 0, 0],
             "rotation_order": "xyz", "scale": [3, 3, 3]}],
        "lights": [
            {"name": "bulb", "type": "area", "radiance": [8, 8, 8],
             "geometry": "ball", "position": [0.3, 3.0, -0.2],
             "scale": [0.5, 0.5, 0.5]},
            {"name": "key", "type": "point", "intensity": [10, 10, 10],
             "position": [0, 4.0, 0]}],
    }
    (tmp_path / "plane.obj").write_text(PLANE_OBJ)
    path = tmp_path / "prims.json"
    path.write_text(json.dumps(doc))
    return path


def _scene_rays(tm, n=4096, seed=0):
    """Camera rays of the frame with differentials, plus random rays from
    around the objects, the first 64 of them aimed at the lens disk."""
    rng = np.random.default_rng(seed)
    px = np.arange(24 * 16)
    x = (px % 24 + 0.5).astype(np.float32)
    y = (px // 24 + 0.5).astype(np.float32)
    cam = tm.camera.generate_ray(_t(x), _t(y))
    o = rng.uniform([-2, 0.05, -2], [2, 3.5, 2], (n, 3))
    d = _unit(rng, n)
    lens = np.float32(tm.camera.position) + rng.uniform(-0.03, 0.03, (64, 3))
    d[:64] = lens - o[:64]
    d[:64] /= np.linalg.norm(d[:64], axis=-1, keepdims=True)
    o = np.concatenate([_np(cam["o"]), o]).astype(np.float32)
    d = np.concatenate([_np(cam["d"]), d]).astype(np.float32)
    dxd = np.concatenate([_np(cam["dxd"]), d[len(px):]]).astype(np.float32)
    dyd = np.concatenate([_np(cam["dyd"]), d[len(px):]]).astype(np.float32)
    mint = np.full(len(o), 1e-3, np.float32)
    maxt = np.full(len(o), 3e37, np.float32)
    return o, d, mint, maxt, dxd, dyd


def test_prim_scene_tables_match(tmp_path, monkeypatch):
    js, jm, ts, tm = _load_both(_prim_scene(tmp_path), monkeypatch)
    assert (tm.n_spheres, tm.n_disks, tm.has_lens, tm.has_null) == (
        jm.n_spheres, jm.n_disks, jm.has_lens, jm.has_null) == (2, 3, True,
                                                               True)
    assert tm.world_bounds == jm.world_bounds
    assert not tm.all_delta_lights and not jm.all_delta_lights
    for k in ("sph_center", "sph_radius", "sph_mat", "sph_light",
              "dsk_center", "dsk_n", "dsk_u", "dsk_radius", "dsk_mat",
              "dsk_light", "dsk_lens", "tri_mat", "tri_light", "em_rows"):
        np.testing.assert_array_equal(_np(ts[k]), np.asarray(js[k]), err_msg=k)
    # the lens disk comes first (its black Lambert is material 1), the area
    # light's sphere last with the shared black Lambert
    assert _np(ts["dsk_lens"]).tolist() == [True, False, False]
    assert _np(ts["dsk_mat"])[0] == 1
    assert _np(ts["sph_light"]).tolist() == [-1, 0]
    assert _np(ts["sph_mat"])[1] == tm.n_materials - 1
    # a scaled sphere's radius and a scaled disk's follow the matrix
    np.testing.assert_allclose(_np(ts["sph_radius"]), [0.75, 0.25])
    np.testing.assert_allclose(_np(ts["dsk_radius"])[1:], [0.6, 1.8],
                               rtol=1e-6)


def test_intersect_on_spheres_and_disks_matches(tmp_path, monkeypatch):
    js, jm, ts, tm = _load_both(_prim_scene(tmp_path), monkeypatch)
    o, d, mint, maxt, dxd, dyd = _scene_rays(tm)
    ref = jscn.intersect(js, jm, *(jnp.asarray(a) for a in (o, d, mint, maxt)),
                         dxd=jnp.asarray(dxd), dyd=jnp.asarray(dyd))
    got = tscn.intersect(ts, tm, *(_t(a) for a in (o, d, mint, maxt)),
                         dxd=_t(dxd), dyd=_t(dyd))
    jh, th = np.asarray(ref["hit"]), _np(got["hit"])
    assert (jh != th).mean() <= 1e-3
    same = jh & th
    for k in ("mat", "light", "is_lens"):
        same &= _np(got[k]) == np.asarray(ref[k])
    assert same.sum() >= 0.999 * (jh & th).sum()
    # every kind of primitive is hit: both spheres, both plain disks, the
    # lens, the floor
    mats = set(_np(got["mat"])[same].tolist())
    assert mats >= {1, 2, 3, 4, tm.n_materials - 1}
    assert _np(got["is_lens"])[same].sum() > 5
    assert (_np(got["light"])[same] == 0).sum() > 5
    for k, atol in (("t", 1e-5), ("p", 1e-5), ("ns", 1e-5), ("ng", 1e-5),
                    ("eps", 1e-7), ("wo", 0.0), ("uv", 1e-4), ("dpdu", 1e-4),
                    ("dpdv", 1e-4)):
        a, b = _np(got[k])[same], np.asarray(ref[k])[same]
        err = np.abs(a - b).reshape(len(a), -1).max(axis=1)
        scale = np.abs(b).reshape(len(b), -1).max(axis=1)
        assert (err <= atol + 1e-5 * scale).mean() >= 0.999, k
    cam_lanes = np.arange(len(o)) < 24 * 16
    h = same & cam_lanes
    assert h.sum() > 100
    for k in ("duv4", "duv"):
        a, b = _np(got[k])[h], np.asarray(ref[k])[h]
        ok = np.abs(a - b) <= 1e-5 + 1e-3 * np.abs(b)
        assert ok.all(axis=-1).mean() >= 0.99, k


def test_occluded_counts_spheres_and_every_disk(tmp_path, monkeypatch):
    js, jm, ts, tm = _load_both(_prim_scene(tmp_path), monkeypatch)
    o, d, mint, maxt, _, _ = _scene_rays(tm, seed=3)
    maxt = np.random.default_rng(5).uniform(0.2, 6.0, len(o)).astype(np.float32)
    # rays that start behind the lens disk and cross it
    cam = np.float32(tm.camera.position)
    o[:64] = cam + np.float32([0, 0, -0.5])
    d[:64] = np.float32([0, 0, 1])
    maxt[:64] = 1.0
    ref = np.asarray(jscn.occluded(js, jm, *(jnp.asarray(a) for a in
                                             (o, d, mint, maxt))))
    got = _np(tscn.occluded(ts, tm, *(_t(a) for a in (o, d, mint, maxt))))
    assert 200 < ref.sum() < len(o)
    assert (got != ref).mean() <= 1e-3
    assert got[:64].all()  # the lens disk shadows, as in goblin_tpu


def test_occluded_attenuated_punches_through_masks(tmp_path, monkeypatch):
    """Shadow rays from the floor up to the point light cross the veil
    (alpha 0.4, colour [1, 0.9, 0.8]): not occluded, attenuated by 0.6 x
    the colour; rays under the opaque disk or the mirror ball are blocked."""
    js, jm, ts, tm = _load_both(_prim_scene(tmp_path), monkeypatch)
    rng = np.random.default_rng(2)
    n = 2048
    o = np.stack([rng.uniform(-2, 2, n), np.full(n, 0.01),
                  rng.uniform(-2, 2, n)], -1).astype(np.float32)
    to_l = np.float32([0, 4.0, 0]) - o
    dist = np.linalg.norm(to_l, axis=-1).astype(np.float32)
    d = (to_l / dist[:, None]).astype(np.float32)
    mint = np.full(n, 1e-3, np.float32)
    maxt = (dist - 1e-3).astype(np.float32)
    maxt[::31] = 0.0  # dead lanes
    rocc, rtr = jscn.occluded_attenuated(js, jm, *(jnp.asarray(a) for a in
                                                   (o, d, mint, maxt)))
    gocc, gtr = tscn.occluded_attenuated(ts, tm, *(_t(a) for a in
                                                   (o, d, mint, maxt)))
    rocc, rtr = np.asarray(rocc), np.asarray(rtr)
    assert (_np(gocc) != rocc).mean() <= 1e-3
    ok = _np(gocc) == rocc
    np.testing.assert_allclose(_np(gtr)[ok], rtr[ok], rtol=1e-6, atol=1e-7)
    open_ = ~_np(gocc)
    open_[::31] = False
    assert 100 < open_.sum() < n and _np(gocc).sum() > 50
    through = np.isclose(_np(gtr)[open_], np.float32([0.6, 0.54, 0.48]),
                         rtol=1e-5).all(axis=-1)
    assert through.mean() > 0.5  # the rest pass beside the veil: tr = 1


def test_disk_area_light_is_a_triangle_fan(tmp_path, monkeypatch):
    """An area light on a disk geometry: the bake turns the disk into 64
    wedges, so it enters the emissive-triangle tables (and the BVH) and no
    analytic disk; tables and a small render equal goblin_tpu's."""
    doc = {
        "render_setting": {"render_method": "path_tracing",
                           "sample_per_pixel": 1, "max_ray_depth": 2},
        "camera": {"position": [0, 1.0, -3.0], "euler": [15, 0, 0],
                   "rotation_order": "xyz", "fov": 50.0,
                   "film": {"resolution": [16, 12]},
                   "filter": {"type": "box", "width": [0.5, 0.5]}},
        "geometries": [{"name": "plane", "type": "mesh", "file": "plane.obj"},
                       {"name": "lamp", "type": "disk", "radius": 0.5}],
        "textures": [{"format": "color", "name": "white", "type": "constant",
                      "color": [0.8, 0.8, 0.8]}],
        "materials": [{"name": "diffuse", "type": "lambert", "Kd": "white"}],
        "primitives": [
            {"type": "model", "name": "fm", "geometry": "plane",
             "material": "diffuse"},
            {"type": "instance", "name": "fi", "model": "fm",
             "scale": [10, 10, 10]}],
        "lights": [{"name": "lamp", "type": "area", "radiance": [20, 18, 16],
                    "geometry": "lamp", "position": [0.2, 2.0, 0.1],
                    "euler": [90, 0, 0], "rotation_order": "xyz",
                    "scale": [1.5, 1.5, 1.5]}],
    }
    (tmp_path / "plane.obj").write_text(PLANE_OBJ)
    path = tmp_path / "lamp.json"
    path.write_text(json.dumps(doc))
    js, jm, ts, tm = _load_both(path, monkeypatch)
    assert tm.n_disks == jm.n_disks == 0 and tm.n_tris == jm.n_tris
    assert _np(ts["em_rows"]).shape == (64, 12)
    for k in ("em_rows", "tri_light", "tri_mat", "tri_n"):
        np.testing.assert_array_equal(_np(ts[k]), np.asarray(js[k]), err_msg=k)
    for k in ("area", "em_cdf", "seg_start", "power"):
        np.testing.assert_array_equal(_np(ts["lights"][k]),
                                      np.asarray(js["lights"][k]), err_msg=k)
    # the fan's area is the inscribed 64-gon's, just under the disk's
    r = 0.75
    np.testing.assert_allclose(float(ts["lights"]["area"][0]),
                               32 * r * r * np.sin(2 * np.pi / 64), rtol=1e-5)
    ref = np.asarray(jcommon.render(js, jm, j_make_li(jm), spp=1, seed=0))
    got = tcommon.render(ts, tm, t_make_li(tm), spp=1, seed=0).numpy()
    frac, rel = _bar(got, ref)
    assert frac >= 0.99 and rel <= 1e-3 and got.mean() > 0.01


# --- tests/test_null_punch.py's scene, rendered by both


def _null_scene(tmp_path, alpha):
    doc = {
        "render_setting": {"render_method": "path_tracing",
                           "sample_per_pixel": 1, "max_ray_depth": 2},
        "camera": {"position": [0, 1.0, -3.0], "euler": [15, 0, 0],
                   "rotation_order": "xyz", "fov": 50.0,
                   "film": {"resolution": [24, 16]},
                   "filter": {"type": "box", "width": [0.5, 0.5]}},
        "geometries": [{"name": "plane", "type": "mesh", "file": "plane.obj"}],
        "textures": [
            {"format": "color", "name": "white", "type": "constant",
             "color": [0.8, 0.8, 0.8]},
            {"format": "float", "name": "a", "type": "constant",
             "float": alpha}],
        "materials": [
            {"name": "diffuse", "type": "lambert", "Kd": "white"},
            {"name": "veil", "type": "mask", "alpha": "a",
             "material": "diffuse", "transparent_color": [1, 1, 1]}],
        "primitives": [
            {"type": "model", "name": "fm", "geometry": "plane",
             "material": "diffuse"},
            {"type": "model", "name": "vm", "geometry": "plane",
             "material": "veil"},
            {"type": "instance", "name": "fi", "model": "fm",
             "scale": [10, 10, 10]},
            {"type": "instance", "name": "vi", "model": "vm",
             "position": [0, 2.0, 0], "scale": [10, 10, 10]}],
        "lights": [{"name": "key", "type": "point", "intensity": [30, 30, 30],
                    "position": [0, 4.0, 0]}],
    }
    (tmp_path / "plane.obj").write_text(PLANE_OBJ)
    path = tmp_path / f"scene_{alpha}.json"
    path.write_text(json.dumps(doc))
    return path


@pytest.mark.parametrize("alpha", [0.0, 0.5, 1.0])
def test_null_punch_scene_matches_goblin_tpu(tmp_path, monkeypatch, alpha):
    """The floor under a mask panel under a point light, depth 2: the
    panel's shadow follows alpha, and the image equals goblin_tpu's."""
    js, jm, ts, tm = _load_both(_null_scene(tmp_path, alpha), monkeypatch)
    assert tm.has_null and jm.has_null
    ref = np.asarray(jcommon.render(js, jm, j_make_li(jm), spp=1, seed=0))
    got = tcommon.render(ts, tm, t_make_li(tm), spp=1, seed=0).numpy()
    frac, rel = _bar(got, ref)
    assert frac >= 0.99 and rel <= 1e-3
    floor = got[10:].mean()  # the bottom rows look at the floor
    assert np.isfinite(got).all()
    # an opaque panel shadows the whole floor; a clear one costs no bounce
    assert floor == 0.0 if alpha == 1.0 else floor > 0.05


# --- cameras


def _camera_scene(tmp_path, camera):
    return _prim_scene(tmp_path, camera=camera)


CAMERAS = {
    "thin_lens": {"position": [0.5, 1.5, -4.0], "euler": [15, -5, 3],
                  "rotation_order": "xyz", "fov": 40.0, "lens_radius": 0.2,
                  "focal_distance": 3.5, "film": {"resolution": [24, 16]},
                  "filter": {"type": "box", "width": [0.5, 0.5]}},
    "orthographic": {"type": "orthographic", "position": [0, 2.0, -4.0],
                     "euler": [20, 0, 0], "rotation_order": "xyz",
                     "film_width": 5.0, "film": {"resolution": [24, 16]},
                     "filter": {"type": "box", "width": [0.5, 0.5]}},
}


@pytest.mark.parametrize("kind", sorted(CAMERAS))
def test_generate_ray_matches(tmp_path, monkeypatch, kind):
    _, jm, _, tm = _load_both(_camera_scene(tmp_path, CAMERAS[kind]),
                              monkeypatch)
    assert tm.camera.kind == jm.camera.kind
    assert tm.camera.is_delta == jm.camera.is_delta == (kind == "orthographic")
    assert tm.has_lens == jm.has_lens == (kind == "thin_lens")
    np.testing.assert_array_equal(tm.camera.proj, jm.camera.proj)
    rng = np.random.default_rng(0)
    n = 4096
    x = rng.uniform(0, 24, n).astype(np.float32)
    y = rng.uniform(0, 16, n).astype(np.float32)
    u1, u2 = (rng.uniform(0, 1, n).astype(np.float32) for _ in range(2))
    for lens in ((), (u1, u2)):
        ref = jm.camera.generate_ray(jnp.asarray(x), jnp.asarray(y),
                                     *(jnp.asarray(u) for u in lens))
        got = tm.camera.generate_ray(_t(x), _t(y), *(_t(u) for u in lens))
        for k in ("o", "d", "dxd", "dyd", "mint", "maxt"):
            np.testing.assert_allclose(_np(got[k]), np.asarray(ref[k]),
                                       rtol=1e-6, atol=2e-6, err_msg=k)
    if kind == "thin_lens":
        # with lens samples the origins spread over the lens disk
        spread = np.linalg.norm(_np(got["o"]) - np.float32(tm.camera.position),
                                axis=-1)
        assert 0.15 < spread.max() <= 0.2 + 1e-6
    else:
        assert np.ptp(_np(got["d"]), axis=0).max() == 0.0  # parallel rays


@pytest.mark.parametrize("kind", sorted(CAMERAS))
def test_render_pass_draws_lens_samples(tmp_path, monkeypatch, kind):
    """A whole render through each camera (the thin lens takes its samples
    at the camera bounce's lens dimensions) equals goblin_tpu's."""
    js, jm, ts, tm = _load_both(_camera_scene(tmp_path, CAMERAS[kind]),
                                monkeypatch, {"sample_per_pixel": 2})
    ref = np.asarray(jcommon.render(js, jm, j_make_li(jm)))
    got = tcommon.render(ts, tm, t_make_li(tm)).numpy()
    frac, rel = _bar(got, ref)
    assert frac >= 0.99 and rel <= 1e-3 and got.mean() > 0
    if kind == "thin_lens":
        # not the pinhole image: the lens samples were used
        pin = dataclasses.replace(tm.camera, lens_radius=0.0)
        tm_pin = dataclasses.replace(tm, camera=pin)
        other = tcommon.render(ts, tm_pin, t_make_li(tm_pin)).numpy()
        assert _bar(other, ref)[0] < 0.9
