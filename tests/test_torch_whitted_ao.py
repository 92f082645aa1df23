"""goblin_tpu_torch's ambient-occlusion and Whitted integrators against
goblin_tpu's on the CPU: the hemisphere warp and the broadcast sample
streams, li lane by lane on a chunk of camera rays, whole renders at
32 x 24, the mirrors of tests/test_scene_ao.py, Whitted's ray tree with a
transparent material at depth 2. (examples/bunny_gallery.json under both:
tests/test_torch_gallery.py.)

Same sample streams and the same tree in both packages. Radiance lanes and
images are held to PERF.md's image bar: >= 99% of lanes (pixels) within
1e-4 + 1e-3 rel and means within 1e-3 rel; a lane differs only where
rounding flips a discrete choice (an occlusion ray that grazes an edge, a
reflect / refract pick). Whitted's unrolled tree costs goblin_tpu minutes of
XLA compile on the CPU, so its li runs op by op here (the textures file's
jax_render_unjitted) and its depth is 2: 7 nodes with a transparent
material.
"""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goblin_tpu.core import rng as jrng
from goblin_tpu.core import sampling as jsamp
from goblin_tpu.integrators import common as jcommon
from goblin_tpu.integrators.ao import make_li as j_ao_li
from goblin_tpu.integrators.whitted import make_li as j_whitted_li
from goblin_tpu_torch.core import rng as trng
from goblin_tpu_torch.core import sampling as tsamp
from goblin_tpu_torch.integrators import common as tcommon
from goblin_tpu_torch.integrators import whitted as twhitted
from goblin_tpu_torch.integrators.ao import make_li as t_ao_li
from goblin_tpu_torch.render import make_li as t_make_li
from goblin_tpu_torch.scene import intersect as tscn
from goblin_tpu_torch.scene import loader as tloader
from test_torch_studio import PLANE_OBJ, _bar, _load_both, _np
from test_torch_textures import (GALLERY, _camera_rays,  # noqa: F401
                                 few_torch_threads, jax_render_unjitted)

BUNNY = os.path.join(os.path.dirname(GALLERY), "bunny.json")


def _t(a):
    return torch.as_tensor(np.array(a))


def test_uniform_sample_hemisphere_matches():
    rng = np.random.default_rng(5)
    u1, u2 = rng.uniform(0, 1, (2, 300, 7)).astype(np.float32)
    u1[0, :2] = [0.0, 1.0]
    got = _np(tsamp.uniform_sample_hemisphere(_t(u1), _t(u2)))
    ref = np.asarray(jsamp.uniform_sample_hemisphere(jnp.asarray(u1),
                                                     jnp.asarray(u2)))
    assert got.shape == ref.shape == (300, 7, 3)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-6)
    assert (got[..., 2] >= 0).all()


def test_hash_uniform_broadcasts_pixels_against_dimensions():
    """AO's streams: (R, 1) pixel ids against (1, N) dimensions, bit for
    bit goblin_tpu's (R, N) block."""
    pix = np.arange(1000, 1400, dtype=np.int32)
    dims = 4 + 2 * np.arange(25)
    for off in (0, 1):
        got = trng.hash_uniform(7, _t(pix)[:, None], 3, 1,
                                _t(dims)[None, :] + off)
        ref = jrng.hash_uniform(7, jnp.asarray(pix)[:, None], 3, 1,
                                jnp.asarray(dims)[None, :] + off)
        assert got.shape == (400, 25) and got.dtype == torch.float32
        np.testing.assert_array_equal(_np(got), np.asarray(ref))


# --- ambient occlusion ------------------------------------------------------

def _tiny_scene(tmp_path, method="ao", res=(32, 24), **settings):
    """tests/test_scene_ao.py's scene: a ball on a floor."""
    doc = {
        "render_setting": {"render_method": method, "sample_per_pixel": 1,
                           "ao_sample_num": 4, **settings},
        "camera": {"position": [0, 1.0, -3.0], "euler": [15, 0, 0],
                   "rotation_order": "xyz", "fov": 50.0,
                   "film": {"resolution": list(res)},
                   "filter": {"type": "box", "width": [0.5, 0.5]}},
        "geometries": [{"name": "floor", "type": "mesh", "file": "plane.obj"},
                       {"name": "ball", "type": "sphere", "radius": 0.5}],
        "textures": [{"format": "color", "name": "white", "type": "constant",
                      "color": [1, 1, 1]}],
        "materials": [{"name": "diffuse", "type": "lambert", "Kd": "white"}],
        "primitives": [
            {"type": "model", "name": "floor_m", "geometry": "floor",
             "material": "diffuse"},
            {"type": "model", "name": "ball_m", "geometry": "ball",
             "material": "diffuse"},
            {"type": "instance", "name": "floor_i", "model": "floor_m",
             "scale": [10, 10, 10]},
            {"type": "instance", "name": "ball_i", "model": "ball_m",
             "position": [0, 0.5, 0]}],
        "lights": [{"name": "key", "type": "point", "intensity": [10, 10, 10],
                    "position": [3, 4, -2]}],
    }
    (tmp_path / "plane.obj").write_text(PLANE_OBJ)
    path = tmp_path / "scene.json"
    path.write_text(json.dumps(doc))
    return str(path)


def test_ao_scene_loads_and_bakes(tmp_path):
    scene, meta = tloader.load_scene(_tiny_scene(tmp_path), device="cpu")
    assert meta.n_tris >= 2 and meta.n_spheres == 1 and meta.n_lights == 1
    assert meta.camera.film.x_res == 32
    assert meta.settings["ao_sample_num"] == 4
    assert scene["tri_rows"].shape[1] >= 9


def test_ao_render_end_to_end(tmp_path):
    """make_li reads ao_sample_num; misses are 0 and the open floor is
    bright."""
    scene, meta = tloader.load_scene(_tiny_scene(tmp_path), device="cpu")
    img = tcommon.render(scene, meta, t_make_li(meta), spp=1,
                         chunk_size=256).numpy()
    assert img.shape == (24, 32, 3) and np.isfinite(img).all()
    assert img.max() > 0.8 and img[18:, 12:20, 0].mean() > 0.1
    assert img[0].max() == 0.0  # the sky
    assert set(np.unique(np.round(img * 4, 4))) <= {0, 1, 2, 3, 4}


def test_ao_sphere_occludes_floor(tmp_path):
    scene, meta = tloader.load_scene(_tiny_scene(tmp_path), device="cpu")
    img = tcommon.render(scene, meta, t_ao_li(16), spp=2,
                         chunk_size=512).numpy()
    assert img[20, 16, 0] < img[23, 2, 0]  # under the ball vs far from it


def test_bunny_scene_loads_under_ao():
    _, meta = tloader.load_scene(BUNNY, {"render_method": "ao"}, device="cpu")
    assert meta.n_tris > 10_000 and meta.camera.film.x_res == 512
    assert meta.settings["render_method"] == "ao" and meta.n_lights == 1
    assert meta.settings["ao_sample_num"] == 25  # the default


def test_ao_li_matches_lane_by_lane(tmp_path):
    """A chunk of camera rays through both li: the (R x 9,) any-hit batch,
    each lane's visibility a multiple of 1 / 9."""
    js, jm, ts, tm = _load_both(_tiny_scene(tmp_path))
    jray, jids, tray, tids = _camera_rays(jm, tm)
    ref = np.asarray(j_ao_li(9)(js, jm, jray, jids, jnp.int32(2), 11))
    got = _np(t_ao_li(9)(ts, tm, tray, tids, 2, 11))
    assert got.shape == ref.shape == (768, 3)
    assert (np.abs(got - ref) <= 1e-6).all(axis=-1).mean() >= 0.995
    np.testing.assert_allclose(got.mean(), ref.mean(), rtol=1e-3)
    np.testing.assert_allclose(got * 9, np.round(got * 9), atol=1e-5)
    assert 0.2 < got.mean() < 0.9 and (got[:, 0] == got[:, 2]).all()


def test_ao_render_matches_goblin_tpu(tmp_path):
    js, jm, ts, tm = _load_both(_tiny_scene(tmp_path, ao_sample_num=16))
    ref = np.asarray(jcommon.render(js, jm, j_ao_li(16), chunk_size=256))
    got = tcommon.render(ts, tm, t_make_li(tm), chunk_size=256).numpy()
    assert got.shape == ref.shape == (24, 32, 3)
    frac, rel = _bar(got, ref)
    assert frac >= 0.99 and rel <= 1e-3 and got.mean() > 0.1


def test_ao_traces_one_flat_batch(tmp_path, monkeypatch):
    """One closest-hit trace of R rays and one any-hit trace of R x N; the
    directions of a primary miss are dead lanes (mint above maxt)."""
    scene, meta = tloader.load_scene(_tiny_scene(tmp_path), device="cpu")
    calls = []
    real = tscn.trace_rays

    def spy(scene, meta, o, d, mint, maxt, any_hit=False):
        calls.append((any_hit, o.shape[0], int((mint < maxt).sum())))
        return real(scene, meta, o, d, mint, maxt, any_hit=any_hit)

    monkeypatch.setattr(tscn, "trace_rays", spy)
    tcommon.render(scene, meta, t_ao_li(5), spp=1)
    assert [c[:2] for c in calls] == [(False, 768), (True, 768 * 5)]
    assert 0 < calls[1][2] < 768 * 5 and calls[1][2] % 5 == 0


# --- Whitted ----------------------------------------------------------------

def _glass_scene(tmp_path, depth=2, lights=None, res=(32, 24)):
    """A glass ball and a mirror ball over a Blinn floor under an area
    light (2 samples) and a point light: every Whitted branch, the
    light-side and BSDF-side MIS and the delta arm."""
    doc = {
        "render_setting": {"render_method": "whitted", "sample_per_pixel": 1,
                           "max_ray_depth": depth},
        "camera": {"position": [0, 1.2, -3.5], "euler": [15, 0, 0],
                   "rotation_order": "xyz", "fov": 45.0,
                   "film": {"resolution": list(res)},
                   "filter": {"type": "box", "width": [0.5, 0.5]}},
        "geometries": [{"name": "floor", "type": "mesh", "file": "plane.obj"},
                       {"name": "ball", "type": "sphere", "radius": 0.5}],
        "textures": [
            {"format": "color", "name": "white", "type": "constant",
             "color": [0.9, 0.9, 0.9]},
            {"format": "color", "name": "tint", "type": "constant",
             "color": [0.9, 0.8, 1.0]},
            {"format": "float", "name": "e", "type": "constant",
             "float": 20.0}],
        "materials": [
            {"name": "floor", "type": "blinn", "Kg": "white", "exponent": "e"},
            {"name": "glass", "type": "transparent", "Kr": "tint",
             "Kt": "tint", "index": 1.5},
            {"name": "mirror", "type": "mirror", "Kr": "white"}],
        "primitives": [
            {"type": "model", "name": "fm", "geometry": "floor",
             "material": "floor"},
            {"type": "model", "name": "gm", "geometry": "ball",
             "material": "glass"},
            {"type": "model", "name": "mm", "geometry": "ball",
             "material": "mirror"},
            {"type": "instance", "name": "fi", "model": "fm",
             "scale": [10, 10, 10]},
            {"type": "instance", "name": "gi", "model": "gm",
             "position": [-0.6, 0.5, 0]},
            {"type": "instance", "name": "mi", "model": "mm",
             "position": [0.6, 0.5, 0.3]}],
        "lights": lights if lights is not None else [
            {"name": "panel", "type": "area", "radiance": [20, 20, 20],
             "geometry": "floor", "position": [0.0, 3.0, 0.0],
             "euler": [180.0, 0.0, 0.0], "rotation_order": "xyz",
             "scale": [0.5, 0.5, 0.5], "sample_num": 2},
            {"name": "key", "type": "point", "intensity": [8, 8, 8],
             "position": [2, 3, -2]}],
    }
    (tmp_path / "plane.obj").write_text(PLANE_OBJ)
    path = tmp_path / "scene.json"
    path.write_text(json.dumps(doc))
    return str(path)


def test_specular_caps_follow_the_materials(tmp_path):
    _, glass = tloader.load_scene(_glass_scene(tmp_path), device="cpu")
    assert glass.light_sample_nums == (2, 1)
    assert twhitted._specular_caps(glass) == (True, True)
    mirror_only = dataclasses.replace(glass, material_kinds=(0, 1, 3, 5))
    assert twhitted._specular_caps(mirror_only) == (True, False)
    diffuse = dataclasses.replace(glass, material_kinds=(0, 1))
    assert twhitted._specular_caps(diffuse) == (False, False)
    unknown = dataclasses.replace(glass, material_kinds=())
    assert twhitted._specular_caps(unknown) == (True, True)


@pytest.mark.parametrize("depth", [0, 1, 2, 3])
def test_whitted_tree_has_every_node(tmp_path, monkeypatch, depth):
    """With a transparent material the tree is the reference's own:
    2^(depth + 1) - 1 nodes, numbered reflection child first, and each
    node takes lights x samples x (1 shadow query + 1 BSDF-side intersect)
    traces beside the one that made it."""
    scene, meta = tloader.load_scene(_glass_scene(tmp_path, res=(8, 6)),
                                     device="cpu")
    tags, traces = [], []
    real_direct, real_trace = twhitted._direct_light, tscn.trace_rays

    def direct_spy(*args):
        tags.append(args[-1])
        return real_direct(*args)

    def trace_spy(*args, **kw):
        traces.append(kw.get("any_hit", False))
        return real_trace(*args, **kw)

    monkeypatch.setattr(twhitted, "_direct_light", direct_spy)
    monkeypatch.setattr(tscn, "trace_rays", trace_spy)
    tcommon.render(scene, meta, twhitted.make_li(meta, max_depth=depth))
    nodes = 2 ** (depth + 1) - 1
    assert tags == [0] + [0x100 + k for k in range(1, nodes)]
    samples = sum(meta.light_sample_nums)  # 2 + 1
    assert len(traces) == nodes + nodes * samples * 2
    assert sum(traces) == nodes * samples  # no mask: plain any-hit queries


def test_whitted_prunes_the_tree_without_specular_materials(tmp_path,
                                                            monkeypatch):
    scene, meta = tloader.load_scene(_tiny_scene(tmp_path, "whitted"),
                                     device="cpu")
    tags = []
    real = twhitted._direct_light
    monkeypatch.setattr(twhitted, "_direct_light",
                        lambda *a: tags.append(a[-1]) or real(*a))
    img = tcommon.render(scene, meta, t_make_li(meta)).numpy()
    assert tags == [0] and img.mean() > 0.01


def test_whitted_li_matches_lane_by_lane(tmp_path):
    """The glass scene at depth 2 (7 nodes), one chunk of camera rays."""
    js, jm, ts, tm = _load_both(_glass_scene(tmp_path))
    jray, jids, tray, tids = _camera_rays(jm, tm)
    ref = np.asarray(j_whitted_li(jm)(js, jm, jray, jids, jnp.int32(1), 3))
    got = _np(twhitted.make_li(tm)(ts, tm, tray, tids, 1, 3))
    assert got.shape == ref.shape == (768, 3) and np.isfinite(got).all()
    frac, rel = _bar(got, ref)
    assert frac >= 0.99 and rel <= 1e-3 and got.mean() > 0.05
    # the tree reached light: lanes on the two balls are not black
    frag = tscn.intersect(ts, tm, tray["o"], tray["d"], tray["mint"],
                          tray["maxt"])
    for mat in (2, 3):
        assert got[_np(frag["mat"]) == mat].mean() > 1e-4


def test_whitted_render_matches_goblin_tpu(tmp_path):
    """32 x 24 at depth 2, goblin_tpu op by op."""
    js, jm, ts, tm = _load_both(_glass_scene(tmp_path))
    ref = jax_render_unjitted(js, jm, j_whitted_li(jm))
    got = tcommon.render(ts, tm, t_make_li(tm), chunk_size=300).numpy()
    assert got.shape == ref.shape == (24, 32, 3) and np.isfinite(got).all()
    frac, rel = _bar(got, ref)
    assert frac >= 0.99 and rel <= 1e-3 and got.mean() > 0.05


def test_whitted_lambert_scene_matches_compiled_goblin_tpu(tmp_path):
    """A single-node tree is cheap to compile: goblin_tpu's own jitted
    render of tests/test_scene_ao.py's scene under whitted."""
    js, jm, ts, tm = _load_both(_tiny_scene(tmp_path, "whitted"))
    ref = np.asarray(jcommon.render(js, jm, j_whitted_li(jm)))
    got = tcommon.render(ts, tm, t_make_li(tm)).numpy()
    frac, rel = _bar(got, ref)
    assert frac >= 0.99 and rel <= 1e-3 and got.mean() > 0.01


def test_whitted_without_lights_is_emission_only(tmp_path):
    scene, meta = tloader.load_scene(_glass_scene(tmp_path, lights=[]),
                                     device="cpu")
    img = tcommon.render(scene, meta, t_make_li(meta)).numpy()
    assert meta.n_lights == 0 and not img.any()


@pytest.mark.parametrize("flag", ["has_env", "has_bssrdf"])
def test_whitted_refuses_the_arms_it_lacks(tmp_path, flag):
    """Whitted has both arms now that the image-based light and subsurface
    scattering are ported (refused until then): the has_env case builds an
    li (tests/test_torch_envmap.py renders it), and the has_bssrdf arm
    renders, adding nothing on a scene with no subsurface material
    (tests/test_torch_bssrdf.py holds it against goblin_tpu)."""
    scene, meta = tloader.load_scene(_tiny_scene(tmp_path, "whitted"),
                                     device="cpu")
    flagged = dataclasses.replace(meta, **{flag: True})
    if flag == "has_env":
        assert callable(twhitted.make_li(flagged))
        return
    plain = tcommon.render(scene, meta, twhitted.make_li(meta)).numpy()
    got = tcommon.render(scene, flagged, twhitted.make_li(flagged)).numpy()
    assert plain.mean() > 0
    np.testing.assert_array_equal(got, plain)
