"""goblin_tpu_torch's film outputs, camera movement and debug overlay
against goblin_tpu's on the CPU: the mirrors of
tests/test_camera_film.py::test_tone_map_and_bloom_run and
::test_camera_movement_helpers and of tests/test_debug_draw.py, the PPM
writer byte for byte, write_image's order (bloom, then tone mapping) and
the CLI's PPM.

Bars: tone mapping within rtol 1e-5 (the log-average is summed in another
order); bloom within 1e-6 of the image's scale (both FFTs in float64);
cameras, overlays and PPM bytes equal, but for an 8-bit value that a
last-ulp difference moves across a rounding edge.
"""

import json
import os

import numpy as np
import pytest
import torch

from goblin_tpu.camera import camera as jcam
from goblin_tpu.camera import film as jfilm
from goblin_tpu.io import draw as jdraw
from goblin_tpu.io import exr as jexr
from goblin_tpu_torch import render as trender
from goblin_tpu_torch.camera import camera as tcam
from goblin_tpu_torch.camera import film as tfilm
from goblin_tpu_torch.io import draw as tdraw
from goblin_tpu_torch.io import exr as texr


def _image(seed, h=32, w=32):
    return np.abs(np.random.default_rng(seed).normal(size=(h, w, 3))).astype(
        np.float32)


def test_tone_map_and_bloom_run():
    img = _image(0)
    tm = tfilm.tone_map(torch.as_tensor(img)).numpy()
    assert tm.shape == img.shape and np.isfinite(tm).all()
    bl = tfilm.bloom(torch.as_tensor(img), radius=0.2, weight=0.3).numpy()
    assert bl.shape == img.shape and np.isfinite(bl).all()
    # bloom blends, nearly preserving the mean
    assert abs(bl.mean() - img.mean()) / img.mean() < 0.25
    np.testing.assert_allclose(tm, jfilm.tone_map(img), rtol=1e-5)
    np.testing.assert_allclose(bl, jfilm.bloom(img, radius=0.2, weight=0.3),
                               rtol=0, atol=1e-6 * img.max())
    # not square, a radius whose filter is even, and the no-op radii
    img = _image(1, 24, 40) * 4.0
    for radius, weight in ((0.1, 0.5), (0.35, 1.0), (0.0, 0.5), (0.02, 0.1)):
        np.testing.assert_allclose(
            tfilm.bloom(torch.as_tensor(img), radius, weight).numpy(),
            jfilm.bloom(img, radius, weight), rtol=0, atol=1e-6 * img.max())


def _specs(**kw):
    return jcam.CameraSpec(**kw), tcam.CameraSpec(**kw)


def test_camera_movement_helpers():
    """rotate / translate / roll / pitch / yaw / rotate_x, _y, _z
    (reference GoblinCamera.h:110-185) as new specs, equal to goblin_tpu's."""
    spec = tcam.CameraSpec(position=(1.0, 2.0, 3.0))
    moved = tcam.translate(spec, (1.0, -2.0, 0.5))
    assert moved.position == (2.0, 0.0, 3.5)
    assert spec.position == (1.0, 2.0, 3.0)  # the original is untouched
    # yaw by 90 degrees: look (0, 0, 1) -> (1, 0, 0) for the identity
    np.testing.assert_allclose(tcam.yaw(spec, np.pi / 2).look, [1, 0, 0],
                               atol=1e-6)
    p = tcam.pitch(spec, np.pi / 2)
    np.testing.assert_allclose(np.linalg.norm(p.orientation), 1.0, atol=1e-6)
    np.testing.assert_allclose(p.look, [0, -1, 0], atol=1e-6)
    np.testing.assert_allclose(tcam.roll(spec, 1.0).look, spec.look,
                               atol=1e-6)
    js, ts = _specs(position=(0.5, -1.0, 2.0),
                    orientation=(0.352428, 0.114509, -0.883349, 0.287014))
    for name, args in (("translate", ((0.1, 0.2, -0.3),)),
                       ("rotate", ((1.0, 2.0, -0.5), 0.7)), ("roll", (0.3,)),
                       ("pitch", (-0.4,)), ("yaw", (1.1,)),
                       ("rotate_x", (0.2,)), ("rotate_y", (-0.9,)),
                       ("rotate_z", (2.0,))):
        a, b = getattr(jcam, name)(js, *args), getattr(tcam, name)(ts, *args)
        assert a.position == b.position and a.orientation == b.orientation
        np.testing.assert_array_equal(a.look, b.look)
        np.testing.assert_array_equal(a.right, b.right)
        np.testing.assert_array_equal(a.up, b.up)


def _cam():
    kw = dict(kind="perspective", position=(0.0, 0.0, -5.0),
              fov=np.deg2rad(60.0))
    return (jcam.CameraSpec(film=jfilm.FilmSpec(x_res=64, y_res=48), **kw),
            tcam.CameraSpec(film=tfilm.FilmSpec(x_res=64, y_res=48), **kw))


def _overlays(add):
    """The same debug data drawn by both packages onto a black image."""
    jc, tc = _cam()
    img = np.zeros((48, 64, 3), np.float32)
    out = []
    for cam, mod in ((jc, jdraw), (tc, tdraw)):
        dbg = mod.DebugData()
        add(dbg)
        out.append(np.asarray(mod.draw_overlay(img, cam, dbg)))
    np.testing.assert_array_equal(out[1], out[0])
    return out[1]


def test_line_rasterizes_center():
    out = _overlays(lambda d: d.add_ray([-1.0, 0.0, 0.0], [1.0, 0.0, 0.0],
                                        color=(0, 1, 0)))
    assert out[22:26, :, 1].max() == 1.0
    assert out[0, 0].sum() == 0.0 and out[-1, -1].sum() == 0.0


def test_point_splats_square():
    out = _overlays(lambda d: d.add_point([0.0, 0.0, 0.0], color=(1, 0, 0)))
    ys, xs = np.nonzero(out[..., 0])
    assert len(ys) == 9  # a 3 x 3 splat
    assert abs(xs.mean() - 32) <= 1.5 and abs(ys.mean() - 24) <= 1.5


def test_behind_camera_clipped():
    out = _overlays(lambda d: d.add_point([0.0, 0.0, -10.0], color=(1, 1, 1)))
    assert out.sum() == 0.0


def test_write_ppm_matches_goblin_tpu(tmp_path):
    img = _image(3, 12, 20) * 0.7
    texr.write_ppm(str(tmp_path / "t.ppm"), img)
    jexr.write_ppm(str(tmp_path / "j.ppm"), img)
    data = (tmp_path / "t.ppm").read_bytes()
    assert data == (tmp_path / "j.ppm").read_bytes()
    assert data.startswith(b"P6\n20 12\n255\n")
    assert len(data) == len(b"P6\n20 12\n255\n") + 20 * 12 * 3


@pytest.mark.parametrize("name", ["out.ppm", "out", "out.exr"])
def test_write_image_blooms_then_tone_maps(tmp_path, name):
    """write_image as goblin_tpu's: bloom, then tone mapping, into an EXR
    or an 8-bit PPM (".ppm" appended to a name without an extension)."""
    img = _image(4, 30, 40) * 3.0
    kw = dict(x_res=40, y_res=30, tone_mapping=True, bloom_radius=0.1,
              bloom_weight=0.2)
    paths = []
    for sub, spec_cls, write, arg in (
            ("t", tfilm.FilmSpec, tfilm.write_image, torch.as_tensor(img)),
            ("j", jfilm.FilmSpec, jfilm.write_image, img)):
        (tmp_path / sub).mkdir()
        spec = spec_cls(filename=str(tmp_path / sub / name), **kw)
        paths.append(write(spec, arg))
    assert paths[0].endswith(".exr" if name.endswith(".exr") else ".ppm")
    assert os.path.basename(paths[0]) == os.path.basename(paths[1])
    if name.endswith(".exr"):
        got, ref = texr.read_exr(paths[0]), texr.read_exr(paths[1])
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-7)
        want = jfilm.tone_map(jfilm.bloom(img, 0.1, 0.2))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
        return
    got = np.frombuffer(open(paths[0], "rb").read(), np.uint8).astype(int)
    ref = np.frombuffer(open(paths[1], "rb").read(), np.uint8).astype(int)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 1 and (got == ref).mean() > 0.999


def test_cli_writes_the_ppm_the_film_asks_for(tmp_path, monkeypatch):
    """The CLI on a scene whose film asks for tone mapping, bloom and a
    PPM writes that PPM (a relative name is taken from the working
    directory, as in goblin_tpu)."""
    (tmp_path / "quad.obj").write_text(
        "v -1 -1 0\nv 1 -1 0\nv 1 1 0\nv -1 1 0\nf 1 2 3\nf 1 3 4\n")
    doc = {
        "render_setting": {"sample_per_pixel": 1, "max_ray_depth": 2,
                           "render_method": "path_tracing"},
        "camera": {"position": [0, 0, -3], "fov": 60,
                   "film": {"resolution": [12, 8], "file": "quad.ppm",
                            "tone_mapping": True, "bloom_radius": 0.3,
                            "bloom_weight": 0.2},
                   "filter": {"type": "box", "width": [0.5, 0.5]}},
        "geometries": [{"name": "quad", "type": "mesh", "file": "quad.obj"}],
        "textures": [{"format": "color", "name": "w", "type": "constant",
                      "color": [0.8, 0.8, 0.8]}],
        "materials": [{"name": "m", "type": "lambert", "Kd": "w"}],
        "lights": [{"type": "point", "intensity": [5, 5, 5],
                    "position": [0, 0, -2]}],
        "primitives": [{"type": "model", "name": "q", "geometry": "quad",
                        "material": "m"},
                       {"type": "instance", "name": "q", "model": "q"}],
    }
    scene = tmp_path / "quad.json"
    scene.write_text(json.dumps(doc))
    out = tmp_path / "cwd"
    out.mkdir()
    monkeypatch.chdir(out)
    assert trender.main([str(scene), "--device", "cpu"]) == 0
    data = (out / "quad.ppm").read_bytes()
    header = b"P6\n12 8\n255\n"
    assert data.startswith(header) and len(data) == len(header) + 12 * 8 * 3
    pixels = np.frombuffer(data[len(header):], np.uint8)
    assert 0 < pixels.mean() < 255
