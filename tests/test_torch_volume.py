"""goblin_tpu_torch's participating media against goblin_tpu's on the CPU:
the mirrors of tests/test_volume.py, transmittance and the in-scatter
estimate eval_lv lane by lane for both kinds of volume, the .vol reader on
its three encodings and the committed examples/volumes/smoke.vol, the
loader's volume section, and the path tracer's images of
examples/bunny_fog.json and examples/bunny_smoke.json.

Same numpy inputs and sample streams in both packages. Bars: transmittance
and eval_lv lane by lane within rtol 1e-4 / atol 1e-6 (the grid's optical
depth is summed in another order, equi-angular sampling goes through atan2
and tan and the phase function through pow, which XLA and PyTorch round
differently); images >= 99% of pixels within 1e-4 + 1e-3 rel, means within
1e-3 rel.

One divergence is applied to goblin_tpu here at run time, never in its
files: the port's in-scatter shadow rays stop volume.LIGHT_GAP short of the
light sample, where goblin_tpu's end on it and an area light's own surface
occludes them on the lanes where float rounding says so
(test_goblin_tpu_lights_occlude_their_own_in_scatter shows it). The fixture
`light_gap` gives goblin_tpu's volume module the same cut.
"""

import contextlib
import dataclasses
import json
import os
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goblin_tpu.core.rng import hash_uniform as j_hash
from goblin_tpu.integrators import common as jcommon
from goblin_tpu.integrators import volume as jv
from goblin_tpu.integrators.path import make_li as j_path_li
from goblin_tpu.integrators.whitted import make_li as j_whitted_li
from goblin_tpu.scene import intersect as jscn
from goblin_tpu.scene import loader as jloader
from goblin_tpu_torch import assets
from goblin_tpu_torch import render as trender
from goblin_tpu_torch.core.rng import hash_uniform as t_hash
from goblin_tpu_torch.integrators import common as tcommon
from goblin_tpu_torch.integrators import volume as tv
from goblin_tpu_torch.integrators.path import make_li as t_path_li
from goblin_tpu_torch.lights import lights as tlt
from goblin_tpu_torch.scene import intersect as tscn
from goblin_tpu_torch.scene import loader as tloader
from test_torch_studio import PLANE_OBJ, _bar, _load_both, _np, _resized
from test_torch_textures import (_camera_rays,  # noqa: F401
                                 few_torch_threads, jax_render_unjitted)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FOG = os.path.join(REPO, "examples", "bunny_fog.json")
SMOKE = os.path.join(REPO, "examples", "bunny_smoke.json")
SMOKE_VOL = os.path.join(REPO, "examples", "volumes", "smoke.vol")
TOL = dict(rtol=1e-4, atol=1e-6)


class _GapIntersect:
    """goblin_tpu's scene.intersect with the port's shadow-ray cut: occluded
    ends LIGHT_GAP short of maxt."""

    def __getattr__(self, name):
        return getattr(jscn, name)

    @staticmethod
    def occluded(scene, meta, o, d, mint, maxt, sort=None):
        return jscn.occluded(scene, meta, o, d, mint, maxt - tv.LIGHT_GAP,
                             sort)


@contextlib.contextmanager
def light_gap_in_goblin_tpu():
    """goblin_tpu's volume module with the port's shadow-ray cut, for the
    length of the block."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jv, "scn", _GapIntersect())
        yield


@pytest.fixture
def light_gap():
    with light_gap_in_goblin_tpu():
        yield


def _t(a):
    return torch.as_tensor(np.array(a))


def _specs(**kw):
    """The same volume as a goblin_tpu and a goblin_tpu_torch VolumeSpec."""
    m = np.eye(4, dtype=np.float32)
    base = dict(to_world=tuple(m.reshape(-1).tolist()),
                to_local=tuple(m.reshape(-1).tolist()),
                box_min=(-1.0, -1.0, -1.0), box_max=(1.0, 1.0, 1.0))
    base.update(kw)
    return jv.VolumeSpec(**base), tv.VolumeSpec(**base)


def test_phase_hg_normalized():
    """Integral over the sphere is 1 for any g; lane by lane equal to
    goblin_tpu's (pow rounds differently: rtol 1e-5)."""
    rng = np.random.default_rng(0)
    n = 200_000
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    wo = np.tile(np.float32([0.0, 0.0, 1.0]), (n, 1))
    for g in (0.0, 0.4, -0.6, 5e-4):
        ph = _np(tv.phase_hg(_t(d), _t(wo), g))
        np.testing.assert_allclose(ph.mean() * 4 * np.pi, 1.0, atol=0.02)
        np.testing.assert_allclose(
            ph, np.asarray(jv.phase_hg(jnp.asarray(d), jnp.asarray(wo), g)),
            rtol=1e-5)


def test_homogeneous_transmittance_beer():
    _, vol = _specs(attenuation=(0.5, 1.0, 2.0))
    d = _t([[0.0, 0.0, 1.0]])
    tr = tv.transmittance(vol, {}, _t([[0.0, 0.0, -5.0]]), d, torch.zeros(1),
                          torch.full((1,), 1e30), torch.zeros(1))
    # the ray crosses 2 units of the box
    np.testing.assert_allclose(_np(tr)[0], np.exp(-2 * np.array([0.5, 1, 2])),
                               rtol=1e-5)
    tr2 = tv.transmittance(vol, {}, _t([[5.0, 0.0, -5.0]]), d, torch.zeros(1),
                           torch.full((1,), 1e30), torch.zeros(1))
    np.testing.assert_allclose(_np(tr2)[0], 1.0)


def test_volume_intersect_segment():
    """The segment of tests/test_volume.py, and axis-aligned rays (a zero
    direction component is taken as 1e-30) of a rotated, scaled box against
    goblin_tpu's."""
    _, vol = _specs()
    hit, t0, t1 = tv.intersect_volume(vol, _t([[0.0, 0.0, -3.0]]),
                                      _t([[0.0, 0.0, 1.0]]), torch.zeros(1),
                                      torch.full((1,), 1e30))
    assert bool(hit[0])
    np.testing.assert_allclose([float(t0[0]), float(t1[0])], [2.0, 4.0],
                               rtol=1e-5)
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = np.diag([2.0, 0.5, 1.0])
    m[:3, 3] = (0.3, -0.2, 0.1)
    jvol, tvol = _specs(to_world=tuple(m.reshape(-1).tolist()),
                        to_local=tuple(np.linalg.inv(m).reshape(-1).tolist()))
    rng = np.random.default_rng(3)
    n = 3000
    o = rng.uniform(-2.5, 2.5, (n, 3)).astype(np.float32)
    d = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)] * rng.choice(
        np.float32([-1, 1]), (n, 1))
    d[: n // 2] = rng.normal(size=(n // 2, 3))
    mint = np.zeros(n, np.float32)
    maxt = rng.uniform(1, 10, n).astype(np.float32)
    ref = jv.intersect_volume(jvol, *(jnp.asarray(a) for a in (o, d, mint, maxt)))
    got = tv.intersect_volume(tvol, *(_t(a) for a in (o, d, mint, maxt)))
    np.testing.assert_array_equal(_np(got[0]), np.asarray(ref[0]))
    hit = np.asarray(ref[0])
    assert 0.05 < hit[n // 2:].mean() < 0.9
    for a, b in zip(got[1:], ref[1:]):
        np.testing.assert_allclose(_np(a)[hit], np.asarray(b)[hit], **TOL)


def _scene_with_volume(tmp_path, volume, lights=None):
    doc = {
        "render_setting": {"render_method": "path_tracing",
                           "sample_per_pixel": 4, "max_ray_depth": 2},
        "camera": {"position": [0, 1.0, -4.0], "fov": 40.0,
                   "film": {"resolution": [12, 10]},
                   "filter": {"type": "box", "width": [0.5, 0.5]}},
        "geometries": [{"name": "floor", "type": "mesh", "file": "plane.obj"}],
        "textures": [{"format": "color", "name": "w", "type": "constant",
                      "color": [0.7, 0.7, 0.7]}],
        "materials": [{"name": "diff", "type": "lambert", "Kd": "w"}],
        "primitives": [
            {"type": "model", "name": "fm", "geometry": "floor",
             "material": "diff"},
            {"type": "instance", "name": "fi", "model": "fm",
             "position": [0, -0.5, 0], "scale": [20, 20, 20]}],
        "lights": lights or [{"name": "key", "type": "point",
                              "intensity": [20, 20, 20],
                              "position": [0, 4, -1]}],
        "volume": volume,
    }
    (tmp_path / "plane.obj").write_text(PLANE_OBJ)
    p = tmp_path / "scene.json"
    p.write_text(json.dumps(doc))
    return str(p)


def _render(path, spp):
    scene, meta = tloader.load_scene(path, device="cpu")
    return tcommon.render(scene, meta, t_path_li(meta), spp=spp,
                          chunk_size=128).numpy(), meta


def test_absorbing_volume_dims_image(tmp_path):
    box = {"box_min": [-2, -2, -2], "box_max": [2, 2, 2]}
    img_c, _ = _render(_scene_with_volume(tmp_path, {
        "type": "homogeneous", "attenuation": [0.0, 0.0, 0.0], **box}), 4)
    img_f, meta_f = _render(_scene_with_volume(tmp_path, {
        "type": "homogeneous", "attenuation": [0.8, 0.8, 0.8], **box}), 4)
    assert meta_f.volume is not None and np.isfinite(img_f).all()
    # absorbing fog darkens every lit pixel
    lit = img_c[..., 0] > 0.01
    assert lit.any()
    assert (img_f[..., 0][lit] < img_c[..., 0][lit] + 1e-6).all()
    assert img_f[..., 0][lit].mean() < 0.8 * img_c[..., 0][lit].mean()


def test_emissive_volume_glows(tmp_path):
    """A scattering fog makes in-scatter where no surface is seen."""
    img, _ = _render(_scene_with_volume(tmp_path, {
        "type": "homogeneous", "attenuation": [0.5, 0.5, 0.5],
        "albedo": [0.9, 0.9, 0.9], "box_min": [-1.5, -1.5, -1.5],
        "box_max": [1.5, 1.5, 1.5]}), 8)
    assert np.isfinite(img).all() and img.max() > 0


def _vol_bytes(grid, enc, bbox=(0, 0, 0, 1, 1, 1)):
    nz, ny, nx = grid.shape
    data = {1: grid.astype(np.float32), 2: grid.astype(np.float16),
            3: grid.astype(np.uint8)}[enc]
    return (b"VOL" + bytes([3]) + struct.pack("<iiiii", enc, nx, ny, nz, 1)
            + struct.pack("<6f", *bbox) + data.tobytes())


@pytest.mark.parametrize("enc", [1, 2, 3])
def test_vol_file_roundtrip(tmp_path, enc):
    """tests/test_volume.py's round trip on each encoding, read by both
    packages alike (uint8 reads as value / 255)."""
    nx, ny, nz = 4, 3, 2
    grid = np.arange(nx * ny * nz, dtype=np.float32).reshape(nz, ny, nx)
    p = tmp_path / "t.vol"
    p.write_bytes(_vol_bytes(grid, enc, (0, 0, 0, 1, 2, 3)))
    g, bbox = tv.load_vol(str(p))
    want = grid / 255.0 if enc == 3 else grid
    np.testing.assert_array_equal(g, want.astype(np.float32))
    assert bbox == (0, 0, 0, 1, 2, 3)
    jg, jbbox = jv.load_vol(str(p))
    np.testing.assert_array_equal(g, jg)
    assert jbbox == bbox
    if enc == 2:  # the port's writer (float16) makes the same bytes
        q = tmp_path / "w.vol"
        tv.write_vol(str(q), want, (0, 0, 0, 1, 2, 3))
        assert q.read_bytes() == p.read_bytes()


def test_smoke_vol_is_the_committed_function():
    """examples/volumes/smoke.vol is make_smoke_grid()'s grid, float16, over
    the unit box, and goblin_tpu reads the same grid."""
    grid, bbox = tv.load_vol(SMOKE_VOL)
    made = assets.make_smoke_grid()
    assert made.dtype == np.float16 and made.shape == (64, 64, 64)
    np.testing.assert_array_equal(grid, made.astype(np.float32))
    assert bbox == assets.SMOKE_BBOX
    assert os.path.getsize(SMOKE_VOL) == 48 + 2 * 64 ** 3
    jg, _ = jv.load_vol(SMOKE_VOL)
    np.testing.assert_array_equal(grid, jg)
    assert 0.1 < (grid > 0.5).mean() < 0.5 and grid.max() < 8.0


@pytest.fixture(scope="module")
def fog():
    js, jm, ts, tm = _load_both(FOG, {"sample_per_pixel": 1})
    return js, _resized(jm, 24, 18), ts, _resized(tm, 24, 18)


@pytest.fixture(scope="module")
def smoke():
    js, jm, ts, tm = _load_both(SMOKE, {"sample_per_pixel": 1})
    return js, _resized(jm, 24, 18), ts, _resized(tm, 24, 18)


def test_new_scenes_are_what_the_slice_needs(fog, smoke):
    """The fog scene: the studio scene in a homogeneous box that holds the
    camera, the bunnies and the lights, a jade subsurface bunny, tone mapping
    and bloom into a PPM. The smoke scene: a grid around the two bunnies
    whose march takes 32-64 steps, a marble bunny from the defaults arm."""
    _, _, _, tm = fog
    vol = tm.volume
    assert vol.kind == "homogeneous" and vol.sample_num == 5
    assert 0.1 <= min(vol.attenuation) <= max(vol.attenuation) <= 0.3
    assert np.allclose(vol.albedo, 0.8) and vol.g == 0.3
    inside = [tm.camera.position, (0.2, 1.3, 0.1), (0.9, -0.45, -1.0),
              (-10, 5, 15), (0.4, -1, 0), (-0.55, -1, -0.35)]
    assert all(vol.box_min[i] < p[i] < vol.box_max[i]
               for p in inside for i in range(3))
    film = tm.camera.film
    assert film.tone_mapping and (film.bloom_radius, film.bloom_weight) == (
        0.02, 0.1) and film.filename == "bunny_fog.ppm"
    assert tm.has_bssrdf and tm.settings["bssrdf_sample_num"] == 4
    assert tm.settings["sample_per_pixel"] == 1  # overridden from 16
    js, jm, ts, tm = smoke
    assert tm.volume.kind == "heterogeneous"
    assert 32 <= tv.march_steps(tm.volume) == jv.march_steps(jm.volume) <= 64
    assert tm.volume.grid_shape == (64, 64, 64)
    assert tm.has_bssrdf and tm.camera.film.filename.endswith(".exr")
    np.testing.assert_array_equal(_np(ts["vol_grid"]),
                                  np.asarray(js["vol_grid"]))


def test_loader_volume_tables_match(fog, smoke):
    """Both kinds: the specs field by field (goblin_tpu keeps numpy floats
    where the port keeps Python floats of the same values) and the grid."""
    for js, jm, ts, tm in (fog, smoke):
        for f in dataclasses.fields(jm.volume):
            a, b = getattr(jm.volume, f.name), getattr(tm.volume, f.name)
            if isinstance(a, tuple):
                np.testing.assert_array_equal(np.float64(a), np.float64(b),
                                              err_msg=f.name)
            else:
                assert a == b, f.name
    assert "vol_grid" not in fog[2] and "vol_grid" in smoke[2]


def test_loader_raises_on_a_grid_that_does_not_load(tmp_path):
    """A deliberate divergence: goblin_tpu prints and renders an empty
    1 x 1 x 1 grid; the port raises ValueError."""
    path = _scene_with_volume(tmp_path, {"type": "heterogeneous",
                                         "density_grid": "missing.vol"})
    with pytest.raises(ValueError, match="density grid"):
        tloader.load_scene(path, device="cpu")
    (tmp_path / "bad.vol").write_bytes(b"NOTAVOL" + bytes(64))
    path = _scene_with_volume(tmp_path, {"type": "heterogeneous",
                                         "density_grid": "bad.vol"})
    with pytest.raises(ValueError, match="not a .vol file"):
        tloader.load_scene(path, device="cpu")
    _, jm = jloader.load_scene(path)
    assert jm.volume.grid_shape == (1, 1, 1)


def _segment_inputs(both):
    """Camera rays of the 24 x 18 frame with maxt at their camera hit."""
    js, jm, ts, tm = both
    jray, jids, tray, tids = _camera_rays(jm, tm)
    jf = jscn.intersect(js, jm, jray["o"], jray["d"], jray["mint"],
                        jray["maxt"])
    tf = tscn.intersect(ts, tm, tray["o"], tray["d"], tray["mint"],
                        tray["maxt"])
    return ((jray, jids, jnp.minimum(jf["t"], 3.0e37)),
            (tray, tids, torch.clamp(tf["t"], max=3.0e37)))


@pytest.mark.parametrize("which", ["fog", "smoke"])
def test_transmittance_matches(request, which):
    """The camera segments' transmittance, and a set of rays from inside
    the volume towards random points, lane by lane."""
    both = request.getfixturevalue(which)
    js, jm, ts, tm = both
    (jray, jids, jmax), (tray, tids, tmax) = _segment_inputs(both)
    ju = j_hash(0, jids, 0, 0x7F0, 0)
    tu = t_hash(0, tids, 0, tv.KEY_JITTER, 0)
    ref = jv.transmittance(jm.volume, js, jray["o"], jray["d"], jray["mint"],
                           jmax, ju)
    got = tv.transmittance(tm.volume, ts, tray["o"], tray["d"], tray["mint"],
                           tmax, tu)
    np.testing.assert_allclose(_np(got), np.asarray(ref), **TOL)
    assert (np.asarray(ref) < 0.999).mean() > 0.3
    rng = np.random.default_rng(5)
    n = 2000
    o = rng.uniform(-1.2, 0.8, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    maxt = rng.uniform(0.1, 4.0, n).astype(np.float32)
    u = rng.uniform(0, 1, n).astype(np.float32)
    args = (o, d, np.zeros(n, np.float32), maxt, u)
    ref = jv.transmittance(jm.volume, js, *(jnp.asarray(a) for a in args))
    got = tv.transmittance(tm.volume, ts, *(_t(a) for a in args))
    np.testing.assert_allclose(_np(got), np.asarray(ref), **TOL)


@pytest.mark.parametrize("which", ["fog", "smoke"])
def test_eval_lv_matches(request, which, light_gap):
    """The in-scatter estimate over the camera segments, lane by lane:
    homogeneous (5 samples, equi-angular and distance sampling with MIS
    towards the quad, sphere and spot lights) and heterogeneous (the
    march's light picks and shadow rays and each step's march towards the
    light)."""
    both = request.getfixturevalue(which)
    js, jm, ts, tm = both
    (jray, jids, jmax), (tray, tids, tmax) = _segment_inputs(both)
    ref = jv.eval_lv(js, jm, jm.volume, jray["o"], jray["d"], jray["mint"],
                     jmax, jids, 0, 0)
    got = tv.eval_lv(ts, tm, tm.volume, tray["o"], tray["d"], tray["mint"],
                     tmax, tids, 0, 0)
    ref = np.asarray(ref)
    np.testing.assert_allclose(_np(got), ref, **TOL)
    assert (ref > 0).all(axis=-1).mean() > 0.5


def test_march_light_picks_are_the_hash(smoke):
    """goblin_tpu picks the march's light with u(32 + 0) * 0 + hash(0x7F2,
    i): the hash itself. The port draws the hash; the picks are equal."""
    js, jm, ts, tm = smoke
    ids = np.arange(5000, dtype=np.int32)
    for i in (0, 7, 43):
        jexpr = (j_hash(0, jnp.asarray(ids), 0, 0x7F1, 32) * 0
                 + j_hash(0, jnp.asarray(ids), 0, 0x7F2, i))
        tu = t_hash(0, _t(ids), 0, tv.KEY_MARCH[0], i)
        np.testing.assert_array_equal(_np(tu), np.asarray(jexpr))
        lid, _ = tlt.pick_light(ts["lights"], tu)
        assert set(_np(lid).tolist()) == {0, 1, 2}


def test_goblin_tpu_lights_occlude_their_own_in_scatter(fog):
    """Why the port's volume shadow rays stop LIGHT_GAP short: goblin_tpu's
    end on the light sample (eps 0), so the sphere and quad lights' own
    surfaces decide by rounding whether they block their own rays. From
    in-scatter points of the fog, aimed at area-light samples: goblin_tpu's
    query reports a share of them blocked that the cut query does not, in
    both packages, and none of the extra blocks is nearer than the light."""
    js, jm, ts, tm = fog
    rng = np.random.default_rng(8)
    n = 4000
    p = np.stack([rng.uniform(-0.5, 1.5, n), rng.uniform(-0.5, 1.0, n),
                  rng.uniform(-0.8, 0.8, n)], -1).astype(np.float32)
    lid = rng.integers(0, 2, n)  # the quad light and the sphere light
    u1, u2 = (rng.uniform(0, 1, n).astype(np.float32) for _ in range(2))
    ls = tlt.sample_li(ts["lights"], {"em_rows": ts["em_rows"]}, _t(lid),
                       _t(p), torch.zeros(n), _t(u1), _t(u2))
    ok = _np(ls["pdf"]) > 0
    mint = torch.full((n,), tv.SHADOW_MINT)
    at_light = _np(tscn.occluded(ts, tm, _t(p), ls["wi"], mint,
                                 ls["shadow_maxt"]))
    cut = _np(tscn.occluded(ts, tm, _t(p), ls["wi"], mint,
                            ls["shadow_maxt"] - tv.LIGHT_GAP))
    j_at = np.asarray(jscn.occluded(
        js, jm, jnp.asarray(p), jnp.asarray(_np(ls["wi"])),
        jnp.full((n,), tv.SHADOW_MINT), jnp.asarray(_np(ls["shadow_maxt"]))))
    self_blocked = ok & at_light & ~cut
    assert (cut <= at_light).all()
    assert self_blocked.mean() > 0.05
    assert (ok & j_at & ~cut).mean() > 0.05


def _pt_both(both, depth):
    js, jm, ts, tm = both
    jm = dataclasses.replace(jm, settings=dict(jm.settings,
                                               max_ray_depth=depth))
    tm = dataclasses.replace(tm, settings=dict(tm.settings,
                                               max_ray_depth=depth))
    with light_gap_in_goblin_tpu():
        ref = jax_render_unjitted(js, jm, j_path_li(jm))
    got = tcommon.render(ts, tm, t_path_li(tm)).numpy()
    return got, ref


@pytest.mark.parametrize("which", ["fog", "smoke"])
def test_new_scene_path_tracing_matches_goblin_tpu(request, which):
    """24 x 18, 1 spp, depth 2: the subsurface term at the camera hit, one
    bounce, and the volume over the camera segment up to the camera hit
    (not the bounce's), against goblin_tpu's path tracer op by op."""
    got, ref = _pt_both(request.getfixturevalue(which), 2)
    assert got.shape == ref.shape == (18, 24, 3) and np.isfinite(got).all()
    frac, rel = _bar(got, ref)
    assert frac >= 0.99 and rel <= 1e-3 and got.mean() > 0.05


def test_only_path_tracing_applies_the_volume(tmp_path):
    """As in goblin_tpu, the volume enters the path tracer alone: AO,
    Whitted, light tracing, BDPT and SPPM render the scene with the fog
    exactly as without it (goblin_tpu's Whitted shown alike), while the
    path tracer's image changes."""
    fog_vol = {"type": "homogeneous", "attenuation": [0.5, 0.5, 0.5],
               "albedo": [0.9, 0.9, 0.9], "box_min": [-2, -2, -2],
               "box_max": [2, 2, 2]}
    clear = tmp_path / "clear"
    foggy = tmp_path / "foggy"
    clear.mkdir()
    foggy.mkdir()
    paths = (_scene_with_volume(clear, None), _scene_with_volume(foggy, fog_vol))
    for method in ("path_tracing", "ao", "whitted", "light_tracing", "bdpt",
                   "sppm"):
        imgs = [trender.render_context(p, {"render_method": method,
                                           "sample_per_pixel": 1},
                                       device="cpu")[0].numpy()
                for p in paths]
        assert imgs[0].mean() > 0, method
        if method == "path_tracing":
            assert not np.array_equal(imgs[0], imgs[1])
        else:
            np.testing.assert_array_equal(imgs[1], imgs[0], err_msg=method)
    refs = []
    for p in paths:
        js, jm = jloader.load_scene(p, {"render_method": "whitted"})
        refs.append(np.asarray(jcommon.render(js, jm, j_whitted_li(jm))))
    np.testing.assert_array_equal(refs[1], refs[0])


def _count_traces(monkeypatch):
    """Every trace launch a path makes, in order: (any_hit, live lanes)."""
    seen = []
    real = tscn.trace

    def spy(scene, o, d, mint, maxt, **kw):
        seen.append((kw.get("any_hit", False), int((mint < maxt).sum())))
        return real(scene, o, d, mint, maxt, **kw)

    monkeypatch.setattr(tscn, "trace", spy)
    return seen


@pytest.mark.parametrize("which", ["fog", "smoke"])
def test_path_tracing_launches_a_chunk(request, which, monkeypatch):
    """A chunk of the path tracer at depth 5: the camera rays, the BSSRDF's
    4 trace calls a sample at the camera hit (bssrdf_sample_num 4), 4
    bounces of 4 punch-through rounds and a continuation, then the volume:
    2 any-hit shadow rays a homogeneous sample (5 samples), or one a march
    step (march_steps of the grid). chip_smoke.py counts the same on the
    card."""
    _, _, ts, tm = request.getfixturevalue(which)
    tm = dataclasses.replace(tm, settings=dict(tm.settings, max_ray_depth=5))
    seen = _count_traces(monkeypatch)
    tcommon.render(ts, tm, t_path_li(tm))
    per_volume = (2 * tm.volume.sample_num if which == "fog"
                  else tv.march_steps(tm.volume))
    assert len(seen) == 1 + 4 * 4 + 4 * (4 + 1) + per_volume
    assert [s[0] for s in seen[1:17]] == [False, True] * 8
    assert all(s[0] for s in seen[-per_volume:])
