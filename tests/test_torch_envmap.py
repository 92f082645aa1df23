"""The image-based light of goblin_tpu_torch against goblin_tpu's on the
CPU: the CDF tables, the environment map's bake, radiance, sampling and
pdf, the light table's image-based arms, examples/textures/sky.exr, and
renders of scenes lit by a map under path tracing, Whitted, SPPM, light
tracing and BDPT (BDPT's own checks: tests/test_torch_bdpt.py).

Tolerances. jnp.cumsum on XLA-CPU and torch.cumsum round prefix sums
differently: the CDF tables agree within 1e-6, picked indices exactly
except on lanes within 1e-6 of a step, continuous inversions within 1e-5.
atan2 / acos round differently in the two packages (PERF.md section 6, PR
4), which moves a lookup's (s, t) by an ulp: radiances within 1e-4 +
1e-3 rel on >= 99% of lanes, pdfs within rtol 1e-4 on >= 99.9%. Images to
PERF.md's bar (>= 99% of pixels within 1e-4 + 1e-3 rel, means within
1e-3 rel).
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goblin_tpu import splatting as jsplat
from goblin_tpu.core import sampling as jsp
from goblin_tpu.integrators import bdpt as jbdpt
from goblin_tpu.integrators import common as jcommon
from goblin_tpu.integrators import sppm as jsppm
from goblin_tpu.integrators.path import make_li as j_path_li
from goblin_tpu.integrators.whitted import make_li as j_whitted_li
from goblin_tpu.io.exr import read_exr as j_read_exr
from goblin_tpu.io.exr import write_exr as j_write_exr
from goblin_tpu.lights import envmap as jenv
from goblin_tpu.lights import lights as jl
from goblin_tpu_torch import assets as tassets
from goblin_tpu_torch import splatting as tsplat
from goblin_tpu_torch.core import sampling as tsp
from goblin_tpu_torch.integrators import bdpt as tbdpt
from goblin_tpu_torch.integrators import common as tcommon
from goblin_tpu_torch.integrators import sppm as tsppm
from goblin_tpu_torch.integrators.whitted import make_li as t_whitted_li
from goblin_tpu_torch.io.exr import read_exr as t_read_exr
from goblin_tpu_torch.lights import envmap as tenv
from goblin_tpu_torch.lights import lights as tl
from goblin_tpu_torch.render import make_li as t_make_li
from goblin_tpu_torch.scene import loader as tloader
from test_torch_studio import REPO, _bar, _load_both, _np, _resized
from test_torch_textures import (few_torch_threads,  # noqa: F401
                                 jax_render_unjitted)

SKY = os.path.join(REPO, "examples", "bunny_sky.json")
SKY_EXR = os.path.join(REPO, "examples", "textures", "sky.exr")


def _t(a):
    return torch.as_tensor(np.array(a))


def _u(seed, n):
    return np.random.default_rng(seed).uniform(0, 1, (2, n)).astype(np.float32)


def _near_step(cdf, u, tol=1e-6):
    """Lanes whose u lies within tol of an entry of the table cdf (..., N+1)
    (per lane when cdf is batched)."""
    return (np.abs(np.asarray(cdf) - np.asarray(u)[..., None]) < tol).any(-1)


# --- the CDF tables (mirrors of tests/test_sampling.py) ---------------------

def test_cdf1d_discrete():
    t = tsp.build_cdf_1d(torch.tensor([1.0, 2.0, 3.0, 4.0]))
    u1, _ = _u(7, 100_000)
    idx, pdf = tsp.sample_cdf_discrete(t, _t(u1))
    counts = np.bincount(idx.numpy(), minlength=4) / 100_000
    np.testing.assert_allclose(counts, [0.1, 0.2, 0.3, 0.4], atol=5e-3)
    np.testing.assert_allclose(pdf.numpy(), counts[idx.numpy()], atol=5e-3)


def test_cdf1d_continuous_inversion():
    t = tsp.build_cdf_1d(torch.tensor([0.0, 1.0, 4.0, 1.0]))
    u1, _ = _u(8, 100_000)
    x, _, _ = tsp.sample_cdf_continuous(t, _t(u1))
    xs = x.numpy()
    assert xs.min() >= 0.25 - 1e-4  # the zero-density first cell is skipped
    hist, _ = np.histogram(xs, bins=4, range=(0, 1), density=True)
    np.testing.assert_allclose(hist, [0, 4 / 6, 16 / 6, 4 / 6], atol=0.05)


def test_cdf2d_product_distribution():
    t = tsp.build_cdf_2d(torch.tensor(np.outer([1.0, 3.0], [2.0, 1.0, 1.0]),
                                      dtype=torch.float32))
    u1, u2 = _u(9, 100_000)
    uv, pdf = tsp.sample_cdf_2d(t, _t(u1), _t(u2))
    assert ((uv[:, 1] > 0.5).float().mean() - 0.75).abs() <= 5e-3
    np.testing.assert_allclose(pdf.numpy(),
                               tsp.pdf_cdf_2d(t, uv[:, 0], uv[:, 1]).numpy(),
                               rtol=1e-4)


def test_cdf_tables_and_picks_match_goblin_tpu():
    """A 37 x 53 table with a zero row, zero columns and a flat run, 20,000
    lanes through every CDF function of both packages."""
    rng = np.random.default_rng(0)
    f = rng.uniform(0, 1, (37, 53)).astype(np.float32)
    f[3] = 0.0
    f[:, 5:9] = 0.0
    f[10, 20:30] = 0.25
    j = jsp.build_cdf_2d(jnp.asarray(f))
    t = tsp.build_cdf_2d(torch.as_tensor(f))
    assert t["shape"] == j["shape"] == (37, 53)
    for part in ("cond", "marg"):
        assert t[part]["count"] == j[part]["count"]
        for k in ("func", "cdf", "integral"):
            np.testing.assert_allclose(_np(t[part][k]), np.asarray(j[part][k]),
                                       rtol=0, atol=1e-6, err_msg=k)
    np.testing.assert_array_equal(_np(t["cond"]["func"]), f)
    u1, u2 = _u(1, 20_000)
    u1[:50] = np.asarray(j["marg"]["cdf"])[5]  # exactly on a step
    marg_cdf = np.asarray(j["marg"]["cdf"])
    far = ~_near_step(marg_cdf, u1)
    ji, jp = jsp.sample_cdf_discrete(j["marg"], jnp.asarray(u1))
    ti, tp = tsp.sample_cdf_discrete(t["marg"], _t(u1))
    np.testing.assert_array_equal(ti.numpy()[far], np.asarray(ji)[far])
    np.testing.assert_allclose(tp.numpy()[far], np.asarray(jp)[far], rtol=1e-5)
    assert far.mean() > 0.99 and (ti.numpy()[:50] == 5).all()
    jx, jpc, jic = jsp.sample_cdf_continuous(j["marg"], jnp.asarray(u1))
    tx, tpc, tic = tsp.sample_cdf_continuous(t["marg"], _t(u1))
    np.testing.assert_array_equal(tic.numpy()[far], np.asarray(jic)[far])
    np.testing.assert_allclose(tx.numpy()[far], np.asarray(jx)[far], atol=1e-5)
    np.testing.assert_allclose(tpc.numpy()[far], np.asarray(jpc)[far],
                               rtol=1e-5)
    juv, jpdf = jsp.sample_cdf_2d(j, jnp.asarray(u1), jnp.asarray(u2))
    tuv, tpdf = tsp.sample_cdf_2d(t, _t(u1), _t(u2))
    rows = np.asarray(jic)
    far2 = far & ~_near_step(np.asarray(j["cond"]["cdf"])[rows], u2)
    assert far2.mean() > 0.99
    np.testing.assert_allclose(tuv.numpy()[far2], np.asarray(juv)[far2],
                               atol=1e-5)
    np.testing.assert_allclose(tpdf.numpy()[far2], np.asarray(jpdf)[far2],
                               rtol=1e-5)
    # the zero columns are never picked
    cols = np.floor(tuv.numpy()[:, 0] * 53).astype(int)
    assert not np.isin(cols, [5, 6, 7, 8]).any()
    u, v = _u(2, 20_000)
    np.testing.assert_allclose(
        tsp.pdf_cdf_2d(t, _t(u), _t(v)).numpy(),
        np.asarray(jsp.pdf_cdf_2d(j, jnp.asarray(u), jnp.asarray(v))),
        rtol=1e-6)


# --- the environment map ----------------------------------------------------

def _q(*q):
    q = np.float32(q)
    return q / np.linalg.norm(q)


ENV_IMAGES = {
    # the sky scene's map: 256 wide, one downsampling level (ds = 1)
    "sky": lambda: tassets.make_sky_image(),
    # 600 wide: the distribution is built on a 3x-downsampled level
    "noise": lambda: np.random.default_rng(3).uniform(
        0, 2, (150, 600, 3)).astype(np.float32),
}


@pytest.fixture(scope="module", params=sorted(ENV_IMAGES))
def envs(request):
    img = ENV_IMAGES[request.param]()
    q = _q(0.9, 0.1, 0.3, 0.2)
    je = jenv.bake_env(img, (1.0, 0.9, 0.8), q)
    te = tenv.bake_env(img, (1.0, 0.9, 0.8), q, "cpu")
    return request.param, {"env": je}, {"env": te}


def test_bake_env_tables_match(envs):
    name, js, ts = envs
    je, te = js["env"], ts["env"]
    for k in ("img", "rot", "mean"):
        np.testing.assert_array_equal(_np(te[k]), np.asarray(je[k]), err_msg=k)
    assert te["cdf"]["shape"] == je["cdf"]["shape"] == (
        (128, 256) if name == "sky" else (50, 200))
    for part in ("cond", "marg"):
        for k in ("func", "cdf", "integral"):
            np.testing.assert_allclose(
                _np(te["cdf"][part][k]), np.asarray(je["cdf"][part][k]),
                rtol=1e-6, atol=1e-6, err_msg=f"{part}.{k}")


def _close(got, ref, share):
    close = np.abs(got - ref) <= 1e-4 + 1e-3 * np.abs(ref)
    assert close.all(axis=-1).mean() >= share


def test_eval_sample_pdf_env_match(envs):
    """20,000 directions and 20,000 samples, lane by lane."""
    name, js, ts = envs
    rng = np.random.default_rng(4)
    n = 20_000
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[:20] = np.asarray(js["env"]["rot"])[:, 2]  # the map's poles
    d[20:40] = -np.asarray(js["env"]["rot"])[:, 2]
    le = tenv.eval_env(ts, None, _t(d)).numpy()
    _close(le, np.asarray(jenv.eval_env(js, None, jnp.asarray(d))), 0.99)
    assert np.isfinite(le).all() and (le >= 0).all()
    pdf = tenv.pdf_env(ts, None, _t(d)).numpy()
    ref = np.asarray(jenv.pdf_env(js, None, jnp.asarray(d)))
    ok = np.abs(pdf - ref) <= 1e-4 * np.abs(ref)
    assert ok.mean() >= 0.999 and (pdf >= 0).all()
    u1, u2 = _u(5, n)
    jli, jwi, jpdf = jenv.sample_env(js, None, jnp.asarray(u1), jnp.asarray(u2))
    tli, twi, tpdf = tenv.sample_env(ts, None, _t(u1), _t(u2))
    _close(tli.numpy(), np.asarray(jli), 0.95 if name == "noise" else 0.99)
    np.testing.assert_allclose(twi.numpy(), np.asarray(jwi), atol=1e-4)
    np.testing.assert_allclose(np.linalg.norm(twi.numpy(), axis=-1), 1.0,
                               atol=1e-5)
    ok = np.abs(tpdf.numpy() - np.asarray(jpdf)) <= 1e-4 * np.asarray(jpdf)
    assert ok.mean() >= 0.999
    # the sampled pdf is pdf_env of the sampled direction, but where the
    # direction's round trip lands in the neighbouring cell
    back = tenv.pdf_env(ts, None, twi).numpy()
    assert (np.abs(back - tpdf.numpy()) <= 2e-3 * tpdf.numpy()).mean() >= 0.999


def test_env_importance_sampling_follows_the_map():
    """Sampling and pdf agree with the map: the estimate of the map's mean
    radiance through importance sampling equals its solid-angle mean."""
    ts = {"env": tenv.bake_env(tassets.make_sky_image(), (1, 1, 1),
                               (1.0, 0.0, 0.0, 0.0), "cpu")}
    u1, u2 = _u(6, 200_000)
    li, wi, pdf = tenv.sample_env(ts, None, _t(u1), _t(u2))
    est = (li / pdf[:, None]).mean(dim=0) / (4 * np.pi)
    d = np.random.default_rng(7).normal(size=(400_000, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ref = tenv.eval_env(ts, None, _t(d)).mean(dim=0)
    np.testing.assert_allclose(est.numpy(), ref.numpy(), rtol=0.03)
    # the sun's few texels take a tenth of the samples
    sun = (li.sum(dim=-1) > 10.0).float().mean()
    assert 0.05 < float(sun) < 0.2


# --- the light table's image-based arms -------------------------------------

def _ibl_tables(env_power):
    jb, tb = jl.LightsBuild(), tl.LightsBuild()
    for b in (jb, tb):
        b.add(tl.LIGHT_POINT, (3.0, 2.0, 1.0), position=(0.2, 1.0, 0.3))
        b.add(tl.LIGHT_IBL, (1.0, 0.9, 0.8))
    wc, wr = np.float32([0.1, -0.2, 0.3]), 4.5
    jlt = jl.bake_lights(jb, [], [], wc, wr, env_luminance_power=env_power)
    tlt = tl.bake_lights(tb, [], [], wc, wr, "cpu",
                         env_luminance_power=env_power)
    return jlt, tlt


def test_ibl_light_table_and_emission_match():
    """bake_lights' power, sample_li's Li 0, and sample_emission,
    eval_emission and pdf_emission_* on image-based lanes, with point lanes
    mixed in."""
    jlt, tlt = _ibl_tables(37.5)
    for k in jlt:
        np.testing.assert_array_equal(_np(tlt[k]), np.asarray(jlt[k]),
                                      err_msg=k)
    assert tlt["static"]["has_ibl"] and not tlt["static"]["has_area"]
    rng = np.random.default_rng(11)
    n = 4096
    lid = rng.integers(0, 2, n).astype(np.int32)
    u = [rng.uniform(0, 1, n).astype(np.float32) for _ in range(4)]
    ref = jl.sample_emission(jlt, {"em_rows": jnp.zeros((1, 12))},
                             jnp.asarray(lid), *(jnp.asarray(x) for x in u))
    got = tl.sample_emission(tlt, {"em_rows": torch.zeros((1, 12))},
                             _t(lid).long(), *(_t(x) for x in u))
    for k in ("p", "n", "dir", "pdf_pos", "pdf_dir"):
        np.testing.assert_allclose(_np(got[k]), np.asarray(ref[k]), rtol=1e-5,
                                   atol=2e-6, err_msg=k)
    np.testing.assert_array_equal(_np(got["is_delta"]), lid == 0)
    ibl = lid == 1
    r = np.linalg.norm(_np(got["p"])[ibl] - np.float32([0.1, -0.2, 0.3]),
                       axis=-1)
    np.testing.assert_allclose(r, 4.5, rtol=1e-5)
    cos = (_np(got["n"]) * _np(got["dir"])).sum(axis=-1)[ibl]
    assert (cos >= -1e-6).all()
    np.testing.assert_allclose(_np(got["pdf_pos"])[ibl],
                               1 / (4 * np.pi * 4.5 ** 2), rtol=1e-6)
    env_le = rng.uniform(0, 2, (n, 3)).astype(np.float32)
    wo = rng.normal(size=(n, 3)).astype(np.float32)
    wo /= np.linalg.norm(wo, axis=-1, keepdims=True)
    for w in (np.asarray(ref["dir"]), wo):
        for le in (None, env_le):
            got_e = tl.eval_emission(tlt, _t(lid).long(), got["n"], _t(w),
                                     env_le=None if le is None else _t(le))
            ref_e = jl.eval_emission(jlt, jnp.asarray(lid), ref["n"],
                                     jnp.asarray(w),
                                     env_le=None if le is None
                                     else jnp.asarray(le))
            np.testing.assert_allclose(_np(got_e), np.asarray(ref_e),
                                       rtol=1e-6)
        np.testing.assert_allclose(
            _np(tl.pdf_emission_direction(tlt, _t(lid).long(), got["n"],
                                          _t(w))),
            np.asarray(jl.pdf_emission_direction(jlt, jnp.asarray(lid),
                                                 ref["n"], jnp.asarray(w))),
            rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(
        _np(tl.pdf_emission_position(tlt, _t(lid).long())),
        np.asarray(jl.pdf_emission_position(jlt, jnp.asarray(lid))), rtol=1e-6)
    p = rng.normal(size=(n, 3)).astype(np.float32)
    ls = tl.sample_li(tlt, {"em_rows": torch.zeros((1, 12))}, _t(lid).long(),
                      _t(p), torch.full((n,), 1e-3), _t(u[0]), _t(u[1]))
    assert not ls["Li"][_t(ibl)].any() and ls["Li"][_t(~ibl)].all()


# --- the loader, the bake and the committed map -----------------------------

def test_sky_exr_is_make_sky_image():
    """examples/textures/sky.exr is what assets.make_sky_image writes, and
    goblin_tpu's reader reads it."""
    img = tassets.make_sky_image()
    assert img.shape == (128, 256, 3) and img.dtype == np.float32
    np.testing.assert_array_equal(t_read_exr(SKY_EXR), img)
    np.testing.assert_array_equal(j_read_exr(SKY_EXR), img)
    lum = tenv.env_luminance(img)
    assert lum.max() > 50 * np.median(lum[:64])  # the sun
    assert lum[:64].mean() > 3 * lum[64:].mean()  # a darker lower half


@pytest.fixture(scope="module")
def sky():
    js, jm, ts, tm = _load_both(SKY, {"sample_per_pixel": 1})
    return js, _resized(jm, 32, 24), ts, _resized(tm, 32, 24)


def test_sky_scene_loads_and_bakes_as_goblin_tpu(sky):
    js, jm, ts, tm = sky
    with open(SKY) as f:
        doc = json.load(f)
    assert doc["render_setting"] == {"sample_per_pixel": 16,
                                     "max_ray_depth": 5,
                                     "render_method": "path_tracing",
                                     "initial_radius": 0.01}
    ibl = [lt for lt in doc["lights"] if lt["type"] == "ibl"]
    assert len(ibl) == 1 and "euler" in ibl[0] and ibl[0]["filter"] != [1] * 3
    assert tm.has_env and tm.env_light_id == jm.env_light_id == 3
    assert not tm.all_delta_lights and not jm.all_delta_lights
    for k in ("img", "rot", "mean"):
        np.testing.assert_array_equal(_np(ts["env"][k]),
                                      np.asarray(js["env"][k]), err_msg=k)
    np.testing.assert_allclose(_np(ts["env"]["cdf"]["marg"]["cdf"]),
                               np.asarray(js["env"]["cdf"]["marg"]["cdf"]),
                               atol=1e-6)
    for k in ("power", "power_cdf", "world_radius", "type", "color"):
        np.testing.assert_array_equal(_np(ts["lights"][k]),
                                      np.asarray(js["lights"][k]), err_msg=k)
    # the environment's pick share lies in [0.2, 0.8]
    power = _np(ts["lights"]["power"])
    assert 0.2 <= power[3] / power.sum() <= 0.8


def test_loader_raises_on_an_env_file_that_does_not_load(tmp_path):
    """goblin_tpu prints and lights the scene with a 1 x 1 magenta map; the
    port raises (ROADMAP Queue 3)."""
    path = _env_scene(tmp_path, "missing.exr")
    with pytest.raises(ValueError, match="environment map"):
        tloader.load_scene(path, device="cpu")


# --- renders of scenes lit by a map -----------------------------------------

def _write_plane(tmp_path):
    (tmp_path / "plane.obj").write_text(
        "v -1 0 1\nv 1 0 1\nv -1 0 -1\nv 1 0 -1\n"
        "vn 0 1 0\nf 1//1 2//1 3//1\nf 3//1 2//1 4//1\n")


def _env_scene(tmp_path, env_file, kind="sky", spp=4, depth=2,
               res=(24, 18)):
    """tests/test_lighttracer.py's env scene (a floor under a sky map, seen
    at an angle) or tests/test_path.py's furnace (a constant map, the
    camera looking up past the floor's edge)."""
    if kind == "sky":
        cam = {"position": [0, 1.5, -2.5], "euler": [20, 0, 0],
               "rotation_order": "xyz", "fov": 45.0}
        scale, grey = 30, 0.7
    else:
        cam = {"position": [0, 1.0, 0], "euler": [-30, 0, 0],
               "rotation_order": "xyz", "fov": 40.0}
        scale, grey = 50, 0.6
    cam.update(film={"resolution": list(res)},
               filter={"type": "box", "width": [0.5, 0.5]})
    doc = {
        "render_setting": {"render_method": "path_tracing",
                           "sample_per_pixel": spp, "max_ray_depth": depth,
                           "initial_radius": 0.05},
        "camera": cam,
        "geometries": [{"name": "floor", "type": "mesh", "file": "plane.obj"}],
        "textures": [{"format": "color", "name": "grey", "type": "constant",
                      "color": [grey] * 3}],
        "materials": [{"name": "diffuse", "type": "lambert", "Kd": "grey"}],
        "primitives": [{"type": "model", "name": "fm", "geometry": "floor",
                        "material": "diffuse"},
                       {"type": "instance", "name": "fi", "model": "fm",
                        "scale": [scale] * 3}],
        "lights": [{"name": "sky", "type": "ibl", "file": env_file}],
    }
    _write_plane(tmp_path)
    path = tmp_path / "scene.json"
    path.write_text(json.dumps(doc))
    return str(path)


def _sky_map():
    """tests/test_lighttracer.py:96-107's smooth anisotropic sky."""
    h, w = 16, 32
    ys = np.linspace(0, np.pi, h)[:, None]
    return np.stack([0.6 + 0.4 * np.cos(ys) * np.ones((h, w)),
                     0.5 + 0.3 * np.cos(ys) * np.ones((h, w)),
                     0.8 * np.ones((h, w))], axis=-1).astype(np.float32)


def _env_case(tmp_path, kind, **kw):
    img = _sky_map() if kind == "sky" else np.full((8, 16, 3), 1.5, np.float32)
    j_write_exr(str(tmp_path / "env.exr"), img)  # goblin_tpu's writer
    return _env_scene(tmp_path, "env.exr", kind, **kw)


def test_furnace_sky_pixels_equal_the_map(tmp_path):
    """tests/test_path.py:152: under a constant map, the pixels that see
    the sky read its radiance exactly."""
    path = _env_case(tmp_path, "furnace", spp=1, depth=2, res=(8, 8))
    scene, meta = tloader.load_scene(path, device="cpu")
    assert meta.has_env
    img = tcommon.render(scene, meta, t_make_li(meta), spp=1).numpy()
    np.testing.assert_allclose(img, 1.5, rtol=1e-4)


def _render_both(path, method, chunk=256):
    js, jm, ts, tm = _load_both(path, {"render_method": method})
    if method == "path_tracing":
        ref = jcommon.render(js, jm, j_path_li(jm), chunk_size=chunk)
        got = tcommon.render(ts, tm, t_make_li(tm), chunk_size=chunk)
    elif method == "whitted":
        ref = jcommon.render(js, jm, j_whitted_li(jm), chunk_size=chunk)
        got = tcommon.render(ts, tm, t_make_li(tm), chunk_size=chunk)
    elif method == "light_tracing":
        ref = jsplat.render_light_tracer(js, jm, chunk_size=chunk * 4)
        got = tsplat.render_light_tracer(ts, tm, chunk_size=chunk * 4)
    elif method == "bdpt":
        ref = jbdpt.render_bdpt(js, jm, chunk_size=chunk)
        got = tbdpt.render_bdpt(ts, tm, chunk_size=chunk)
    else:
        ref = jsppm.render_sppm(js, jm, chunk_size=chunk)
        got = tsppm.render_sppm(ts, tm, chunk_size=chunk)
    return _np(got), np.asarray(ref)


@pytest.mark.parametrize("kind", ["sky", "furnace"])
@pytest.mark.parametrize("method", ["path_tracing", "whitted", "sppm",
                                    "light_tracing", "bdpt"])
def test_env_scene_renders_match_goblin_tpu(tmp_path, kind, method):
    """tests/test_lighttracer.py:90's sky and tests/test_path.py:152's
    furnace at 24 x 18, 4 spp (SPPM: 4 iterations), depth 2, through both
    packages: the NEE pick of the map, the BSDF side's MIS against its
    pdf, the miss terms, Whitted's per-light sampling of the map, the
    photons and light paths emitted from the bounding sphere, and BDPT's
    virtual vertex on it."""
    got, ref = _render_both(_env_case(tmp_path, kind), method)
    assert got.shape == ref.shape == (18, 24, 3) and np.isfinite(got).all()
    frac, rel = _bar(got, ref)
    assert frac >= 0.99 and rel <= 1e-3 and got.mean() > 0.01


def test_sky_scene_path_tracing_matches_goblin_tpu(sky):
    """examples/bunny_sky.json at 32 x 24, 1 spp, depth 5 (the studio scene
    plus the map): every light kind of the slices and the environment."""
    js, jm, ts, tm = sky
    ref = np.asarray(jcommon.render(js, jm, j_path_li(jm)))
    got = tcommon.render(ts, tm, t_make_li(tm)).numpy()
    frac, rel = _bar(got, ref)
    assert frac >= 0.99 and rel <= 1e-3 and got.mean() > 0.05


def test_sky_scene_light_tracing_matches_goblin_tpu(sky):
    js, jm, ts, tm = sky
    ref = np.asarray(jsplat.render_light_tracer(js, jm, chunk_size=256))
    got = tsplat.render_light_tracer(ts, tm, chunk_size=256).numpy()
    frac, rel = _bar(got, ref)
    assert frac >= 0.99 and rel <= 1e-3 and got.mean() > 0.01


def test_sky_scene_whitted_matches_goblin_tpu(sky):
    """Depth 1 (3 nodes x 4 lights, the map sampled by its own light),
    goblin_tpu op by op."""
    js, jm, ts, tm = sky
    ref = jax_render_unjitted(js, jm, j_whitted_li(jm, max_depth=1))
    got = tcommon.render(ts, tm, t_whitted_li(tm, max_depth=1)).numpy()
    frac, rel = _bar(got, ref)
    assert frac >= 0.99 and rel <= 1e-3 and got.mean() > 0.05


def test_sky_scene_sppm_matches_goblin_tpu(sky):
    """1 iteration at radius 0.01: the ray pass's miss term and photons
    from the map."""
    js, jm, ts, tm = sky
    ref = np.asarray(jsppm.render_sppm(js, jm, iterations=1))
    got = tsppm.render_sppm(ts, tm, iterations=1).numpy()
    frac, rel = _bar(got, ref)
    assert frac >= 0.99 and rel <= 1e-3 and got.mean() > 0.01


def test_sky_scene_bdpt_matches_goblin_tpu():
    """24 x 18, 1 spp, depth 3."""
    js, jm, ts, tm = _load_both(SKY, {"sample_per_pixel": 1,
                                      "max_ray_depth": 3})
    jm, tm = _resized(jm, 24, 18), _resized(tm, 24, 18)
    ref = np.asarray(jbdpt.render_bdpt(js, jm, chunk_size=512))
    got = tbdpt.render_bdpt(ts, tm, chunk_size=512).numpy()
    frac, rel = _bar(got, ref)
    assert frac >= 0.99 and rel <= 1e-3 and got.mean() > 0.05
