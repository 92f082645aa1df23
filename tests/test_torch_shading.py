"""goblin_tpu_torch vs goblin_tpu, module by module on the CPU: camera and
sample helpers, intersect, materials and BSDFs, lights, film and EXR.

Both packages get the same numpy inputs. goblin_tpu loads bunny.json with
its production tree (GOBLIN_TRACE=pallas: max_leaf 32, 8-aligned leaves)
and traces it with its lockstep jnp traversal, so both walk one tree.
"""

import dataclasses
import os
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goblin_tpu.camera import film as jfilm
from goblin_tpu.integrators import common as jcommon
from goblin_tpu.integrators.materials import gather_material as j_gather
from goblin_tpu.io.exr import read_exr
from goblin_tpu.lights import lights as jl
from goblin_tpu.scene import intersect as jscn
from goblin_tpu.scene import loader as jloader
from goblin_tpu.scene import params as jparams
from goblin_tpu.shading import bsdf as jb
from goblin_tpu_torch.camera import film as tfilm
from goblin_tpu_torch.integrators import common as tcommon
from goblin_tpu_torch.integrators.materials import gather_material as t_gather
from goblin_tpu_torch.io.exr import write_exr
from goblin_tpu_torch.lights import lights as tl
from goblin_tpu_torch.scene import intersect as tscn
from goblin_tpu_torch.scene import loader as tloader
from goblin_tpu_torch.scene import params as tparams
from goblin_tpu_torch.shading import bsdf as tb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUNNY = os.path.join(REPO, "examples", "bunny.json")
OVERRIDES = {"render_method": "path_tracing", "max_ray_depth": 5,
             "sample_per_pixel": 4}
TOL = dict(rtol=1e-5, atol=1e-6)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def bunny():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GOBLIN_TRACE", "pallas")
        js, jm = jloader.load_scene(BUNNY, OVERRIDES)
    jm = dataclasses.replace(jm, trace_backend="jnp")
    ts, tm = tloader.load_scene(BUNNY, OVERRIDES, device="cpu")
    return js, jm, ts, tm


def test_bake_tables_match(bunny):
    js, jm, ts, tm = bunny
    assert (tm.n_tris, tm.n_nodes, tm.max_leaf) == (jm.n_tris, jm.n_nodes,
                                                    jm.max_leaf)
    assert tm.all_delta_lights == jm.all_delta_lights
    assert tm.material_kinds == jm.material_kinds
    assert tm.world_bounds == jm.world_bounds
    assert tm.n_wide_nodes == np.asarray(js["pk_nb4"]).shape[0]
    np.testing.assert_array_equal(_np(ts["tri_rows"])[:, :9],
                                  np.asarray(js["tri_soup"]))
    for k in ("tri_n", "tri_uv", "tri_mat", "tri_light"):
        np.testing.assert_array_equal(_np(ts[k]), np.asarray(js[k]))
    # goblin_tpu appends one black material for area lights; compare the
    # rows both have, with its bit-cast int columns decoded
    jrows = np.asarray(js["mat_rows"])
    jdec = jrows.copy()
    for c in (0, 1, 2, 3, 4, 7):
        jdec[:, c] = jrows[:, c].view(np.int32)
    m = _np(ts["mat_rows"]).shape[0]
    np.testing.assert_array_equal(_np(ts["mat_rows"]), jdec[:m])
    x = _np(ts["tex_const"]).shape[0]
    np.testing.assert_array_equal(_np(ts["tex_const"]),
                                  np.asarray(js["tex_const"])[:x])
    for k in ("type", "color", "position", "direction", "cos_theta_max",
              "cos_falloff_start", "power", "power_cdf"):
        np.testing.assert_array_equal(_np(ts["lights"][k]),
                                      np.asarray(js["lights"][k]))


def test_sample_helpers_match():
    pix = np.arange(0, 50_000, 7, dtype=np.int32)
    for s in (0, 3, 8):
        got = tcommon.pixel_samples(0, _t(pix), 512, s, 3)
        ref = jcommon.pixel_samples(0, jnp.asarray(pix), 512, jnp.int32(s), 3)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(_np(g), np.asarray(r))
        np.testing.assert_array_equal(
            _np(tcommon.stratified_1d(1, _t(pix), s, 9, 2, 4)),
            np.asarray(jcommon.stratified_1d(1, jnp.asarray(pix),
                                             jnp.int32(s), 9, 2, 4)))
        for g, r in zip(
            tcommon.stratified_2d(1, _t(pix), s, 9, 3, 7, 8),
            jcommon.stratified_2d(1, jnp.asarray(pix), jnp.int32(s), 9, 3,
                                  7, 8),
        ):
            np.testing.assert_array_equal(_np(g), np.asarray(r))
    assert tcommon.spp_grid(5) == jcommon.spp_grid(5) == 3


def test_generate_ray_matches(bunny):
    _, jm, _, tm = bunny
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 512, 4096).astype(np.float32)
    y = rng.uniform(0, 384, 4096).astype(np.float32)
    ref = jm.camera.generate_ray(jnp.asarray(x), jnp.asarray(y))
    got = tm.camera.generate_ray(_t(x), _t(y))
    for k in ("o", "d", "dxd", "dyd", "mint", "maxt"):
        np.testing.assert_allclose(_np(got[k]), np.asarray(ref[k]), rtol=1e-6,
                                   atol=1e-7, err_msg=k)


def test_get_transform_euler_matches():
    raw = {"position": [1, 2, 3], "euler": [10, -35, 70],
           "rotation_order": "zyx", "scale": [2, 1, 0.5]}
    np.testing.assert_allclose(
        tparams.get_transform(tparams.ParamSet(raw)),
        jparams.get_transform(jparams.ParamSet(raw)), rtol=1e-6, atol=1e-6)


def _rays(tm, n=2048, seed=0):
    """Camera rays of a 32 x 24 frame plus random rays around the bunny."""
    rng = np.random.default_rng(seed)
    px = np.arange(32 * 24)
    x = (px % 32 + 0.5).astype(np.float32) * 16.0
    y = (px // 32 + 0.5).astype(np.float32) * 16.0
    cam = tm.camera.generate_ray(_t(x), _t(y))
    o = rng.uniform([-0.6, -0.9, -0.6], [1.2, 0.2, 0.6], (n, 3))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.concatenate([_np(cam["o"]), o]).astype(np.float32)
    d = np.concatenate([_np(cam["d"]), d]).astype(np.float32)
    mint = np.full(len(o), 1e-3, np.float32)
    maxt = np.full(len(o), 3e37, np.float32)
    return o, d, mint, maxt


def test_intersect_matches(bunny):
    js, jm, ts, tm = bunny
    o, d, mint, maxt = _rays(tm)
    ref = jscn.intersect(js, jm, *(jnp.asarray(a) for a in (o, d, mint, maxt)))
    jtri = np.asarray(jscn.trace_rays(js, jm, *(jnp.asarray(a) for a in
                                                (o, d, mint, maxt))).tri)
    res = tscn.trace_rays(ts, tm, *(_t(a) for a in (o, d, mint, maxt)))
    got = tscn.intersect(ts, tm, *(_t(a) for a in (o, d, mint, maxt)))
    jh, th = np.asarray(ref["hit"]), _np(got["hit"])
    assert jh.sum() > 1000
    assert (jh != th).mean() <= 1e-3
    both = jh & th
    same = both & (jtri == _np(res.tri))
    assert same.sum() >= 0.99 * both.sum()
    for k in ("t", "p", "ns", "ng", "uv", "dpdu", "dpdv", "eps", "wo"):
        # the two packages round the hit recompute differently; on a
        # grazing hit of a small bunny triangle t moves by ~12 ulp and the
        # interpolated normal by ~1.3e-5, so the 1e-5 bar holds on all but
        # a few lanes and 1e-4 on every lane
        a, b = _np(got[k])[same], np.asarray(ref[k])[same]
        err = np.abs(a - b).reshape(len(a), -1).max(axis=1)
        assert (err <= 1e-5 + 1e-6 * np.abs(b).reshape(len(b), -1).max(
            axis=1)).mean() >= 0.999, k
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-4, err_msg=k)
    for k in ("mat", "light"):
        np.testing.assert_array_equal(_np(got[k])[same],
                                      np.asarray(ref[k])[same])
    miss = ~jh & ~th
    assert (_np(got["t"])[miss] == 3e38).all()


def test_intersect_uv_differentials_match(bunny):
    js, jm, ts, tm = bunny
    rng = np.random.default_rng(2)
    x = rng.uniform(0, 512, 2048).astype(np.float32)
    y = rng.uniform(0, 384, 2048).astype(np.float32)
    jr = jm.camera.generate_ray(jnp.asarray(x), jnp.asarray(y))
    tr = tm.camera.generate_ray(_t(x), _t(y))
    ref = jscn.intersect(js, jm, jr["o"], jr["d"], jr["mint"], jr["maxt"],
                         dxd=jr["dxd"], dyd=jr["dyd"])
    got = tscn.intersect(ts, tm, tr["o"], tr["d"], tr["mint"], tr["maxt"],
                         dxd=tr["dxd"], dyd=tr["dyd"])
    h = np.asarray(ref["hit"]) & _np(got["hit"])
    assert h.sum() > 500
    for k in ("duv4", "duv"):
        np.testing.assert_allclose(_np(got[k])[h], np.asarray(ref[k])[h],
                                   rtol=1e-4, atol=1e-6, err_msg=k)


def test_occluded_matches(bunny):
    js, jm, ts, tm = bunny
    o, d, mint, maxt = _rays(tm, seed=4)
    maxt = np.random.default_rng(5).uniform(0.1, 3.0, len(o)).astype(np.float32)
    ref = np.asarray(jscn.occluded(js, jm, *(jnp.asarray(a) for a in
                                             (o, d, mint, maxt))))
    occ, tr = tscn.occluded_attenuated(ts, tm, *(_t(a) for a in
                                                 (o, d, mint, maxt)))
    assert ref.sum() > 100
    assert (_np(occ) != ref).mean() <= 1e-3
    assert (_np(tr) == 1.0).all()


def test_gather_material_matches(bunny):
    js, jm, ts, tm = bunny
    rng = np.random.default_rng(0)
    n = 1000
    mat = rng.integers(0, tm.n_materials, n).astype(np.int32)
    uv = rng.uniform(0, 1, (n, 2)).astype(np.float32)
    p = rng.normal(size=(n, 3)).astype(np.float32)
    jfrag = {"mat": jnp.asarray(mat), "uv": jnp.asarray(uv),
             "p": jnp.asarray(p), "duv": jnp.zeros((n, 2)),
             "duv4": jnp.zeros((n, 4))}
    ref = j_gather(js, jm, jfrag)
    got = t_gather(ts, tm, {"mat": _t(mat), "uv": _t(uv)})
    for k in ("mtype", "c0", "c1", "eta"):
        np.testing.assert_array_equal(_np(got[k]), np.asarray(ref[k]),
                                      err_msg=k)
    assert got["kinds"] == ref["kinds"]


def _unit(rng, n):
    v = rng.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _mats(rng, n, kinds=(0, 2)):
    mtype = rng.choice(np.asarray(kinds, np.int32), n).astype(np.int32)
    c0 = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    c1 = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    eta = rng.uniform(1.1, 2.0, n).astype(np.float32)
    jmat = {"kinds": tuple(kinds), "mtype": jnp.asarray(mtype),
            "c0": jnp.asarray(c0), "c1": jnp.asarray(c1),
            "f0": jnp.full(n, 10.0), "eta": jnp.asarray(eta),
            "k": jnp.full(n, -1.0), "is_masked": jnp.zeros(n, bool),
            "mask_alpha": jnp.full(n, 0.5), "mask_u": jnp.zeros(n)}
    tmat = {"kinds": tuple(kinds), "mtype": _t(mtype), "c0": _t(c0),
            "c1": _t(c1), "eta": _t(eta)}
    return jmat, tmat


@pytest.mark.parametrize("kinds", [(0, 2), (0,), (2,)])
def test_bsdf_matches(kinds):
    rng = np.random.default_rng(len(kinds) + kinds[0])
    n = 4096
    jmat, tmat = _mats(rng, n, kinds)
    ns, wo, wi, dpdu = (_unit(rng, n) for _ in range(4))
    dpdu[:64] = 0.0  # degenerate tangents take the coordinate_system frame
    u1, u2, uc = (rng.uniform(0, 1, n).astype(np.float32) for _ in range(3))
    J = [jnp.asarray(a) for a in (ns, wo, wi)]
    T = [_t(a) for a in (ns, wo, wi)]
    np.testing.assert_allclose(
        _np(tb.bsdf_eval(tmat, *T, tb.BSDF_ALL)),
        np.asarray(jb.bsdf_eval(jmat, *J, jb.BSDF_ALL)), **TOL)
    np.testing.assert_allclose(
        _np(tb.bsdf_pdf(tmat, *T, tb.BSDF_ALL)),
        np.asarray(jb.bsdf_pdf(jmat, *J, jb.BSDF_ALL)), **TOL)
    ref = jb.bsdf_sample(jmat, jnp.asarray(ns), jnp.asarray(dpdu),
                         jnp.asarray(wo), jnp.asarray(u1), jnp.asarray(u2),
                         jnp.asarray(uc), jb.BSDF_ALL)
    got = tb.bsdf_sample(tmat, _t(ns), _t(dpdu), _t(wo), _t(u1), _t(u2),
                         _t(uc), tb.BSDF_ALL)
    for k in ("is_specular", "is_null", "valid"):
        np.testing.assert_array_equal(_np(got[k]), np.asarray(ref[k]),
                                      err_msg=k)
    for k in ("f", "wi", "pdf"):
        np.testing.assert_allclose(_np(got[k]), np.asarray(ref[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)


def test_fresnel_matches():
    rng = np.random.default_rng(9)
    cosi = rng.uniform(-1, 1, 10000).astype(np.float32)
    ei = rng.uniform(1, 2, 10000).astype(np.float32)
    et = rng.uniform(1, 2, 10000).astype(np.float32)
    np.testing.assert_allclose(
        _np(tb.fresnel_dielectric(_t(cosi), _t(ei), _t(et))),
        np.asarray(jb.fresnel_dielectric(jnp.asarray(cosi), jnp.asarray(ei),
                                         jnp.asarray(et))), **TOL)


def _light_tables():
    """point, directional and spot lights, in both packages."""
    jb_, tb_ = jl.LightsBuild(), tl.LightsBuild()
    for b in (jb_, tb_):
        b.add(0, (3.0, 2.0, 1.0), position=(0.5, 2.0, -1.0))
        b.add(1, (0.5, 0.6, 0.7), direction=(0.3, -1.0, 0.2))
        b.add(2, (200.0, 200.0, 200.0), position=(-10.0, 5.0, 15.0),
              direction=(10.3, -5.4, -15.0),
              cos_theta_max=float(np.cos(np.radians(10.0))),
              cos_falloff_start=float(np.cos(np.radians(5.0))))
    jlt = jl.bake_lights(jb_, [], [], np.zeros(3, np.float32), 7.5)
    tlt = tl.bake_lights(tb_, [], [], np.zeros(3, np.float32), 7.5, "cpu")
    return jlt, tlt


def test_lights_match():
    jlt, tlt = _light_tables()
    rng = np.random.default_rng(3)
    n = 8192
    u = rng.uniform(0, 1, n).astype(np.float32)
    jid, jpdf = jl.pick_light(jlt, jnp.asarray(u))
    tid, tpdf = tl.pick_light(tlt, _t(u))
    np.testing.assert_array_equal(_np(tid), np.asarray(jid))
    np.testing.assert_allclose(_np(tpdf), np.asarray(jpdf), **TOL)
    assert set(_np(tid).tolist()) == {0, 1, 2}
    p = rng.normal(size=(n, 3)).astype(np.float32)
    eps = rng.uniform(1e-4, 1e-2, n).astype(np.float32)
    ref = jl.sample_li(jlt, {"em_rows": jnp.zeros((0, 12))}, jid,
                       jnp.asarray(p), jnp.asarray(eps), jnp.asarray(u),
                       jnp.asarray(u))
    # delta lights read no samples: the path tracer passes None for them
    got = tl.sample_li(tlt, {"em_rows": torch.zeros((0, 12))}, tid, _t(p),
                       _t(eps), None, None)
    for k in ("Li", "wi", "pdf", "shadow_maxt", "dist"):
        np.testing.assert_allclose(_np(got[k]), np.asarray(ref[k]), **TOL,
                                   err_msg=k)
    np.testing.assert_array_equal(_np(got["is_delta"]),
                                  np.asarray(ref["is_delta"]))
    # spot cone falloff across the whole cone, the falloff band included
    w = _unit(rng, n)
    w[: n // 2] = (np.float32([10.3, -5.4, -15.0]) / 19.0 + 0.05
                   * _unit(rng, n // 2))
    lid2 = np.full(n, 2, np.int64)
    np.testing.assert_allclose(
        _np(tl.spot_falloff(tlt, _t(lid2), _t(w))),
        np.asarray(jl.spot_falloff(jlt, jnp.asarray(lid2), jnp.asarray(w))),
        **TOL)
    t_hit = rng.uniform(0.1, 10, n).astype(np.float32)
    ref_pdf = jl.pdf_li(jlt, jid, jnp.asarray(p), jnp.asarray(w),
                        jnp.asarray(t_hit), jnp.asarray(u),
                        jnp.full(n, -1, jnp.int32))
    got_pdf = tl.pdf_li(tlt, tid, _t(p), _t(w), _t(t_hit), _t(u),
                        torch.full((n,), -1, dtype=torch.int32))
    np.testing.assert_array_equal(_np(got_pdf), np.asarray(ref_pdf))


@pytest.mark.parametrize("kind", ["gaussian", "box", "triangle", "mitchell"])
def test_splat_dense_matches(kind):
    rng = np.random.default_rng(1)
    yc, xc = 24, 32
    jspec = jfilm.FilmSpec(x_res=40, y_res=30, filter=jfilm.FilterSpec(
        kind=kind, x_width=2.0, y_width=1.5, falloff=2.0, b=1 / 3, c=1 / 3))
    tspec = tfilm.FilmSpec(x_res=40, y_res=30, filter=tfilm.FilterSpec(
        kind=kind, x_width=2.0, y_width=1.5, falloff=2.0, b=1 / 3, c=1 / 3))
    jx = rng.uniform(0, 1, (yc, xc)).astype(np.float32)
    jy = rng.uniform(0, 1, (yc, xc)).astype(np.float32)
    L = rng.uniform(0, 2, (yc, xc, 3)).astype(np.float32)
    L[3, 4, 1] = np.nan  # dropped, as the reference drops non-finite samples
    L[5, 6, 0] = np.inf
    c0 = rng.uniform(0, 1, (30, 40, 3)).astype(np.float32)
    w0 = rng.uniform(0, 1, (30, 40)).astype(np.float32)
    jc, jw = jfilm.splat_dense(jspec, jnp.asarray(c0), jnp.asarray(w0),
                               jnp.asarray(jx), jnp.asarray(jy),
                               jnp.asarray(L), 2, 3)
    tc, tw = tfilm.splat_dense(tspec, _t(c0.copy()), _t(w0.copy()), _t(jx),
                               _t(jy), _t(L), 2, 3)
    np.testing.assert_allclose(_np(tc), np.asarray(jc), **TOL)
    np.testing.assert_allclose(_np(tw), np.asarray(jw), **TOL)
    np.testing.assert_allclose(_np(tfilm.to_image(tc, tw)),
                               np.asarray(jfilm.to_image(jc, jw)), **TOL)


def test_write_exr_reads_back(tmp_path):
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 4, (37, 21, 3)).astype(np.float32)
    path = str(tmp_path / "a.exr")
    write_exr(path, img)
    np.testing.assert_array_equal(read_exr(path), img)
    # the offset table right after the header points at each block
    buf = open(path, "rb").read()
    end = buf.index(b"screenWindowWidth\x00float\x00") + 18 + 6 + 4 + 4 + 1
    first = struct.unpack_from("<Q", buf, end)[0]
    y0, size = struct.unpack_from("<ii", buf, first)
    assert y0 == 0 and first + 8 + size == struct.unpack_from("<Q", buf,
                                                               end + 8)[0]
