"""goblin_tpu_torch's light table against goblin_tpu's on the CPU, lane by
lane: point, directional, spot, two triangle-backed area lights and a
sphere light in one table.

Inputs are made with numpy from a seed and handed to both packages.
Bit-equal: the baked tables, the light pick, the emissive-triangle pick and
the rescaled u, every flag. The sampled values go through sqrt, sin, cos
and divisions that XLA on the CPU and PyTorch round differently, so they
are held to rtol 1e-5 / atol 2e-6 (2e-5 where a cone or sphere warp feeds
a position that is then subtracted from the shading point).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goblin_tpu.lights import lights as jl
from goblin_tpu_torch.lights import lights as tl

TOL = dict(rtol=1e-5, atol=2e-6)
WARP_TOL = dict(rtol=2e-5, atol=2e-5)
KINDS = {"point": 0, "directional": 1, "spot": 2, "triangles": 3,
         "sphere": 4, "triangles2": 5}
SPH_C, SPH_R = np.float32([0.5, 1.0, -0.25]), np.float32(0.4)


def _t(a):
    return torch.as_tensor(np.array(a))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _tables(seed=0):
    """Six lights: 0 point, 1 directional, 2 spot, 3 area (5 triangles), 4
    area (a sphere), 5 area (3 triangles). -> (jax table, torch table,
    jax tri_data, torch tri_data)."""
    rng = np.random.default_rng(seed)
    jb_, tb_ = jl.LightsBuild(), tl.LightsBuild()
    em_light = np.int32([3] * 5 + [5] * 3)
    v0 = rng.uniform(-1, 1, (8, 3)).astype(np.float32)
    v0[:, 1] += 3.0
    e1 = rng.normal(size=(8, 3)).astype(np.float32) * 0.5
    e2 = rng.normal(size=(8, 3)).astype(np.float32) * 0.5
    n = np.cross(e1, e2)
    em_area = (0.5 * np.linalg.norm(n, axis=-1)).astype(np.float32)
    n = (n / np.linalg.norm(n, axis=-1, keepdims=True)).astype(np.float32)
    em_rows = np.concatenate([v0, e1, e2, n], axis=-1).astype(np.float32)
    areas = {3: float(em_area[:5].sum()), 5: float(em_area[5:].sum()),
             4: float(4.0 * np.pi * SPH_R * SPH_R)}
    for b in (jb_, tb_):
        b.add(0, (3.0, 2.0, 1.0), position=(0.5, 2.0, -1.0))
        b.add(1, (0.5, 0.6, 0.7), direction=(0.3, -1.0, 0.2))
        b.add(2, (200.0, 200.0, 200.0), position=(-10.0, 5.0, 15.0),
              direction=(10.3, -5.4, -15.0),
              cos_theta_max=float(np.cos(np.radians(10.0))),
              cos_falloff_start=float(np.cos(np.radians(5.0))))
        b.add(3, (4.0, 5.0, 6.0), area=areas[3])
        b.add(3, (9.0, 8.0, 7.0), area=areas[4])
        b.add(3, (1.0, 2.0, 3.0), area=areas[5])
    wc = np.float32([0.2, -0.4, 0.1])
    sph_center = np.zeros((6, 3), np.float32)
    sph_radius = np.zeros(6, np.float32)
    is_sphere = np.zeros(6, bool)
    sph_center[4], sph_radius[4], is_sphere[4] = SPH_C, SPH_R, True
    jlt = jl.bake_lights(jb_, em_light, em_area, wc, 7.5)
    jlt["sph_center"] = jnp.asarray(sph_center)
    jlt["sph_radius"] = jnp.asarray(sph_radius)
    jlt["is_sphere"] = jnp.asarray(is_sphere)
    tlt = tl.bake_lights(tb_, em_light, em_area, wc, 7.5, "cpu", sph_center,
                         sph_radius, is_sphere)
    return jlt, tlt, {"em_rows": jnp.asarray(em_rows)}, {"em_rows": _t(em_rows)}


def _points(rng, n):
    """Shading points around the lights; the first 64 lie inside the sphere
    light and 8 more on its centre and just inside its surface."""
    p = rng.normal(size=(n, 3)).astype(np.float32) * 2.0
    inside = rng.normal(size=(64, 3))
    inside = inside / np.linalg.norm(inside, axis=-1, keepdims=True)
    p[:64] = SPH_C + (inside * rng.uniform(0.05, 0.95, (64, 1)) * SPH_R)
    p[64:68] = SPH_C
    p[68:72] = SPH_C + np.float32([SPH_R * 0.999, 0, 0])
    return p.astype(np.float32)


def test_bake_lights_tables_equal():
    jlt, tlt, _, _ = _tables()
    assert set(jlt) == set(tlt) - {"static"}
    for k in jlt:
        np.testing.assert_array_equal(_np(tlt[k]), np.asarray(jlt[k]),
                                      err_msg=k)
    assert tlt["static"]["segments"] == ((3, 0, 5), (5, 5, 8))
    assert tlt["static"]["has_sphere"] and tlt["static"]["has_area"]
    assert tlt["seg_start"].tolist() == [0, 0, 0, 0, 5, 5, 8]


def test_build_cdf_1d_matches():
    from goblin_tpu.core import sampling as jsamp
    from goblin_tpu_torch.core import sampling as tsamp
    f = np.random.default_rng(2).uniform(0, 3, (4, 33)).astype(np.float32)
    f[2] = 0.0  # an all-zero row keeps a finite cdf
    ref = jsamp.build_cdf_1d(jnp.asarray(f))
    got = tsamp.build_cdf_1d(_t(f))
    assert got["count"] == ref["count"] == 33
    for k in ("func", "cdf", "integral"):
        np.testing.assert_allclose(_np(got[k]), np.asarray(ref[k]), rtol=1e-6,
                                   atol=1e-7, err_msg=k)


@pytest.mark.parametrize("light", [3, 5])
def test_emissive_triangle_pick_and_rescaled_u_exact(light):
    """The per-segment search returns goblin_tpu's triangle (its count over
    all E entries of in-segment cdf values strictly below u, clipped) and
    the same rescaled u, bit for bit, at the cdf's own values too."""
    jlt, tlt, _, _ = _tables()
    rng = np.random.default_rng(light)
    cdf = np.asarray(jlt["em_cdf"])
    u = np.concatenate([rng.uniform(0, 1, 4000).astype(np.float32), cdf,
                        np.nextafter(cdf, np.float32(0)),
                        np.nextafter(cdf, np.float32(2)),
                        np.float32([0.0, 1.0 - 2.0 ** -24])])
    u = np.minimum(u, np.float32(1.0 - 2.0 ** -24))  # samples lie in [0, 1)
    lid = np.full(len(u), light, np.int32)
    seg = np.asarray(jlt["seg_start"])
    s0, s1 = seg[light], seg[light + 1]
    e_idx = np.arange(len(cdf))
    below = ((e_idx >= s0) & (e_idx < s1))[None, :] & (cdf[None, :] < u[:, None])
    want = np.clip(s0 + below.sum(axis=-1), 0, len(cdf) - 1)
    want_u = np.asarray(jl._rescale_cdf_u(
        jlt["em_cdf"], jnp.asarray(want), jnp.full(len(u), s0), jnp.asarray(u)))
    tri, u_r = tl._pick_emissive_triangle(tlt, _t(lid).long(), _t(u))
    np.testing.assert_array_equal(_np(tri), want)
    np.testing.assert_array_equal(_np(u_r), want_u)
    assert set(_np(tri).tolist()) == set(range(s0, s1))
    assert _np(u_r).max() <= np.float32(1.0 - 1e-7) and _np(u_r).min() >= 0.0


def test_pick_light_equal():
    jlt, tlt, _, _ = _tables()
    u = np.random.default_rng(1).uniform(0, 1, 8192).astype(np.float32)
    jid, jpdf = jl.pick_light(jlt, jnp.asarray(u))
    tid, tpdf = tl.pick_light(tlt, _t(u))
    np.testing.assert_array_equal(_np(tid), np.asarray(jid))
    np.testing.assert_allclose(_np(tpdf), np.asarray(jpdf), **TOL)
    assert set(_np(tid).tolist()) == set(range(6))


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_sample_li_matches(kind):
    jlt, tlt, jtri, ttri = _tables()
    rng = np.random.default_rng(10 + KINDS[kind])
    n = 4096
    lid = np.full(n, KINDS[kind], np.int32)
    p = _points(rng, n)
    eps = rng.uniform(1e-4, 1e-2, n).astype(np.float32)
    u1, u2 = (rng.uniform(0, 1, n).astype(np.float32) for _ in range(2))
    ref = jl.sample_li(jlt, jtri, jnp.asarray(lid), jnp.asarray(p),
                       jnp.asarray(eps), jnp.asarray(u1), jnp.asarray(u2))
    got = tl.sample_li(tlt, ttri, _t(lid).long(), _t(p), _t(eps), _t(u1),
                       _t(u2))
    np.testing.assert_array_equal(_np(got["is_delta"]),
                                  np.asarray(ref["is_delta"]))
    assert bool(_np(got["is_delta"]).all()) == (KINDS[kind] < 3)
    tol = WARP_TOL if kind == "sphere" else TOL
    for k in ("wi", "shadow_maxt", "dist"):
        np.testing.assert_allclose(_np(got[k]), np.asarray(ref[k]), **tol,
                                   err_msg=k)
    # a sample that grazes the emitter can flip the one-sided test: allow
    # it on a handful of lanes, the rest equal
    li_same = np.isclose(_np(got["Li"]), np.asarray(ref["Li"]),
                         **TOL).all(axis=-1)
    assert li_same.mean() >= 0.999
    # a cone or area pdf divides by a small cosine on grazing lanes
    np.testing.assert_allclose(_np(got["pdf"]), np.asarray(ref["pdf"]),
                               rtol=2e-4, atol=1e-6, err_msg="pdf")
    if kind == "sphere":
        # the inside lanes take the uniform-surface arm with the area pdf,
        # the outside ones the cone pdf, and both arms emit
        d2 = ((p - SPH_C) ** 2).sum(axis=-1)
        inside = d2 - SPH_R * SPH_R <= 1e-4
        assert inside[:72].all() and 72 <= inside.sum() < n // 4
        pdf = _np(got["pdf"])
        cone = 1.0 / (2 * np.pi * (1 - np.sqrt(1 - np.minimum(
            SPH_R * SPH_R / d2[~inside], 1.0))))
        np.testing.assert_allclose(pdf[~inside], cone, rtol=1e-3)
        assert (np.abs(pdf[inside][:, None] - cone[None, :10]) > 0).all()
        assert (_np(got["Li"])[~inside] > 0).any()
    if kind.startswith("triangles"):
        assert (_np(got["Li"]) > 0).any() and (_np(got["Li"]) == 0).any()


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_pdf_li_matches(kind):
    """The BSDF side's pdf: the hit's light id equal to the picked light on
    half the lanes, another light or a miss (t = 3e38) on the rest."""
    jlt, tlt, _, _ = _tables()
    rng = np.random.default_rng(20 + KINDS[kind])
    n = 4096
    lid = np.full(n, KINDS[kind], np.int32)
    p = _points(rng, n)
    w = rng.normal(size=(n, 3))
    w = (w / np.linalg.norm(w, axis=-1, keepdims=True)).astype(np.float32)
    hit_t = rng.uniform(0.1, 10, n).astype(np.float32)
    hit_cos = rng.uniform(-1, 1, n).astype(np.float32)
    hit_light = np.where(np.arange(n) % 2 == 0, KINDS[kind],
                         rng.integers(-1, 6, n)).astype(np.int32)
    hit_t[hit_light < 0] = 3e38
    ref = jl.pdf_li(jlt, jnp.asarray(lid), jnp.asarray(p), jnp.asarray(w),
                    jnp.asarray(hit_t), jnp.asarray(hit_cos),
                    jnp.asarray(hit_light))
    got = tl.pdf_li(tlt, _t(lid).long(), _t(p), _t(w), _t(hit_t), _t(hit_cos),
                    _t(hit_light))
    np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=2e-5, atol=1e-7)
    assert np.isfinite(_np(got)).all()
    assert bool((_np(got) > 0).any()) == (KINDS[kind] >= 3)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_emission_matches(kind):
    """sample_emission, then eval_emission and pdf_emission_* toward the
    sampled and toward random directions."""
    jlt, tlt, jtri, ttri = _tables()
    rng = np.random.default_rng(30 + KINDS[kind])
    n = 4096
    lid = np.full(n, KINDS[kind], np.int32)
    u = [rng.uniform(0, 1, n).astype(np.float32) for _ in range(4)]
    ref = jl.sample_emission(jlt, jtri, jnp.asarray(lid),
                             *(jnp.asarray(x) for x in u))
    got = tl.sample_emission(tlt, ttri, _t(lid).long(), *(_t(x) for x in u))
    for k in ("p", "n", "dir", "pdf_pos", "pdf_dir"):
        np.testing.assert_allclose(_np(got[k]), np.asarray(ref[k]),
                                   **WARP_TOL, err_msg=k)
    np.testing.assert_array_equal(_np(got["is_delta"]),
                                  np.asarray(ref["is_delta"]))
    if KINDS[kind] >= 3:
        # an emitter's photons leave on the side of its normal
        cos = (_np(got["n"]) * _np(got["dir"])).sum(axis=-1)
        assert (cos >= -1e-6).all() and (_np(got["pdf_dir"]) >= 0).all()
    if kind == "sphere":
        np.testing.assert_allclose(
            np.linalg.norm(_np(got["p"]) - SPH_C, axis=-1), SPH_R, rtol=1e-5)
    wo = rng.normal(size=(n, 3))
    wo = (wo / np.linalg.norm(wo, axis=-1, keepdims=True)).astype(np.float32)
    wo[:50] = _np(tlt["direction"][1])
    n_light = np.asarray(ref["n"])
    for w in (np.asarray(ref["dir"]), wo):
        np.testing.assert_allclose(
            _np(tl.eval_emission(tlt, _t(lid).long(), _t(n_light), _t(w))),
            np.asarray(jl.eval_emission(jlt, jnp.asarray(lid),
                                        jnp.asarray(n_light), jnp.asarray(w))),
            **TOL)
        np.testing.assert_allclose(
            _np(tl.pdf_emission_direction(tlt, _t(lid).long(), _t(n_light),
                                          _t(w))),
            np.asarray(jl.pdf_emission_direction(
                jlt, jnp.asarray(lid), jnp.asarray(n_light), jnp.asarray(w))),
            **TOL)
    np.testing.assert_allclose(
        _np(tl.pdf_emission_position(tlt, _t(lid).long())),
        np.asarray(jl.pdf_emission_position(jlt, jnp.asarray(lid))), **TOL)


def test_ibl_arms_stay_refused():
    jlt, tlt, _, ttri = _tables()
    lid = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tl.eval_emission(tlt, lid, torch.zeros(4, 3), torch.ones(4, 3),
                         env_le=torch.ones(4, 3))
    b = tl.LightsBuild()
    b.add(tl.LIGHT_IBL, (1.0, 1.0, 1.0))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tl.bake_lights(b, [], [], np.zeros(3, np.float32), 1.0, "cpu")
