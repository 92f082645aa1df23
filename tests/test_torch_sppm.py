"""goblin_tpu_torch's SPPM slice against goblin_tpu on the CPU: the QMC
streams and the cell hash bit for bit, the emission side, transport modes,
the light walk, the film scatter splat, the photon grid and drain, and
whole SPPM renders; plus the port's own checkpoint/resume and CLI.

Inputs are made with numpy from a seed and handed to both packages.
goblin_tpu bakes its production tree (GOBLIN_TRACE=pallas: max_leaf 32,
8-aligned leaves) and traces it with the jnp traversal, so both packages
walk one tree.
"""

import dataclasses
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goblin_tpu import splatting as jsplat
from goblin_tpu.camera import film as jfilm
from goblin_tpu.core import sampling as jsamp
from goblin_tpu.integrators import sppm as jsppm
from goblin_tpu.lights import lights as jl
from goblin_tpu.scene import loader as jloader
from goblin_tpu.shading import bsdf as jb
from goblin_tpu_torch import render as trender
from goblin_tpu_torch import splatting as tsplat
from goblin_tpu_torch.camera import film as tfilm
from goblin_tpu_torch.core import sampling as tsamp
from goblin_tpu_torch.integrators import sppm as tsppm
from goblin_tpu_torch.lights import lights as tl
from goblin_tpu_torch.scene import loader as tloader
from goblin_tpu_torch.shading import bsdf as tb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUNNY = os.path.join(REPO, "examples", "bunny.json")
TOL = dict(rtol=1e-5, atol=1e-6)


def _t(a):
    return torch.as_tensor(np.array(a))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _two_planes(tmp_path, spp=2, depth=3, res=(20, 16)):
    """tests/test_sppm.py's scene: a floor and a wall lit by a point light."""
    doc = {
        "render_setting": {"render_method": "sppm", "sample_per_pixel": spp,
                           "max_ray_depth": depth},
        "camera": {"position": [0, 1.2, -2.2], "euler": [20, 0, 0],
                   "rotation_order": "xyz", "fov": 50.0,
                   "film": {"resolution": list(res)},
                   "filter": {"type": "box", "width": [0.5, 0.5]}},
        "geometries": [{"name": "floor", "type": "mesh", "file": "plane.obj"}],
        "textures": [{"format": "color", "name": "grey", "type": "constant",
                      "color": [0.7, 0.7, 0.7]}],
        "materials": [{"name": "diffuse", "type": "lambert", "Kd": "grey"}],
        "primitives": [
            {"type": "model", "name": "fm", "geometry": "floor",
             "material": "diffuse"},
            {"type": "instance", "name": "fi", "model": "fm",
             "scale": [30, 30, 30]},
            {"type": "instance", "name": "wall", "model": "fm",
             "position": [0, 0, 2.0], "euler": [-90, 0, 0],
             "rotation_order": "xyz", "scale": [30, 30, 30]},
        ],
        "lights": [{"name": "key", "type": "point", "intensity": [10, 10, 10],
                    "position": [0.5, 2.5, -0.5]}],
    }
    (tmp_path / "plane.obj").write_text(
        "v -1 0 1\nv 1 0 1\nv -1 0 -1\nv 1 0 -1\n"
        "vn 0 1 0\nf 1//1 2//1 3//1\nf 3//1 2//1 4//1\n")
    path = tmp_path / "scene.json"
    path.write_text(json.dumps(doc))
    return str(path)


def _bunny(tmp_path, x_res, y_res, spp, depth):
    """bunny.json as shipped (SPPM, initial_radius 0.01) at another size."""
    os.makedirs(tmp_path / "models", exist_ok=True)
    for name in ("bunny.obj", "plane.obj"):
        shutil.copy(os.path.join(REPO, "examples", "models", name),
                    tmp_path / "models" / name)
    with open(BUNNY) as f:
        doc = json.load(f)
    doc["render_setting"].update(sample_per_pixel=spp, max_ray_depth=depth)
    doc["camera"]["film"]["resolution"] = [x_res, y_res]
    path = tmp_path / "bunny.json"
    path.write_text(json.dumps(doc))
    return str(path)


def _load_both(path, monkeypatch):
    monkeypatch.setenv("GOBLIN_TRACE", "pallas")
    js, jm = jloader.load_scene(path)
    jm = dataclasses.replace(jm, trace_backend="jnp")
    ts, tm = tloader.load_scene(path, device="cpu")
    return js, jm, ts, tm


# --- QMC streams and the cell hash: bit for bit


def test_radical_inverse_bit_equal_for_all_primes():
    rng = np.random.default_rng(0)
    n = np.concatenate([np.arange(64), [2**31 - 1, 2**31, 2**32 - 1],
                        rng.integers(0, 2**32, 500)]).astype(np.uint32)
    for base in tsppm._QMC_PRIMES:
        ref = np.asarray(jsamp.radical_inverse(jnp.asarray(n), base))
        got = tsamp.radical_inverse(_t(n.astype(np.int64)), base).numpy()
        np.testing.assert_array_equal(got, ref, err_msg=f"base {base}")
    # a Python float 1.0 / base rounds to the same float32 in both
    for base in tsppm._QMC_PRIMES:
        assert np.float32(1.0 / base) == jnp.float32(1.0 / base)


_J_QMC_TABLE = jax.jit(jsppm.qmc_table, static_argnums=1)


@pytest.mark.parametrize("it", [0, 1, 7, 99, 123457])
def test_qmc_table_bit_equal(it):
    # 10 bounces of 7 dims use all 64 primes
    ref = np.asarray(_J_QMC_TABLE(jnp.int32(it), 10))
    got = tsppm.qmc_table(it, 10).numpy()
    assert got.shape == ref.shape == (10, 7)
    np.testing.assert_array_equal(got, ref)


def test_qmc_uniform_bit_equal():
    pix = np.arange(0, 200_000, 3, dtype=np.int32)
    h = tsppm.qmc_table(5, 3).tolist()
    for b in range(3):
        for k in range(7):
            ref = jsppm.qmc_uniform(3, jnp.asarray(pix), jnp.float32(h[b][k]),
                                    k, salt=jnp.int32(b))
            got = tsppm.qmc_uniform(3, _t(pix), h[b][k], k, salt=b)
            np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_hash_cells_bit_equal_with_negative_cells():
    rng = np.random.default_rng(1)
    n = 100_000
    c = rng.integers(-300, 300, (3, n)).astype(np.int32)
    c[:, :6] = np.int32([[-2**31, 2**31 - 1, -1, 0, 1, -7]] * 3)
    c[:, 6:5000] = rng.integers(-2**31, 2**31, (3, 4994)).astype(np.int32)
    for size in (432, 196608, 7):
        ref = np.asarray(jsppm._hash_cells(*(jnp.asarray(x) for x in c), size))
        got = tsppm._hash_cells(*(_t(x) for x in c), size)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), ref)


# --- emission, transport modes, light walk, film splat


def _light_tables():
    jb_, tb_ = jl.LightsBuild(), tl.LightsBuild()
    for b in (jb_, tb_):
        b.add(0, (3.0, 2.0, 1.0), position=(0.5, 2.0, -1.0))
        b.add(1, (0.5, 0.6, 0.7), direction=(0.3, -1.0, 0.2))
        b.add(2, (200.0, 200.0, 200.0), position=(-10.0, 5.0, 15.0),
              direction=(10.3, -5.4, -15.0),
              cos_theta_max=float(np.cos(np.radians(10.0))),
              cos_falloff_start=float(np.cos(np.radians(5.0))))
    wc = np.float32([0.2, -0.4, 0.1])
    return (jl.bake_lights(jb_, [], [], wc, 7.5),
            tl.bake_lights(tb_, [], [], wc, 7.5, "cpu"))


def test_emission_matches_for_point_spot_directional():
    jlt, tlt = _light_tables()
    rng = np.random.default_rng(3)
    n = 6000
    lid = np.repeat(np.arange(3), n // 3)
    u = [rng.uniform(0, 1, n).astype(np.float32) for _ in range(4)]
    u[0][:8] = [0.0, 0.5, 0.5, 0.25, 0.75, 0.999, 0.5, 0.0]  # disk centre,
    u[1][:8] = [0.0, 0.5, 0.9, 0.75, 0.25, 0.001, 0.1, 0.5]  # axes, corners
    ref = jl.sample_emission(jlt, {"em_rows": jnp.zeros((0, 12))},
                             jnp.asarray(lid), *(jnp.asarray(x) for x in u))
    got = tl.sample_emission(tlt, {"em_rows": torch.zeros((0, 12))},
                             _t(lid), *(_t(x) for x in u))
    for k in ("p", "n", "dir", "pdf_pos", "pdf_dir"):
        np.testing.assert_allclose(_np(got[k]), np.asarray(ref[k]), rtol=1e-5,
                                   atol=2e-6, err_msg=k)
    np.testing.assert_array_equal(_np(got["is_delta"]),
                                  np.asarray(ref["is_delta"]))
    # eval toward the sampled directions, toward random ones, and along
    # the directional light's own direction
    wo = rng.normal(size=(n, 3))
    wo /= np.linalg.norm(wo, axis=-1, keepdims=True)
    wo = wo.astype(np.float32)
    wo[n // 3:n // 3 + 50] = _np(tlt["direction"][1])
    for w in (np.asarray(ref["dir"]), wo):
        np.testing.assert_allclose(
            _np(tl.eval_emission(tlt, _t(lid), got["n"], _t(w))),
            np.asarray(jl.eval_emission(jlt, jnp.asarray(lid), ref["n"],
                                        jnp.asarray(w))), **TOL)
    # a table of delta lights never reads the emissive-triangle rows
    again = tl.sample_emission(tlt, {"em_rows": torch.zeros((1, 12))},
                               _t(lid), *(_t(x) for x in u))
    np.testing.assert_array_equal(_np(again["p"]), _np(got["p"]))
    # an environment's radiance changes no lane of a table without one
    assert torch.equal(tl.eval_emission(tlt, _t(lid), got["n"], _t(wo),
                                        env_le=_t(wo)),
                       tl.eval_emission(tlt, _t(lid), got["n"], _t(wo)))


def _mats(rng, n):
    mtype = rng.choice(np.int32([0, 2]), n).astype(np.int32)
    c0, c1 = (rng.uniform(0, 1, (n, 3)).astype(np.float32) for _ in range(2))
    eta = rng.uniform(1.1, 2.0, n).astype(np.float32)
    jmat = {"kinds": (0, 2), "mtype": jnp.asarray(mtype),
            "c0": jnp.asarray(c0), "c1": jnp.asarray(c1),
            "f0": jnp.full(n, 10.0), "eta": jnp.asarray(eta),
            "k": jnp.full(n, -1.0), "is_masked": jnp.zeros(n, bool),
            "mask_alpha": jnp.full(n, 0.5), "mask_u": jnp.zeros(n)}
    tmat = {"kinds": (0, 2), "mtype": _t(mtype), "c0": _t(c0), "c1": _t(c1),
            "eta": _t(eta)}
    return jmat, tmat


@pytest.mark.parametrize("mode", [jb.MODE_RADIANCE, jb.MODE_IMPORTANCE])
def test_bsdf_modes_match(mode):
    assert (tb.MODE_RADIANCE, tb.MODE_IMPORTANCE) == (jb.MODE_RADIANCE,
                                                      jb.MODE_IMPORTANCE)
    rng = np.random.default_rng(10 + mode)
    n = 4096
    jmat, tmat = _mats(rng, n)
    ns, wo, wi, dpdu = (rng.normal(size=(n, 3)) for _ in range(4))
    ns, wo, wi, dpdu = ((v / np.linalg.norm(v, axis=-1, keepdims=True))
                        .astype(np.float32) for v in (ns, wo, wi, dpdu))
    u1, u2, uc = (rng.uniform(0, 1, n).astype(np.float32) for _ in range(3))
    np.testing.assert_allclose(
        _np(tb.bsdf_eval(tmat, _t(ns), _t(wo), _t(wi), tb.BSDF_ALL, mode=mode)),
        np.asarray(jb.bsdf_eval(jmat, jnp.asarray(ns), jnp.asarray(wo),
                                jnp.asarray(wi), jb.BSDF_ALL, mode=mode)),
        **TOL)
    ref = jb.bsdf_sample(jmat, *(jnp.asarray(a) for a in (ns, dpdu, wo, u1,
                                                          u2, uc)),
                         jb.BSDF_ALL, mode=mode)
    got = tb.bsdf_sample(tmat, *(_t(a) for a in (ns, dpdu, wo, u1, u2, uc)),
                         tb.BSDF_ALL, mode=mode)
    for k in ("is_specular", "valid"):
        np.testing.assert_array_equal(_np(got[k]), np.asarray(ref[k]))
    for k in ("f", "wi", "pdf"):
        np.testing.assert_allclose(_np(got[k]), np.asarray(ref[k]), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    mt = np.int32([-3, 0, 1, 2, 3, 4, 5, 9])
    np.testing.assert_array_equal(tb.lobe_of(_t(mt)).numpy(),
                                  np.asarray(jb.lobe_of(jnp.asarray(mt))))


def test_walk_light_paths_matches(tmp_path, monkeypatch):
    """Bunny's spot-light walk (SPPM's radiance mode), 4 surface vertices.
    Vertices on glass can flip a reflect / refract pick where the two
    packages round a Fresnel term differently; nearly every lane agrees."""
    js, jm, ts, tm = _load_both(_bunny(tmp_path, 16, 12, 1, 5), monkeypatch)
    ids = np.arange(3000, dtype=np.int32)
    jem, jv = jsplat.walk_light_paths(js, jm, jnp.asarray(ids), jnp.int32(3),
                                      5, 5, mode=jb.MODE_RADIANCE)
    tem, tv = tsplat.walk_light_paths(ts, tm, _t(ids), 3, 5, 5,
                                      mode=tb.MODE_RADIANCE)
    for k in ("p", "dir", "pdf_pos", "pdf_dir", "vertex_tp"):
        np.testing.assert_allclose(_np(tem[k]), np.asarray(jem[k]), **TOL,
                                   err_msg=k)
    np.testing.assert_array_equal(_np(tem["lid"]), np.asarray(jem["lid"]))
    jvalid, tvalid = np.asarray(jv["valid"]), _np(tv["valid"])
    assert jvalid.shape == tvalid.shape == (4, 3000)
    assert jvalid[1].sum() > 20  # photons that reach a second surface
    assert (jvalid != tvalid).mean() <= 1e-3
    both = jvalid & tvalid
    for k in ("p", "wo_prev", "tp", "ns"):
        a, b = _np(tv[k])[both], np.asarray(jv[k])[both]
        close = np.abs(a - b) <= 1e-4 + 1e-4 * np.abs(b)
        assert close.all(axis=-1).mean() >= 0.99, k
    for k in ("mat", "light"):
        assert (_np(tv[k])[both] == np.asarray(jv[k])[both]).mean() >= 0.99


@pytest.mark.parametrize("kind", ["gaussian", "box"])
def test_film_splat_matches(kind):
    rng = np.random.default_rng(2)
    n = 3000
    fspec = dict(kind=kind, x_width=2.0 if kind == "gaussian" else 0.5,
                 y_width=2.0 if kind == "gaussian" else 0.5, falloff=2.0)
    jspec = jfilm.FilmSpec(x_res=40, y_res=30,
                           filter=jfilm.FilterSpec(**fspec))
    tspec = tfilm.FilmSpec(x_res=40, y_res=30,
                           filter=tfilm.FilterSpec(**fspec))
    x = rng.uniform(-2, 42, n).astype(np.float32)
    y = rng.uniform(-2, 32, n).astype(np.float32)
    L = rng.uniform(0, 2, (n, 3)).astype(np.float32)
    L[5, 1] = np.nan
    x[9] = np.inf
    jc, jw = jfilm.splat(jspec, *jfilm.new_film(jspec), jnp.asarray(x),
                         jnp.asarray(y), jnp.asarray(L))
    tc, tw = tfilm.splat(tspec, *tfilm.new_film(tspec, "cpu"), _t(x), _t(y),
                         _t(L))
    np.testing.assert_allclose(_np(tc), np.asarray(jc), **TOL)
    np.testing.assert_allclose(_np(tw), np.asarray(jw), **TOL)
    assert np.isfinite(_np(tc)).all() and _np(tw).sum() > 0


# --- photon grid and drain, fed the same inputs


def _fake_walk(rng, n_photons, n_verts):
    """Light-walk output for the deposit: vertices spread over cells on
    both sides of bbox_min = 0 (negative cells included)."""
    p = rng.uniform(-1.0, 1.0, (n_verts, n_photons, 3)).astype(np.float32)
    p[:, : n_photons // 4] *= 0.05  # a dense cluster around the origin
    wo = rng.normal(size=(n_verts, n_photons, 3))
    wo = (wo / np.linalg.norm(wo, axis=-1, keepdims=True)).astype(np.float32)
    tp = rng.uniform(0, 2, (n_verts, n_photons, 3)).astype(np.float32)
    valid = rng.uniform(0, 1, (n_verts, n_photons)) < 0.8
    d = rng.normal(size=(n_photons, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return {"p": p, "wo_prev": wo, "tp": tp, "valid": valid}, d


def _grid_both(tmp_path, monkeypatch, n_photons=400, max_len=4):
    """deposit_chunk of both packages on the same walk output."""
    js, jm, ts, tm = _load_both(_two_planes(tmp_path), monkeypatch)
    rng = np.random.default_rng(4)
    verts, d = _fake_walk(rng, n_photons, max_len)
    zeros = np.zeros((n_photons, 3), np.float32)
    lid = np.zeros(n_photons, np.int32)

    def jwalk(scene, meta, ids, it, seed, n, mode):
        assert n == max_len + 1 and mode == jb.MODE_RADIANCE
        return ({"lid": jnp.asarray(lid), "n": jnp.asarray(zeros),
                 "dir": jnp.asarray(d)},
                {k: jnp.asarray(v) for k, v in verts.items()})

    def twalk(scene, meta, ids, it, seed, n, mode):
        assert n == max_len + 1 and mode == tb.MODE_RADIANCE
        return ({"lid": _t(lid), "n": _t(zeros), "dir": _t(d)},
                {k: _t(v) for k, v in verts.items()})

    monkeypatch.setattr(jsplat, "walk_light_paths", jwalk)
    monkeypatch.setattr(tsplat, "walk_light_paths", twalk)
    n_pix = 320
    jdep, jdrain = jsppm.make_photon_passes(js, jm, 9, max_len, n_pix)
    tdep, tdrain = tsppm.make_photon_passes(ts, tm, 9, max_len, n_pix)
    bbox_min = np.zeros(3, np.float32)
    inv_len, max_r = np.float32(1.0 / 0.2), np.float32(0.1)
    ids = np.arange(n_photons, dtype=np.int32)
    jout = jdep(jnp.asarray(ids), jnp.int32(0), jnp.asarray(bbox_min),
                jnp.asarray(inv_len), jnp.asarray(max_r))
    tout = tdep(_t(ids), 0, _t(bbox_min), _t(inv_len), _t(max_r))
    return (jdrain, tdrain, [np.asarray(v) for v in jout],
            [_np(v) for v in tout], (bbox_min, inv_len, max_r), n_pix)


def test_deposit_chunk_grid_matches(tmp_path, monkeypatch):
    _, _, jout, tout, _, _ = _grid_both(tmp_path, monkeypatch)
    (jrows, jhash, jidx), (trows, thash, tidx) = jout, tout
    assert trows.shape == jrows.shape == (3 * 400, 10)
    np.testing.assert_array_equal(trows, jrows)
    np.testing.assert_array_equal(thash, jhash)
    np.testing.assert_array_equal(tidx, jidx)
    live = thash != 0x7FFFFFFF
    # the clamp dedupe leaves 1-8 cells per valid deposit
    assert 1.0 < live.sum() / (0.8 * trows.shape[0]) < 8.0


def test_vp_drain_matches(tmp_path, monkeypatch):
    jdrain, tdrain, jout, tout, (bmin, inv_len, _), n_pix = _grid_both(
        tmp_path, monkeypatch)
    rows = tout[0]
    rng = np.random.default_rng(5)
    # visible points near deposits (dense cells) and scattered ones
    p = rows[rng.integers(0, rows.shape[0], n_pix), 0:3]
    p = (p + rng.normal(size=p.shape) * 0.03).astype(np.float32)
    ns = rng.normal(size=(n_pix, 3))
    ns = (ns / np.linalg.norm(ns, axis=-1, keepdims=True)).astype(np.float32)
    vp = {"p": p, "ns": ns, "wo": ns.copy(), "dpdu": np.zeros_like(p),
          "uv": np.zeros((n_pix, 2), np.float32),
          "mat": np.full(n_pix, 1, np.int32), "tp": np.ones_like(p),
          "len": rng.integers(1, 3, n_pix).astype(np.int32),
          "valid": rng.uniform(0, 1, n_pix) < 0.9}
    radius = rng.uniform(0.03, 0.1, n_pix).astype(np.float32)
    phi0 = rng.uniform(0, 1, (n_pix, 3)).astype(np.float32)
    mi0 = rng.integers(0, 5, n_pix).astype(np.float32)
    jphi, jmi = jdrain({k: jnp.asarray(v) for k, v in vp.items()},
                       jnp.asarray(radius), *(jnp.asarray(v) for v in jout),
                       jnp.asarray(bmin), jnp.asarray(inv_len),
                       jnp.asarray(phi0), jnp.asarray(mi0))
    tphi, tmi = tdrain({k: _t(v) for k, v in vp.items()}, _t(radius),
                       *(_t(v) for v in tout), _t(bmin), _t(inv_len),
                       _t(phi0), _t(mi0))
    np.testing.assert_array_equal(tmi.numpy(), np.asarray(jmi))
    assert (tmi.numpy() - mi0).sum() > n_pix  # deposits were gathered
    np.testing.assert_allclose(tphi.numpy(), np.asarray(jphi), rtol=1e-5,
                               atol=0)


def _drain_per_turn(scene, meta, max_len, n_pix, vp, radius, rows, entry_hash,
                    entry_idx, bbox_min, inv_len, Phi, Mi):
    """The drain as it was before it read the fullest cell's count: the
    host tests the loop condition on the device once a turn."""
    from goblin_tpu_torch.core import vecmath as vm
    from goblin_tpu_torch.integrators.materials import gather_material

    p = vp["p"]
    E = entry_hash.shape[0]
    c = torch.floor((p - bbox_min) * inv_len).to(torch.int32)
    h = tsppm._hash_cells(c[:, 0], c[:, 1], c[:, 2], n_pix)
    start = torch.searchsorted(entry_hash, h)
    end = torch.where(vp["valid"], torch.searchsorted(entry_hash, h, right=True),
                      start)
    mat_v = gather_material(scene, meta, {"mat": vp["mat"], "uv": vp["uv"]})
    r2 = radius * radius
    budget = float(max_len) - vp["len"].to(torch.float32)
    k = 0
    while k < E and bool((start + k < end).any()):
        row = rows[entry_idx[torch.clamp(start + k, max=E - 1)].long()]
        ok = ((start + k < end) & (vm.squared_length(row[:, 0:3] - p) <= r2)
              & (row[:, 9] <= budget))
        fs = tb.bsdf_eval(mat_v, vp["ns"], vp["wo"], row[:, 3:6], tb.BSDF_ALL)
        Phi = Phi + torch.where(ok[:, None], fs * row[:, 6:9], 0.0)
        Mi = Mi + ok.to(torch.float32)
        k += 1
    return Phi, Mi, k


def _host_reads(fn):
    """fn's result and its device-to-host reads (aten::_local_scalar_dense,
    which int() and bool() of a tensor call)."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, sum(e.count for e in prof.key_averages()
                    if e.key == "aten::_local_scalar_dense")


def test_vp_drain_reads_the_device_once_a_drain(tmp_path):
    """With the automatic radius (the scene sets none) the fullest cell
    holds about a hundred entries: the drain reads its count once and takes
    the per-turn loop's turns, so Phi and Mi are bit-equal to it."""
    path = _two_planes(tmp_path, spp=1, res=(24, 18))
    scene, meta = tloader.load_scene(path, device="cpu")
    assert meta.settings["initial_radius"] <= 0.0
    n_pix, max_len = 24 * 18, 3
    ids = torch.arange(n_pix, dtype=torch.int32)
    _, vp = tsppm.make_ray_pass(scene, meta, 0, max_len, 1)(ids, 0)
    radius = tsppm._auto_radius(vp, 24, 18).expand(n_pix).clone()
    bbox_min, inv_len, max_r = tsppm.vp_cell_meta(vp, radius)
    deposit, drain = tsppm.make_photon_passes(scene, meta, 77, max_len, n_pix)
    rows, e_hash, e_idx = deposit(torch.arange(4096, dtype=torch.int32), 0,
                                  bbox_min, inv_len, max_r)
    zeros = (torch.zeros((n_pix, 3)), torch.zeros(n_pix))
    args = (vp, radius, rows, e_hash, e_idx, bbox_min, inv_len)
    (phi, mi), reads = _host_reads(lambda: drain(*args, *zeros))
    (ref_phi, ref_mi, turns), ref_reads = _host_reads(
        lambda: _drain_per_turn(scene, meta, max_len, n_pix, *args, *zeros))
    assert turns > 50 and ref_reads == turns + 1 and reads == 1
    assert torch.equal(phi, ref_phi) and torch.equal(mi, ref_mi)
    assert float(mi.sum()) > n_pix


# --- whole renders


def _bar(got, ref):
    """>= 99% of pixels within 1e-4 + 1e-3 rel, means within 1e-3 rel."""
    close = (np.abs(got - ref) <= 1e-4 + 1e-3 * np.abs(ref)).all(axis=-1)
    return close.mean(), abs(got.mean() - ref.mean()) / abs(ref.mean())


@pytest.mark.parametrize("name", ["two_planes", "bunny"])
def test_render_sppm_matches_goblin_tpu(tmp_path, monkeypatch, name):
    """The two-plane scene (auto radius) at 20 x 16, 2 iterations, depth 3,
    and bunny.json as shipped (initial radius 0.01) at 24 x 18, 2
    iterations, depth 5. Same streams and the same tree: found equal on
    100% of pixels, means within 3e-7 rel, on both."""
    if name == "two_planes":
        path = _two_planes(tmp_path)
    else:
        path = _bunny(tmp_path, 24, 18, 2, 5)
    js, jm, ts, tm = _load_both(path, monkeypatch)
    ref = np.asarray(jsppm.render_sppm(js, jm))
    got = tsppm.render_sppm(ts, tm).numpy()
    assert got.shape == ref.shape and np.isfinite(got).all()
    assert got.mean() > 0
    frac, rel_mean = _bar(got, ref)
    assert frac >= 0.99 and rel_mean <= 1e-3


def test_width_1_and_width_8_renders_agree(tmp_path):
    path = _bunny(tmp_path, 24, 18, 2, 5)
    images = [tsppm.render_sppm(*tloader.load_scene(path, device="cpu",
                                                    trace_wide=w)).numpy()
              for w in (1, 8)]
    frac, rel_mean = _bar(*images)
    assert frac >= 0.99 and rel_mean <= 1e-3


def test_sppm_checkpoint_resume_bit_identical(tmp_path):
    """Save after 2 iterations and resume for 2 more == an uninterrupted 4
    (mirrors tests/test_sppm.py's checkpoint test)."""
    scene, meta = tloader.load_scene(_two_planes(tmp_path, spp=4),
                                     device="cpu")
    full = tsppm.render_sppm(scene, meta, chunk_size=256, iterations=4)
    _, st = tsppm.render_sppm(scene, meta, chunk_size=256, iterations=2,
                              return_state=True)
    ckpt = str(tmp_path / "sppm.npz")
    tsppm.save_sppm_state(ckpt, st)
    resumed = tsppm.render_sppm(scene, meta, chunk_size=256, iterations=4,
                                state=tsppm.load_sppm_state(ckpt))
    np.testing.assert_array_equal(full.numpy(), resumed.numpy())


def test_cli_renders_sppm_on_cpu(tmp_path):
    path = _two_planes(tmp_path)
    assert trender.main([path, "--device", "cpu"]) == 0
    assert os.path.getsize(tmp_path / "scene.exr") > 0


def test_render_dispatch_refuses_lt_and_bdpt(tmp_path):
    """Named for the refusals it replaced: light_tracing and bdpt, refused
    until they were ported, render now (tests/test_torch_lighttracer.py,
    tests/test_torch_bdpt.py); a camera-sampled method is still no
    splatting method."""
    scene, meta = tloader.load_scene(_two_planes(tmp_path), device="cpu")
    for method in ("light_tracing", "bdpt"):
        img = tsplat.render_dispatch(scene, meta, method)
        assert bool(img.isfinite().all()) and float(img.mean()) > 0
    with pytest.raises(ValueError, match="not a splatting method"):
        tsplat.render_dispatch(scene, meta, "ao")
