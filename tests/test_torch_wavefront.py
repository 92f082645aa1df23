"""The regenerative wavefront driver in goblin_tpu_torch: against the port's
chunked driver (tests/test_wavefront.py's three tests, rtol 2e-4 / atol
2e-5) and against goblin_tpu's render_wavefront sample by sample (rtol
1e-4 / atol 1e-6) on the same scenes, plus an env-lit and a homogeneous
fog scene; useful_segments equal to goblin_tpu's; the BSSRDF scene on the
chunked driver; two trace launches and one device read an iteration.

goblin_tpu takes its samples in a screen-tile order and the port in
row-major order: the tests un-permute goblin_tpu's sample buffer with its
own permutation (goblin_tpu/integrators/wavefront.py:105-118). Its jitted
render compiles per scene, so its results come from a module-scoped
fixture.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)

from goblin_tpu.core.rng import hash_uniform as j_hash
from goblin_tpu.integrators import common as jcommon
from goblin_tpu.integrators.path import make_li as j_path_li
from goblin_tpu.integrators.wavefront import render_wavefront as j_render
from goblin_tpu_torch import render as trender
from goblin_tpu_torch.integrators import common as tcommon
from goblin_tpu_torch.io.exr import read_exr
from goblin_tpu_torch.integrators import wavefront as twf
from goblin_tpu_torch.integrators.path import make_li as t_path_li
from goblin_tpu_torch.scene import intersect as tscn
from goblin_tpu_torch.scene import loader as tloader
from test_torch_bssrdf import _ss_scene
from test_torch_envmap import _env_case
from test_torch_slice import _two_triangle_scene
from test_torch_studio import _load_both
from test_torch_textures import few_torch_threads  # noqa: F401
from test_torch_volume import _scene_with_volume, light_gap_in_goblin_tpu
from test_wavefront import AREA, POINT, _scene

# test_torch_volume's scattering fog, at 2 in-scatter samples a lane (each
# adds to goblin_tpu's compile)
FOG = {"type": "homogeneous", "attenuation": [0.5, 0.5, 0.5],
       "albedo": [0.9, 0.9, 0.9], "box_min": [-1.5, -1.5, -1.5],
       "box_max": [1.5, 1.5, 1.5], "sample_num": 2}

# case -> (scene maker, overrides, spp, pool)
CASES = {
    "point": (lambda d: _scene(str(d), [POINT], depth=4), None, 4, 1024),
    "area": (lambda d: _scene(str(d), [AREA, POINT], depth=3), None, 4, 1024),
    "small_pool": (lambda d: _scene(str(d), [POINT], depth=3), None, 1, 128),
    "sky": (lambda d: _env_case(d, "sky", depth=3), None, 4, 1024),
    "fog": (lambda d: _scene_with_volume(d, FOG), {"max_ray_depth": 3}, 4,
            256),
}
# the cases goblin_tpu renders (small_pool is point's scene), and those
# whose useful_segments it also counts (a second jitted call each)
JAX_CASES = ("point", "area", "sky", "fog")
STATS_CASES = ("area", "sky")


def _unpermute(samples, jm, n_spp):
    """goblin_tpu's sample buffer (tile order) in the port's row-major
    order."""
    spec = jm.camera.film
    xs_, xc, ys_, yc = spec.crop_window()
    tile = max(8, int(np.sqrt(jm.trace_rows * 128)))
    idx = np.arange(xc * yc).reshape(yc, xc)
    perm = np.concatenate([idx[ty:ty + tile, tx:tx + tile].reshape(-1)
                           for ty in range(0, yc, tile)
                           for tx in range(0, xc, tile)])
    out = np.empty((n_spp, xc * yc, 3), np.float32)
    out[:, perm] = np.asarray(samples).reshape(n_spp, xc * yc, 3)
    return out.reshape(-1, 3)


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    """Each case loaded by both packages, with goblin_tpu's per-sample
    radiance (row-major) and, for STATS_CASES, its stats."""
    out = {}
    for name, (make, ovr, spp, pool) in CASES.items():
        path = make(tmp_path_factory.mktemp(name))
        js, jm, ts, tm = _load_both(path, ovr)
        out[name] = dict(js=js, jm=jm, ts=ts, tm=tm, spp=spp, pool=pool)
        if name not in JAX_CASES:
            continue
        with light_gap_in_goblin_tpu():
            samples = j_render(js, jm, spp=spp, pool=pool,
                               return_samples=True)
            if name in STATS_CASES:
                out[name]["stats"] = j_render(js, jm, spp=spp, pool=pool,
                                              with_stats=True)[1]
        out[name]["ref"] = _unpermute(samples, jm,
                                      tcommon.spp_grid(spp) ** 2)
    return out


def _off_lanes(got, ref):
    """Samples outside rtol 1e-4 / atol 1e-6 of goblin_tpu's."""
    return np.flatnonzero(~np.isclose(got, ref, rtol=1e-4, atol=1e-6).all(-1))


def _j_li_op_by_op(c, lanes):
    """goblin_tpu's path-tracing li, op by op (no jit), on the given
    samples (row-major ids s * n_pix + k) as one batch."""
    js, jm = c["js"], c["jm"]
    spec = jm.camera.film
    n_pix = spec.x_res * spec.y_res
    s = jnp.asarray(lanes // n_pix, jnp.int32)
    ids = jnp.asarray(lanes % n_pix, jnp.int32)
    x, y = jcommon.pixel_samples(0, ids, spec.x_res, s,
                                 tcommon.spp_grid(c["spp"]))
    ray = jm.camera.generate_ray(
        x, y, j_hash(0, ids, s, jcommon.BOUNCE_CAMERA, jcommon.DIM_LENS_U),
        j_hash(0, ids, s, jcommon.BOUNCE_CAMERA, jcommon.DIM_LENS_V))
    with light_gap_in_goblin_tpu():
        return np.asarray(j_path_li(jm)(js, jm, ray, ids, s, 0))


@pytest.mark.parametrize("name", sorted(CASES))
def test_wavefront_matches_chunked(cases, name):
    """tests/test_wavefront.py's point, area and small-pool (a pool of 128
    lanes for 432 samples) cases, the sky map and the fog, against the
    port's chunked driver."""
    c = cases[name]
    ts, tm = c["ts"], c["tm"]
    ref = tcommon.render(ts, tm, t_path_li(tm), spp=c["spp"],
                         chunk_size=512).numpy()
    got, stats = twf.render_wavefront(ts, tm, spp=c["spp"], pool=c["pool"],
                                      with_stats=True)
    got = got.numpy()
    assert np.isfinite(got).all() and got.mean() > 0
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-5)
    assert stats["iterations"] > 0 and stats["useful_segments"] > 0
    assert stats["lane_rays"] == 2 * stats["iterations"] * stats["pool"]
    assert stats["live_lanes"][0] == min(stats["pool"], ref.size // 3
                                         * tcommon.spp_grid(c["spp"]) ** 2)


def _port_samples(c):
    return twf.render_wavefront(c["ts"], c["tm"], spp=c["spp"], pool=c["pool"],
                                return_samples=True).numpy()


@pytest.mark.parametrize("name", JAX_CASES)
def test_samples_match_goblin_tpu(cases, name):
    """Per-sample radiance, lane by lane, against goblin_tpu's
    render_wavefront (un-permuted): within rtol 1e-4 / atol 1e-6 but on at
    most 0.5% of the samples, and those within 1e-3 rel. They are lanes
    that XLA rounds otherwise in the jitted loop than goblin_tpu's own li
    does (a refraction through the glass ball takes the difference to 4e-4
    rel): test_off_lanes_are_goblin_tpus_rounding."""
    c = cases[name]
    got, ref = _port_samples(c), c["ref"]
    assert got.shape == ref.shape
    assert (np.abs(ref).sum(-1) > 0).mean() > 0.3
    off = _off_lanes(got, ref)
    assert len(off) <= 0.005 * len(ref), off
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-6)


def test_off_lanes_are_goblin_tpus_rounding(cases):
    """The point case's samples outside the bar (2 of 1,728): there the
    port equals goblin_tpu's li run op by op, which goblin_tpu's jitted
    wavefront misses by up to 4e-4 rel."""
    c = cases["point"]
    got = _port_samples(c)
    off = _off_lanes(got, c["ref"])
    assert 0 < len(off) <= 4, off
    li = _j_li_op_by_op(c, off)
    np.testing.assert_allclose(got[off], li, rtol=1e-4, atol=1e-6)
    assert not np.allclose(c["ref"][off], li, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("name", STATS_CASES)
def test_useful_segments_equal_goblin_tpu(cases, name):
    """useful_segments sums over samples, whatever their order: equal to
    goblin_tpu's. The iterations depend on the order; they are bounded."""
    c = cases[name]
    _, stats = twf.render_wavefront(c["ts"], c["tm"], spp=c["spp"],
                                    pool=c["pool"], with_stats=True)
    ref = c["stats"]
    assert stats["useful_segments"] == ref["useful_segments"]
    assert stats["pool"] == ref["pool"]
    depth = c["tm"].settings["max_ray_depth"]
    n_samples = len(c["ref"])
    assert -(-n_samples // stats["pool"]) <= stats["iterations"] <= \
        n_samples * depth
    assert abs(stats["iterations"] - ref["iterations"]) <= \
        max(2, ref["iterations"] // 4)


def test_supports_and_render_context_regen(tmp_path):
    """A BSSRDF scene: supports() is false and render_context(regen=True)
    renders it by the chunked driver, bit for bit; without a BSSRDF,
    regen=True takes the regenerative driver."""
    path = _ss_scene(tmp_path)
    img, meta = trender.render_context(path, device="cpu", regen=True)
    assert meta.has_bssrdf and not twf.supports(meta)
    ref, _ = trender.render_context(path, device="cpu")
    assert torch.equal(img, ref)
    path = _scene(str(tmp_path), [POINT], depth=3)
    img, meta = trender.render_context(path, device="cpu", regen=True,
                                       pool=256)
    assert twf.supports(meta)
    scene, meta = tloader.load_scene(path, device="cpu")
    assert torch.equal(img, twf.render_wavefront(scene, meta, pool=256))


def test_cli_regen_writes_the_chunked_image(tmp_path):
    """python -m goblin_tpu_torch SCENE path_tracing --regen: the EXR the
    chunked driver writes, bit for bit."""
    scene = _two_triangle_scene(tmp_path)
    images = []
    for flags in ([], ["--regen"]):
        assert trender.main([scene, "path_tracing", "--device", "cpu"]
                            + flags) == 0
        images.append(read_exr(str(tmp_path / "quad.exr")))
    np.testing.assert_array_equal(images[1], images[0])
    assert images[0].mean() > 0


class _Reads(TorchDispatchMode):
    """Counts the reads of a tensor's value by the host."""

    READS = (torch.ops.aten.is_nonzero.default, torch.ops.aten.item.default,
             torch.ops.aten._local_scalar_dense.default,
             torch.ops.aten.nonzero.default)

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func in self.READS
        return func(*args, **(kwargs or {}))


def test_two_launches_and_one_read_an_iteration(cases, monkeypatch):
    """On a scene without masks each iteration launches the trace twice
    (the shadow any-hit, the combined closest-hit) and reads the device
    once. The traversal's plain version (the CPU's, which reads as it
    walks) runs outside the count; the dead fragment's zero-ray trace
    launches nothing."""
    c = cases["area"]
    launches = []
    real = tscn.trace

    def spy(scene, o, d, mint, maxt, **kw):
        if o.shape[0]:
            launches.append(kw.get("any_hit", False))
        with _disable_current_modes():
            return real(scene, o, d, mint, maxt, **kw)

    monkeypatch.setattr(tscn, "trace", spy)
    assert not c["tm"].has_null
    with _Reads() as reads:
        twf.render_wavefront(c["ts"], c["tm"], spp=c["spp"], pool=c["pool"])
    iterations = len(launches) // 2
    assert launches == [True, False] * iterations
    assert reads.n == iterations
    _, stats = twf.render_wavefront(c["ts"], c["tm"], spp=c["spp"],
                                    pool=c["pool"], with_stats=True)
    assert stats["iterations"] == iterations
    assert len(stats["live_lanes"]) == iterations


def test_declared_spp_stratifies(cases):
    """A call's spp below the declared one: the pixel grid is the call's,
    the integrator's strata the declared spp's, as in make_li."""
    c = cases["point"]
    ts, tm = c["ts"], c["tm"]
    assert tm.settings["sample_per_pixel"] == 4
    ref = tcommon.render(ts, tm, t_path_li(tm), spp=1).numpy()
    got = twf.render_wavefront(ts, tm, spp=1, pool=256).numpy()
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-5)
