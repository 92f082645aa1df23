"""examples/bunny_gallery.json (the studio scene under the texture chain)
rendered at 32 x 24 by goblin_tpu_torch and by goblin_tpu on the CPU under
ao, whitted, light_tracing and sppm (path_tracing, the baked tables and
the fragments: tests/test_torch_textures.py), and by the port alone
through render_context under all six methods.

Same sample streams and the same tree in both packages; the bar is
PERF.md's: >= 99% of pixels within 1e-4 + 1e-3 rel, means within 1e-3 rel.
AO, light tracing and SPPM go through goblin_tpu's own jitted renders
(12-40 s of XLA compile each). Whitted's unrolled tree over this scene's
texture lookups takes goblin_tpu a quarter of an hour to compile at depth
2, so its li runs op by op (test_torch_textures.jax_render_unjitted) and
at max_ray_depth 1: 3 nodes x 3 lights, each shadow query four
punch-through rounds, every fragment perturbed and textured.
"""

import numpy as np
import pytest

from goblin_tpu import splatting as jsplat
from goblin_tpu.integrators import common as jcommon
from goblin_tpu.integrators import sppm as jsppm
from goblin_tpu.integrators.ao import make_li as j_ao_li
from goblin_tpu.integrators.whitted import make_li as j_whitted_li
from goblin_tpu_torch import splatting as tsplat
from goblin_tpu_torch.integrators import common as tcommon
from goblin_tpu_torch.integrators import sppm as tsppm
from goblin_tpu_torch.render import make_li as t_make_li
from test_torch_studio import _bar, _load_both, _resized
from test_torch_textures import (GALLERY, few_torch_threads,  # noqa: F401
                                 jax_render_unjitted)


def _gallery(method, **settings):
    js, jm, ts, tm = _load_both(GALLERY, {"render_method": method,
                                          "sample_per_pixel": 1, **settings})
    return js, _resized(jm, 32, 24), ts, _resized(tm, 32, 24)


def _in_the_bar(got, ref, floor):
    assert got.shape == ref.shape == (24, 32, 3) and np.isfinite(got).all()
    frac, rel = _bar(got, ref)
    assert frac >= 0.99 and rel <= 1e-3 and got.mean() > floor


def test_gallery_ao_matches_goblin_tpu():
    """25 directions a pixel."""
    js, jm, ts, tm = _gallery("ao")
    ref = np.asarray(jcommon.render(js, jm, j_ao_li(25)))
    _in_the_bar(tcommon.render(ts, tm, t_make_li(tm)).numpy(), ref, 0.3)


def test_gallery_whitted_matches_goblin_tpu():
    js, jm, ts, tm = _gallery("whitted", max_ray_depth=1)
    ref = jax_render_unjitted(js, jm, j_whitted_li(jm))
    _in_the_bar(tcommon.render(ts, tm, t_make_li(tm)).numpy(), ref, 0.05)


def test_gallery_light_tracing_matches_goblin_tpu():
    """1 spp, depth 5, chunks of 256 paths: the texture chain on the light
    walk (perturbed normals, filtered lookups without a footprint) and on
    the connections' material lookups."""
    js, jm, ts, tm = _gallery("light_tracing")
    ref = np.asarray(jsplat.render_light_tracer(js, jm, chunk_size=256))
    _in_the_bar(tsplat.render_light_tracer(ts, tm, chunk_size=256).numpy(),
                ref, 0.05)


def test_gallery_sppm_matches_goblin_tpu():
    """2 iterations, depth 5, radius 0.01 as the scene asks."""
    js, jm, ts, tm = _gallery("sppm", sample_per_pixel=2)
    ref = np.asarray(jsppm.render_sppm(js, jm))
    _in_the_bar(tsppm.render_sppm(ts, tm).numpy(), ref, 0.05)


@pytest.mark.parametrize("method", ["ao", "whitted", "light_tracing", "sppm",
                                    "path_tracing", "bdpt"])
def test_gallery_renders_through_render_context(method):
    """The user's entry point on the CPU at the scene's own size would take
    minutes; a 16 x 12 film through the same dispatch (bdpt: the walks'
    materials and the connections' re-gathers through the texture chain)."""
    import dataclasses

    from goblin_tpu_torch import render as trender
    from goblin_tpu_torch.scene import loader as tloader

    real = tloader.load_scene

    def small(path, overrides=None, **kw):
        scene, meta = real(path, overrides, **kw)
        film = dataclasses.replace(meta.camera.film, x_res=16, y_res=12)
        meta.camera = dataclasses.replace(meta.camera, film=film)
        return scene, meta

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trender, "load_scene", small)
        img, meta = trender.render_context(
            GALLERY, {"render_method": method, "sample_per_pixel": 1,
                      "max_ray_depth": 2}, device="cpu")
    assert meta.settings["render_method"] == method
    assert tuple(img.shape) == (12, 16, 3)
    assert bool(img.isfinite().all()) and float(img.mean()) > 0.05
