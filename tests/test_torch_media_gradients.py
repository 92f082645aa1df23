"""Gradients through participating media and the BSSRDF: goblin_tpu_torch's
path-traced loss and its gradients against jax.grad of goblin_tpu's, on
examples/bunny_fog.json (a homogeneous box, a jade subsurface bunny) and
examples/bunny_smoke.json (a 64^3 density grid, a marble bunny).

The loss is test_torch_gradients.py's: mean(L * [1, 2, 3]) over one sample
of every pixel of an 8 x 6 film, the camera a pinhole, at 1 spp. goblin_tpu
runs op by op with its li unrolled (its march and in-scatter loops have a
static trip count, march_steps, so jax.grad reverses them); the port's
volume shadow rays stop volume.LIGHT_GAP short of their light sample, and
the fixture `light_gap` gives goblin_tpu's volume module the same cut. Bars
(test_torch_gradients.assert_grads_match): light colour and tex_const
within rtol 1e-4, tri_rows[:, :9] against tri_soup with >= 99% of entries
within 1e-6 + 1e-3 rel.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from goblin_tpu.integrators import bssrdf as jb
from goblin_tpu.shading.bsdf import MAT_SUBSURFACE
from test_torch_gradients import (_j_arrays, assert_grads_match,
                                  jax_value_and_grad, port_value_and_grad)
from test_torch_studio import _load_both, _resized
from test_torch_textures import few_torch_threads  # noqa: F401
from test_torch_volume import FOG, SMOKE, light_gap  # noqa: F401

NAMES = ("lights.color", "tex_const", "tri_soup")
_j_subsurface_L = jb.subsurface_L


def _subsurface_L_reading_ones(scene, meta, *args, **kw):
    """goblin_tpu's subsurface_L with eta and the sigmas of every material
    that is not subsurface read as 1, as the port reads them: the values
    on its lanes are dropped, so L does not move."""
    ss = np.asarray(scene["mat_type"]) == MAT_SUBSURFACE
    sc = dict(scene)
    sc["mat_eta"] = jnp.where(ss, scene["mat_eta"], 1.0)
    for key in ("mat_sigma_a", "mat_sigma_sp"):
        sc[key] = jnp.where(ss[:, None], scene[key], 1.0)
    return _j_subsurface_L(sc, meta, *args, **kw)


@pytest.fixture
def bssrdf_ones():
    """goblin_tpu's subsurface_L reads the sigmas of every lane's material:
    0 for a material that is not subsurface, so its single-scatter term is
    0 / 0 there. jnp.where drops that value, but jax.grad multiplies the
    zero cotangent by it, and every light colour's gradient is NaN (ROADMAP
    Queue 3). The port reads 1s on those lanes; goblin_tpu is given the
    same while the fixture is active."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jb, "subsurface_L", _subsurface_L_reading_ones)
        yield


CASES = {"fog": (FOG, 3, "homogeneous"), "smoke": (SMOKE, 2, "heterogeneous")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_media_grads_match_jax(case, light_gap, bssrdf_ones):
    path, depth, kind = CASES[case]
    js, jm, ts, tm = _load_both(path, {"sample_per_pixel": 1,
                                       "max_ray_depth": depth})
    jm, tm = _resized(jm, 8, 6), _resized(tm, 8, 6)
    assert tm.volume.kind == kind and tm.has_bssrdf
    ref_val, ref = jax_value_and_grad(js, jm, NAMES)
    val, got = port_value_and_grad(ts, tm, _j_arrays(js, NAMES), NAMES)
    assert val == pytest.approx(ref_val, rel=1e-4)
    for name in NAMES:
        assert np.abs(ref[name]).max() > 0, name
    assert_grads_match(got, ref)
    # the bar again over the vertex entries that have a gradient
    g, r = got["tri_soup"], ref["tri_soup"]
    close = np.abs(g - r) <= 1e-6 + 1e-3 * np.abs(r)
    assert close[r != 0].mean() >= 0.99


def test_goblin_tpus_bssrdf_gradient_is_nan(light_gap):
    """Without the fixture bssrdf_ones, goblin_tpu's light-colour gradient
    on the fog scene is NaN in every entry (at the camera hit alone: depth
    1); the port's is finite and nonzero."""
    js, jm, ts, tm = _load_both(FOG, {"sample_per_pixel": 1,
                                      "max_ray_depth": 1})
    jm, tm = _resized(jm, 8, 6), _resized(tm, 8, 6)
    names = ("lights.color",)
    _, ref = jax_value_and_grad(js, jm, names)
    assert np.isnan(ref["lights.color"]).all()
    _, got = port_value_and_grad(ts, tm, _j_arrays(js, names), names)
    assert np.isfinite(got["lights.color"]).all()
    assert np.count_nonzero(got["lights.color"]) > 0
