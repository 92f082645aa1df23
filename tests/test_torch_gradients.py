"""Differentiable rendering in goblin_tpu_torch against goblin_tpu: pixel
gradients of a path-traced loss with respect to the light colours, the
constant-texture table, the texture atlas and the triangle vertices; the
train step; gradients taken after a render.

goblin_tpu is loaded with GOBLIN_TRACE=pallas and traced with its jnp
traversal, so both packages walk one tree in one row order, and its
gradients are jax.grad's. The loss is tests/test_gradients.py's: mean(L *
[1, 2, 3]) over one sample of every pixel, the camera a pinhole. Bars:
light colour and tex_const within rtol 1e-4; tri_rows[:, :9] against
tri_soup with >= 99% of entries within 1e-6 + 1e-3 rel (a vertex gradient
sums terms of both signs, so a few entries cancel to rounding); the
finite-difference mirrors at tests/test_gradients.py's tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goblin_tpu.integrators import common as jcommon
from goblin_tpu.integrators.path import make_li as j_make_li
from goblin_tpu.parallel import mesh as jmesh
from goblin_tpu_torch.integrators import common as tcommon
from goblin_tpu_torch.integrators.path import make_li as t_make_li
from goblin_tpu_torch.parallel.mesh import make_train_step
from goblin_tpu_torch.scene import bake as tbake
from goblin_tpu_torch.scene import loader as tloader
from test_gradients import _scene as _grad_plane_path
from test_torch_studio import STUDIO, _load_both, _resized
from test_torch_textures import (GALLERY, WHITE,  # noqa: F401
                                 _plane_scene_path, few_torch_threads)
from test_torch_volume import FOG

W = (1.0, 2.0, 3.0)
LEAVES = tbake.TRAINABLE  # goblin_tpu's pytree leaves, by their names


def _j_leaf(js, name):
    return js["lights"]["color"] if name == "lights.color" else js[name]


def _j_with(js, leaves):
    sc = dict(js)
    sc["lights"] = dict(js["lights"])
    for name, v in leaves.items():
        if name == "lights.color":
            sc["lights"]["color"] = v
        else:
            sc[name] = v
    return sc


_jnp_sqrt = jnp.sqrt


@jax.custom_jvp
def _sqrt_zero_slope_at_0(x):
    return _jnp_sqrt(x)


@_sqrt_zero_slope_at_0.defjvp
def _sqrt_jvp(primals, tangents):
    (x,), (dx,) = primals, tangents
    y = _jnp_sqrt(x)
    return y, jnp.where(x > 0.0, dx / (2.0 * jnp.where(x > 0.0, y, 1.0)), 0.0)


def jax_value_and_grad(js, jm, names=LEAVES):
    """goblin_tpu's loss and jax.grad's gradients of the named leaves, its
    li unrolled and run op by op (a jit of the studio scene's gradient
    compiles for 90 s).

    goblin_tpu writes sqrt(maximum(x, 0)) in a dozen places (the sphere
    quadratic, Fresnel under total internal reflection, ...). At x <= 0 its
    backward multiplies a zero cotangent by sqrt's infinite slope, so a NaN
    reaches every vertex whose continuation ray misses an analytic sphere
    (ROADMAP Queue 3). The port writes torch.clamp, whose backward masks
    those lanes. jnp.sqrt is given a zero slope at 0 while goblin_tpu runs
    here: the values do not move, and its gradients become the port's."""
    li = j_make_li(jm, unroll=True)
    cam, spec = jm.camera, jm.camera.film
    ids = jnp.arange(spec.x_res * spec.y_res, dtype=jnp.int32)

    def loss(leaves):
        x, y = jcommon.pixel_samples(0, ids, spec.x_res, jnp.int32(0), 1)
        ray = cam.generate_ray(x, y)
        L = li(_j_with(js, leaves), jm, ray, ids, jnp.int32(0), 0)
        return jnp.mean(L * jnp.asarray(W))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnp, "sqrt", _sqrt_zero_slope_at_0)
        val, g = jax.value_and_grad(loss)({n: _j_leaf(js, n) for n in names})
        return float(val), {n: np.asarray(v) for n, v in g.items()}


def port_loss(ts, tm):
    """The port's loss of a scene dict."""
    li = t_make_li(tm)
    spec = tm.camera.film
    ids = torch.arange(spec.x_res * spec.y_res, dtype=torch.int32,
                       device=ts["tri_rows"].device)
    w = torch.tensor(W, device=ids.device)

    def loss(scene):
        x, y = tcommon.pixel_samples(0, ids, spec.x_res, 0, 1)
        ray = tm.camera.generate_ray(x, y)
        return (li(scene, tm, ray, ids, 0, 0) * w).mean()

    return loss


def _port_leaves(scene):
    return {"lights.color": scene["lights"]["color"],
            "tex_const": scene["tex_const"], "tex_atlas": scene["tex_atlas"],
            "tri_soup": scene["tri_rows"]}


def port_value_and_grad(ts, tm, arrays=None, names=LEAVES):
    """The port's loss and its gradients of the named leaves (tri_soup's
    as tri_rows' first 9 columns), on the scene with arrays loaded by
    set_trainable_params (goblin_tpu's values in the parity tests)."""
    scene = tbake.set_trainable_params(
        ts, arrays if arrays is not None else tbake.trainable_params(ts))
    leaves = [_port_leaves(scene)[n].requires_grad_() for n in names]
    val = port_loss(ts, tm)(scene)
    grads = torch.autograd.grad(val, leaves, allow_unused=True)
    val = val.detach()
    out = {}
    for n, g, leaf in zip(names, grads, leaves):
        g = torch.zeros_like(leaf) if g is None else g
        out[n] = (g[:, :9] if n == "tri_soup" else g).numpy()
    return float(val), out


def _j_arrays(js, names=LEAVES):
    return {n: np.array(_j_leaf(js, n)) for n in names}


def assert_grads_match(got, ref):
    """The module's bars, leaf by leaf."""
    for name in got:
        g, r = got[name], ref[name]
        assert g.shape == r.shape, name
        assert np.isfinite(g).all(), name
        if name == "tri_soup":
            close = np.abs(g - r) <= 1e-6 + 1e-3 * np.abs(r)
            assert close.mean() >= 0.99, (name, close.mean())
        else:
            np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-9,
                                       err_msg=name)


# ---------------------------------------------------------------------------
# tests/test_gradients.py's plane scene: finite differences, and jax.grad
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def plane(tmp_path_factory):
    path = _grad_plane_path(tmp_path_factory.mktemp("grad"))
    js, jm, ts, tm = _load_both(path)
    return js, jm, ts, tm


def _fd(ts, tm, name, idx, eps):
    """Central finite difference of the port's loss in one entry of a
    leaf (tri_soup's column of tri_rows)."""
    loss = port_loss(ts, tm)
    base = tbake.trainable_params(ts)[name]

    def at(v):
        a = base.copy()
        a[idx] = v
        with torch.no_grad():
            return float(loss(tbake.set_trainable_params(ts, {name: a})))

    return (at(base[idx] + eps) - at(base[idx] - eps)) / (2 * eps)


def test_grad_light_color_vs_fd(plane):
    _, _, ts, tm = plane
    _, g = port_value_and_grad(ts, tm, names=("lights.color",))
    g = g["lights.color"]
    assert np.any(np.abs(g) > 1e-6), "light-color gradient is identically 0"
    for idx in [(0, 0), (0, 1), (0, 2)]:
        fd = _fd(ts, tm, "lights.color", idx, 1e-2)
        assert np.isfinite(fd)
        assert g[idx] == pytest.approx(fd, rel=2e-3, abs=1e-7), idx


def test_grad_material_kd_vs_fd(plane):
    _, _, ts, tm = plane
    _, g = port_value_and_grad(ts, tm, names=("tex_const",))
    g = g["tex_const"]
    assert np.any(np.abs(g) > 1e-6), "Kd gradient is identically zero"
    # row 1 is the "red" constant texture (row 0 = error magenta)
    for idx in [(1, 0), (1, 1), (1, 2)]:
        fd = _fd(ts, tm, "tex_const", idx, 1e-3)
        assert g[idx] == pytest.approx(fd, rel=2e-3, abs=1e-7), idx


def test_grad_vertex_positions_vs_fd(plane):
    """v0.y of both floor triangles: moving the floor toward the light
    changes the light's falloff smoothly (no visibility edge crosses the
    film)."""
    _, _, ts, tm = plane
    _, g = port_value_and_grad(ts, tm, names=("tri_soup",))
    g = g["tri_soup"]
    assert np.any(np.abs(g) > 1e-6), "vertex gradient is identically zero"
    checked = 0
    for tri in range(min(2, g.shape[0])):
        idx = (tri, 1)  # v0.y
        if abs(g[idx]) < 1e-6:
            continue
        fd = _fd(ts, tm, "tri_soup", idx, 1e-3)
        assert g[idx] == pytest.approx(fd, rel=5e-2, abs=1e-6), idx
        checked += 1
    assert checked > 0, "no triangle had a nonzero v0.y gradient"


def test_grad_no_nan_through_bounce_loop(plane):
    """Every float tensor of the scene requires grad at once, and every
    gradient is finite: the detach boundary around the traversal holds."""
    _, _, ts, tm = plane

    def leaves(d):
        for k, v in d.items():
            if isinstance(v, dict):
                yield from leaves(v)
            elif isinstance(v, torch.Tensor) and v.is_floating_point():
                yield v

    def copied(d):
        return {k: copied(v) if isinstance(v, dict) else
                (v.clone().requires_grad_() if isinstance(v, torch.Tensor)
                 and v.is_floating_point() else v) for k, v in d.items()}

    scene = copied(ts)
    xs = list(leaves(scene))
    grads = torch.autograd.grad(port_loss(ts, tm)(scene), xs,
                                allow_unused=True)
    assert any(g is not None and bool((g != 0).any()) for g in grads)
    for g in grads:
        if g is not None:
            assert bool(torch.isfinite(g).all())


def test_trace_returns_no_graph(plane):
    """The traversal is detached: its outputs carry no grad_fn even where
    every input requires grad, and an intersect of rays that require grad
    reaches the vertices only through the hit recompute."""
    from goblin_tpu_torch.ops import trace as tt
    from goblin_tpu_torch.scene import intersect as scn

    _, _, ts, tm = plane
    scene = dict(ts, tri_rows=ts["tri_rows"].clone().requires_grad_())
    o = torch.tensor([[0.1, 2.0, 0.2]]).repeat(8, 1).requires_grad_()
    d = torch.tensor([[0.0, -1.0, 0.0]]).repeat(8, 1).requires_grad_()
    mint, maxt = torch.full((8,), 1e-4), torch.full((8,), 1e30)
    for res in (tt.trace(scene, o, d, mint, maxt),
                tt.trace_plain(scene, o, d, mint, maxt),
                scn.trace_rays(scene, tm, o, d, mint, maxt),
                scn.trace_rays(scene, tm, o, d, mint, maxt, any_hit=True)):
        assert all(x.grad_fn is None and not x.requires_grad for x in res)
    frag = scn.intersect(scene, tm, o, d, mint, maxt)
    assert bool(frag["hit"].all())
    assert frag["t"].grad_fn is not None
    g = torch.autograd.grad(frag["t"].sum(), scene["tri_rows"])[0]
    assert bool((g[:, 9:] == 0).all()) and bool((g[:, :9] != 0).any())


def test_plane_grads_match_jax(plane):
    js, jm, ts, tm = plane
    names = ("lights.color", "tex_const", "tri_soup")
    ref_val, ref = jax_value_and_grad(js, jm, names)
    val, got = port_value_and_grad(ts, tm, _j_arrays(js, names), names)
    assert val == pytest.approx(ref_val, rel=1e-5)
    assert_grads_match(got, ref)


def test_studio_grads_match_jax():
    """examples/bunny_studio.json at 16 x 12, depth 3: area, sphere and spot
    lights, analytic spheres and disks, the mask's attenuation, Blinn and
    glass."""
    js, jm, ts, tm = _load_both(STUDIO, {"sample_per_pixel": 1,
                                         "max_ray_depth": 3})
    jm, tm = _resized(jm, 16, 12), _resized(tm, 16, 12)
    names = ("lights.color", "tex_const", "tri_soup")
    ref_val, ref = jax_value_and_grad(js, jm, names)
    val, got = port_value_and_grad(ts, tm, _j_arrays(js, names), names)
    assert val == pytest.approx(ref_val, rel=1e-4)
    assert np.abs(ref["tri_soup"]).max() > 0
    assert_grads_match(got, ref)


def _image_scene(tmp_path, filt):
    """tests/test_texchain.py's uv plane under an image texture of
    random texels (seeded), filtered by filt."""
    img = np.random.default_rng(7).uniform(0.1, 0.9, (32, 32, 3)).astype(
        np.float32)
    textures = WHITE + [{"format": "color", "name": "img", "type": "image",
                         "file": "img.exr", "filter": filt}]
    mats = [{"name": "mat", "type": "lambert", "Kd": "img"}]
    return _plane_scene_path(tmp_path, mats, textures,
                             extra_files={"img.exr": img})


@pytest.mark.parametrize("filt", ["bilinear", "trilinear", "ewa"])
def test_tex_atlas_grads_match_jax(tmp_path, filt):
    js, jm, ts, tm = _load_both(_image_scene(tmp_path, filt))
    names = ("lights.color", "tex_atlas")
    ref_val, ref = jax_value_and_grad(js, jm, names)
    val, got = port_value_and_grad(ts, tm, _j_arrays(js, names), names)
    assert val == pytest.approx(ref_val, rel=1e-5)
    assert (np.abs(ref["tex_atlas"]) > 0).sum() > 100
    assert_grads_match(got, ref)


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------


def test_train_step_matches_goblin_tpu(tmp_path):
    """make_train_step against make_sharded_train_step on a one-device
    mesh, on the image-texture plane: loss within rtol 1e-5, gradients of
    (light colour, atlas) within rtol 1e-4. goblin_tpu's step adds a
    boundary_grad_fn's pytree; the port's step is taken without it and
    with it."""
    js, jm, ts, tm = _load_both(_image_scene(tmp_path, "trilinear"))
    spec = tm.camera.film
    n_pix = spec.x_res * spec.y_res
    params_np = (np.asarray(js["lights"]["color"]) * 1.5,
                 np.asarray(js["tex_atlas"]) * 0.9)
    # added to the light's gradient only: an atlas entry that the boundary
    # term swamped could not be held to its AD part
    extra = (np.full_like(params_np[0], 0.25), np.zeros_like(params_np[1]))

    def j_boundary(params, pixel_ids, s_idx):
        return tuple(jnp.asarray(e) for e in extra)

    jstep, _ = jmesh.make_sharded_train_step(
        js, jm, j_make_li(jm), jmesh.make_mesh(1),
        boundary_grad_fn=j_boundary)
    jloss, jg = jstep(tuple(jnp.asarray(p) for p in params_np),
                      jnp.arange(n_pix, dtype=jnp.int32), jnp.int32(0))
    jg = [np.asarray(g) for g in jg]
    assert (np.abs(jg[1]) > 0).sum() > 100
    params = tuple(torch.as_tensor(p) for p in params_np)
    ids = torch.arange(n_pix, dtype=torch.int32)
    for bfn, plus in ((None, extra), (
            lambda p, i, s: tuple(torch.as_tensor(e) for e in extra),
            (0.0, 0.0))):
        tstep = make_train_step(ts, tm, t_make_li(tm), boundary_grad_fn=bfn)
        tloss, tg = tstep(params, ids, 0)
        assert float(tloss) == pytest.approx(float(jloss), rel=1e-5)
        for g, r, a in zip(tg, jg, plus):
            assert g.device.type == "cpu" and g.grad_fn is None
            np.testing.assert_allclose(g.numpy() + a, r, rtol=1e-4,
                                       atol=1e-9)


def test_train_step_chunks_sum_to_the_whole(tmp_path):
    """A frame split into chunks of pixel ids, each chunk's loss and
    gradients weighted by its share, gives the whole frame's."""
    _, _, ts, tm = _load_both(_image_scene(tmp_path, "bilinear"))
    step = make_train_step(ts, tm, t_make_li(tm))
    params = (ts["lights"]["color"], ts["tex_atlas"])
    ids = torch.arange(tm.camera.film.x_res * tm.camera.film.y_res,
                       dtype=torch.int32)
    whole_loss, whole = step(params, ids, 0)
    loss, grads = 0.0, [0.0, 0.0]
    for chunk in torch.split(ids, 100):
        share = chunk.numel() / ids.numel()
        c_loss, c_grads = step(params, chunk, 0)
        loss += share * c_loss
        grads = [g + share * c for g, c in zip(grads, c_grads)]
    assert float(loss) == pytest.approx(float(whole_loss), rel=1e-5)
    for g, w in zip(grads, whole):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-9)


def test_trainable_params_round_trip(plane):
    _, _, ts, _ = plane
    arrays = tbake.trainable_params(ts)
    assert set(arrays) == set(tbake.TRAINABLE)
    np.testing.assert_array_equal(arrays["tri_soup"],
                                  ts["tri_rows"][:, :9].numpy())
    moved = {k: v + 1.0 for k, v in arrays.items()}
    before = {k: v.clone() for k, v in _port_leaves(ts).items()}
    new = tbake.set_trainable_params(ts, moved)
    for k, v in _port_leaves(new).items():
        assert v is not _port_leaves(ts)[k]
        torch.testing.assert_close(_port_leaves(ts)[k], before[k], rtol=0,
                                   atol=0)  # the baked tables stay
    np.testing.assert_array_equal(tbake.trainable_params(new)["tri_soup"],
                                  moved["tri_soup"])
    np.testing.assert_array_equal(new["tri_rows"][:, 9:].numpy(),
                                  ts["tri_rows"][:, 9:].numpy())
    assert new["lights"]["type"] is ts["lights"]["type"]
    with pytest.raises(KeyError):
        tbake.set_trainable_params(ts, {"tri_n": arrays["tri_soup"]})
    with pytest.raises(ValueError):
        tbake.set_trainable_params(ts, {"tex_const": arrays["tex_const"][1:]})


# ---------------------------------------------------------------------------
# A gradient after a render
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("path", [GALLERY, FOG], ids=["gallery", "fog"])
def test_grad_after_render_equals_grad_without(path):
    """A render fills the scene's cached tables inside inference mode; a
    gradient taken after it is finite and equals one taken on a freshly
    loaded scene that never rendered."""
    ovr = {"sample_per_pixel": 1, "max_ray_depth": 2}
    grads = []
    for render_first in (True, False):
        ts, tm = tloader.load_scene(path, ovr, device="cpu")
        tm = _resized(tm, 8, 6)
        if render_first:
            img = tcommon.render(ts, tm, t_make_li(tm))
            assert bool(img.isfinite().all()) and float(img.mean()) > 0
        grads.append(port_value_and_grad(ts, tm)[1])
    after, fresh = grads
    for name in LEAVES:
        assert np.isfinite(after[name]).all(), name
        np.testing.assert_array_equal(after[name], fresh[name], err_msg=name)
    assert np.count_nonzero(after["lights.color"]) > 0
    if path == GALLERY:
        assert np.count_nonzero(after["tex_atlas"]) > 100
