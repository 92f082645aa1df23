"""The width-4 instance of the wide traversal on the CPU: its tables against
goblin_tpu's collapse4(width=4), its plain version against
trace_packets4(width=4) in interpret mode, the numpy emulation of the CUDA
kernel's walk at 4 lanes a ray, the per-width depth limit, and whole
renders at width 4.

Inputs are made with numpy from a seed and handed to both packages.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goblin_tpu.accel import bvh as jbvh
from goblin_tpu.ops.pallas_trace import collapse4, pack_scene, trace_packets4
from goblin_tpu_torch.accel import bvh as tbvh
from goblin_tpu_torch.geometry import mesh as tmesh
from goblin_tpu_torch.integrators import common as tcommon
from goblin_tpu_torch.ops import trace as tt
from goblin_tpu_torch.render import make_li
from goblin_tpu_torch.scene.loader import load_scene
from test_torch_trace_design import (_bunny_rays, _check_against_plain,
                                     _soup_scene)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUNNY = os.path.join(REPO, "examples", "bunny.json")
BUNNY_OBJ = os.path.join(REPO, "examples", "models", "bunny.obj")
F = np.float32


def _bunny_tree():
    m = tmesh.load_obj(BUNNY_OBJ)
    v = m.positions[m.faces]
    return tbvh.align_leaves(
        tbvh.build_bvh(v[:, 0], v[:, 1], v[:, 2], max_leaf=32), align=8)


def test_bvh4_tables_match_collapse4():
    """Node for node, child order included: the same slots hold the same
    children with the same bounds."""
    tree = _bunny_tree()
    nb, nc, depth = tt.collapse_wide(tree.bounds, tree.meta, 4)
    nb4, nm4 = collapse4(tree.bounds, tree.meta, width=4)
    assert nb.shape == (nb4.shape[0], 6, 4) and nc.shape == (nb.shape[0], 4)
    for c in range(4):
        f0, cnt = nm4[:, 4 * c], nm4[:, 4 * c + 1]
        want = np.where(cnt > 0, -(((f0 // 8) << 7) | cnt) - 1,
                        np.where(cnt == 0, f0, tt.EMPTY))
        np.testing.assert_array_equal(nc[:, c], want)
        live = cnt >= 0
        np.testing.assert_array_equal(nb[live, :, c],
                                      nb4[live, 8 * c:8 * c + 6])
    # the bare mesh's 4-wide tree has 8 levels (its 8-wide tree 5): no
    # margin under the width-8 kernel's 9, so the width-4 kernel keeps 16
    assert depth == 8 and depth <= tt.wide_levels(4)
    assert tt.stack_bound(depth, 4) <= tt.STACK


def test_collapse_wide_width_and_single_leaf():
    bounds = np.float32([[0, 0, 0, 1, 1, 1]])
    meta = np.int32([[0, 5, 1]])
    nb, nc, depth = tt.collapse_wide(bounds, meta, 4)
    assert nb.shape == (1, 6, 4)
    assert depth == 1 and nc.tolist() == [[tt.leaf_entry(0, 5)] + [-1] * 3]
    with pytest.raises(ValueError, match="width"):
        tt.collapse_wide(bounds, meta, 2)
    with pytest.raises(ValueError, match="width"):
        tt.wide_tables(16)


def _random_scene(seed=3, n_tri=600, n_rays=1024):
    """The 600-triangle / 1024-ray case of test_pallas_trace.py."""
    rng = np.random.default_rng(seed)
    p0 = (rng.uniform(-1, 1, (n_tri, 3)) * 3).astype(F)
    p1 = p0 + rng.normal(size=(n_tri, 3)).astype(F) * 0.4
    p2 = p0 + rng.normal(size=(n_tri, 3)).astype(F) * 0.4
    tree = jbvh.align_leaves(jbvh.build_bvh(p0, p1, p2, max_leaf=8), align=8)
    order = tree.order
    safe = np.where(order < 0, 0, order)
    soup = np.concatenate([p0[safe], p1[safe] - p0[safe], p2[safe] - p0[safe]],
                          axis=-1).astype(F)
    soup[order < 0] = 0.0
    o = (rng.uniform(-1, 1, (n_rays, 3)) * 6).astype(F)
    tgt = rng.normal(size=(n_rays, 3)).astype(F) * 1.5
    d = tgt - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return tree, soup, o, d


@pytest.mark.parametrize("any_hit", [False, True])
def test_plain_trace_w4_matches_trace_packets4(any_hit):
    """tests/test_pallas_trace.py's bar for the wide kernel: equal hit
    masks, t within 1e-4 rel, the same triangle on >= 99% of hits."""
    tree, soup, o, d = _random_scene()
    mint = np.full(len(o), 1e-4, F)
    maxt = np.full(len(o), 1e30, F)
    maxt[::7] = 2.0  # short segments for the any-hit early exit
    mint[::13] = 3e38  # dead lanes
    nb4, nm4 = collapse4(tree.bounds, tree.meta, width=4)
    packed = pack_scene(tree.bounds, tree.meta, soup)
    ref = [np.asarray(v) for v in trace_packets4(
        jnp.asarray(nb4), jnp.asarray(nm4), jnp.asarray(packed["tris"]),
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(mint), jnp.asarray(maxt),
        max_leaf=8, rows=8, width=4, any_hit=any_hit, interpret=True,
    )]
    nb, nc, _ = tt.collapse_wide(tree.bounds, tree.meta, 4)
    scene = {"bvh4_bounds": torch.as_tensor(nb),
             "bvh4_child": torch.as_tensor(nc),
             "tri_rows": torch.as_tensor(tt.tri_rows(soup))}
    got = [v.numpy() for v in tt.trace(
        scene, torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(mint),
        torch.as_tensor(maxt), any_hit=any_hit, width=4)]
    h = ref[0]
    assert h.sum() > 100
    np.testing.assert_array_equal(got[0], h)
    assert not got[0][::13].any()
    if not any_hit:
        np.testing.assert_allclose(got[1][h], ref[1][h], rtol=1e-4)
        assert (got[1][~h] == tt.BIG_T).all()
        assert (got[2][h] == ref[2][h]).mean() >= 0.99
        assert (got[2][~h] == -1).all()


@pytest.fixture(scope="module")
def bunny4():
    return _bunny_rays(width=4)


@pytest.mark.parametrize("any_hit", [False, True])
def test_level_stack_walk_w4_matches_plain_on_bunny(bunny4, any_hit):
    """The kernel's walk with 4 lanes a ray (4 nibbles a packed list, 4
    triangles a round) against trace_plain, exactly, visit counts too."""
    scene, meta, rays = bunny4
    assert meta.trace_wide == 4 and meta.wide_depth <= tt.wide_levels(4)
    assert "bvh4_child" in scene and "bvh8_child" not in scene
    assert _check_against_plain(scene, rays, any_hit, width=4) > 100


@pytest.mark.parametrize("any_hit", [False, True])
def test_level_stack_walk_w4_matches_plain_on_two_triangles(any_hit):
    # rays through the shared edge hit both triangles at the same t: the
    # last-of-equal-t rule across rounds of 4 lanes
    p0 = np.array([[0, 0, 0], [1, 1, 0]], F)
    p1 = np.array([[1, 0, 0], [0, 1, 0]], F)
    p2 = np.array([[0, 1, 0], [1, 0, 0]], F)
    scene, _ = _soup_scene(p0, p1, p2, max_leaf=8, width=4)
    rng = np.random.default_rng(5)
    n = 200
    target = np.concatenate([rng.uniform(-0.2, 1.2, (n - 40, 2)),
                             np.stack([np.linspace(0, 1, 40),
                                       1 - np.linspace(0, 1, 40)], -1)])
    o = np.concatenate([target, np.full((n, 1), 2.0)], -1).astype(F)
    d = np.tile(np.array([0, 0, -1], F), (n, 1))
    mint = np.full(n, 1e-4, F)
    maxt = np.where(np.arange(n) % 7 == 0, 1.0, 1e30).astype(F)
    assert _check_against_plain(scene, [o, d, mint, maxt], any_hit,
                                width=4) > 50


def test_w4_and_w8_plain_agree_on_bunny(bunny4):
    """Two trees over the same triangles: the same hits, t and triangles
    (a tie between two triangles may resolve differently by visit order)."""
    scene4, _, rays = bunny4
    scene8, _, _ = _bunny_rays(width=8)
    rays = [torch.as_tensor(a) for a in rays]
    a = tt.trace_plain(scene4, *rays, width=4)
    b = tt.trace_plain(scene8, *rays, width=8)
    assert torch.equal(a.hit, b.hit) and int(a.hit.sum()) > 100
    h = a.hit
    np.testing.assert_allclose(a.t[h].numpy(), b.t[h].numpy(), rtol=1e-4)
    assert (a.tri[h] == b.tri[h]).float().mean() >= 0.99
    np.testing.assert_array_equal(
        tt.trace_plain(scene4, *rays, any_hit=True, width=4).hit.numpy(),
        tt.trace_plain(scene8, *rays, any_hit=True, width=8).hit.numpy())


@pytest.mark.parametrize("any_hit", [False, True])
def test_plain_census_w4(bunny4, any_hit):
    """census=True at width 4: live slots tested per inner visit (at most
    4) and triangles per leaf visit, beside the stats counts."""
    scene, _, rays = bunny4
    rays = [torch.as_tensor(a) for a in rays]
    res, work = tt.trace_plain(scene, *rays, any_hit=any_hit, census=True,
                               width=4)
    ref, counts = tt.trace_plain(scene, *rays, any_hit=any_hit, stats=True,
                                 width=4)
    assert torch.equal(res.hit, ref.hit)
    np.testing.assert_array_equal(work[:, 0].numpy(), counts[:, 0].numpy())
    np.testing.assert_array_equal(work[:, 1].numpy(), counts[:, 1].numpy())
    inner, leaf, boxes, tris = (work[:, k].numpy() for k in range(4))
    assert (boxes <= 4 * inner).all() and (boxes >= 2 * inner).all()
    assert (tris <= 32 * leaf).all() and (tris >= leaf).all()
    assert inner.sum() > 0 and leaf.sum() > 0


def test_depth_limit_is_per_width(monkeypatch):
    assert (tt.wide_levels(8), tt.wide_levels(4)) == (tt.WIDE_LEVELS,
                                                      tt.WIDE4_LEVELS)
    tt.check_wide_depth(tt.WIDE4_LEVELS, 4)
    with pytest.raises(ValueError, match="BVH4 depth 17"):
        tt.check_wide_depth(tt.WIDE4_LEVELS + 1, 4)
    with pytest.raises(ValueError, match="BVH8 depth 10"):
        tt.check_wide_depth(tt.WIDE_LEVELS + 1, 8)
    # trace_plain's stack holds what the deepest 4-wide tree can push
    assert tt.stack_bound(tt.WIDE4_LEVELS, 4) <= tt.STACK
    # bunny's 4-wide tree has 9 levels: a kernel with 8 refuses it, and the
    # width-8 limit is not the one consulted
    monkeypatch.setattr(tt, "WIDE4_LEVELS", 8)
    with pytest.raises(ValueError, match="stack levels"):
        load_scene(BUNNY, device="cpu", trace_wide=4)
    load_scene(BUNNY, device="cpu", trace_wide=8)


def test_build_key_differs_by_width():
    """One source, two libraries: the width's define enters the key."""
    assert tt.KERNEL_SOURCES["trace_bvh4"] == tt.KERNEL_SOURCES["trace_bvh8"]
    assert tt.build_key("trace_bvh4") != tt.build_key("trace_bvh8")
    assert "-DGOBLIN_TRACE_WIDTH=4" in tt.KERNEL_DEFINES["trace_bvh4"]
    assert set(tt.launches) >= {"trace_bvh4", "trace_bvh4_stats"}


def test_bunny_render_w4_matches_w8():
    """PT 24 x 18, 1 spp, depth 5 at width 4 and 8: same streams, the same
    triangles hit, so the images agree within the image bar."""
    images = []
    for w in (4, 8):
        scene, meta = load_scene(
            BUNNY, {"render_method": "path_tracing", "sample_per_pixel": 1,
                    "max_ray_depth": 5}, device="cpu", trace_wide=w)
        cam = meta.camera
        meta.camera = type(cam)(**{**cam.__dict__, "film": type(cam.film)(
            **{**cam.film.__dict__, "x_res": 24, "y_res": 18})})
        images.append(tcommon.render(scene, meta, make_li(meta)).numpy())
    got, ref = images
    close = (np.abs(got - ref) <= 1e-4 + 1e-3 * np.abs(ref)).all(axis=-1)
    assert close.mean() >= 0.99
    assert abs(got.mean() - ref.mean()) <= 1e-3 * abs(ref.mean())
    assert got.mean() > 0
