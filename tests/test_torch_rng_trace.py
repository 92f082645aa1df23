"""goblin_tpu_torch vs goblin_tpu: sample streams, BVH build, BVH8 layout
and the BVH8 traversal (its plain version, on the CPU).

Inputs are made with numpy from a seed and handed to both packages.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goblin_tpu.accel import bvh as jbvh
from goblin_tpu.core.rng import hash_uniform as j_hash
from goblin_tpu.geometry import mesh as jmesh
from goblin_tpu.ops.pallas_trace import collapse4, pack_scene, trace_packets4
from goblin_tpu_torch.accel import bvh as tbvh
from goblin_tpu_torch.core.rng import hash_uniform as t_hash
from goblin_tpu_torch.geometry import mesh as tmesh
from goblin_tpu_torch.ops import trace as tt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUNNY_OBJ = os.path.join(REPO, "examples", "models", "bunny.obj")


@pytest.mark.parametrize("seed,sample,bounce,dim", [
    (0, 0, 0, 0),
    (0, 3, 0x7FFF, 1),  # camera dims
    (7, 0x57A7, 2, 9),  # stratum rotation stream
    (123456789, 15, 4, 12),
    (0xFFFFFFFF, 1 << 20, 0xFFFF, 0x7FFFFFFF),
])
def test_hash_uniform_bit_equal(seed, sample, bounce, dim):
    pixel = np.arange(131072, dtype=np.int32) * 3 + 11
    ref = np.asarray(j_hash(seed, jnp.asarray(pixel), sample, bounce, dim))
    got = t_hash(seed, torch.as_tensor(pixel), sample, bounce, dim).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)


def test_hash_uniform_tensor_coordinates_bit_equal():
    rng = np.random.default_rng(0)
    n = 100_000
    pixel = rng.integers(0, 1 << 20, n, dtype=np.int32)
    sample = rng.integers(0, 64, n, dtype=np.int32)
    bounce = rng.integers(0, 20, n, dtype=np.int32)
    dim = rng.integers(0, 16, n, dtype=np.int32)
    ref = np.asarray(j_hash(5, jnp.asarray(pixel), jnp.asarray(sample),
                            jnp.asarray(bounce), jnp.asarray(dim)))
    got = t_hash(5, *(torch.as_tensor(a) for a in (pixel, sample, bounce, dim)))
    np.testing.assert_array_equal(got.numpy(), ref)


def _bunny_soup():
    m = tmesh.load_obj(BUNNY_OBJ)
    v = m.positions[m.faces]
    return v[:, 0], v[:, 1], v[:, 2]


def test_bunny_bvh_build_and_align_equal():
    v0, v1, v2 = _bunny_soup()
    ref = jbvh.align_leaves(jbvh.build_bvh(v0, v1, v2, max_leaf=32), align=8)
    got = tbvh.align_leaves(tbvh.build_bvh(v0, v1, v2, max_leaf=32), align=8)
    for name in ("bounds", "meta", "order"):
        np.testing.assert_array_equal(getattr(got, name), getattr(ref, name))


def test_python_bvh_builder_equal():
    rng = np.random.default_rng(1)
    p0 = rng.uniform(-1, 1, (300, 3)).astype(np.float32)
    p1 = p0 + rng.normal(size=(300, 3)).astype(np.float32) * 0.2
    p2 = p0 + rng.normal(size=(300, 3)).astype(np.float32) * 0.2
    ref = jbvh._build_bvh_python(p0, p1, p2, max_leaf=8)
    got = tbvh._build_bvh_python(p0, p1, p2, max_leaf=8)
    for name in ("bounds", "meta", "order"):
        np.testing.assert_array_equal(getattr(got, name), getattr(ref, name))


def test_obj_loaders_equal(tmp_path):
    """Native and Python parsers of both packages on a file with quads,
    negative indices and all four face formats."""
    obj = tmp_path / "m.obj"
    obj.write_text(
        "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nv 0 0 1\n"
        "vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\n"
        "vn 0 0 1\nvn 0 1 0\n"
        "f 1/1/1 2/2/1 3/3/1 4/4/1\n"
        "f -1//2 -2//2 -3//2\n"
        "f 1/1 2/2 5/4\n"
        "f 2 3 5\n"
    )
    ref = jmesh.load_obj(str(obj))
    for got in (tmesh.load_obj(str(obj)), tmesh._load_obj_python(str(obj))):
        for name in ("positions", "normals", "uvs", "faces"):
            np.testing.assert_array_equal(getattr(got, name), getattr(ref, name))


def test_bvh8_tables_match_collapse4():
    v0, v1, v2 = _bunny_soup()
    tree = tbvh.align_leaves(tbvh.build_bvh(v0, v1, v2, max_leaf=32), align=8)
    nb, nc, depth = tt.collapse8(tree.bounds, tree.meta)
    nb4, nm4 = collapse4(tree.bounds, tree.meta, width=8)
    assert nb.shape == (nb4.shape[0], 6, 8)
    assert tt.stack_bound(depth) <= tt.STACK
    for c in range(8):
        f0, cnt = nm4[:, 4 * c], nm4[:, 4 * c + 1]
        want = np.where(cnt > 0, -(((f0 // 8) << 7) | cnt) - 1,
                        np.where(cnt == 0, f0, tt.EMPTY))
        np.testing.assert_array_equal(nc[:, c], want)
        live = cnt >= 0
        np.testing.assert_array_equal(nb[live, :, c], nb4[live, 8 * c:8 * c + 6])


def test_collapse8_depth_and_single_leaf():
    bounds = np.float32([[0, 0, 0, 1, 1, 1]])
    meta = np.int32([[0, 5, 1]])
    nb, nc, depth = tt.collapse8(bounds, meta)
    assert depth == 1 and nc.tolist() == [[tt.leaf_entry(0, 5)] + [-1] * 7]
    with pytest.raises(ValueError):
        tt.leaf_entry(4, 3)  # unaligned leaf


def _random_scene(seed=3, n_tri=600, n_rays=1024):
    """The 600-triangle / 1024-ray case of test_pallas_trace.py."""
    rng = np.random.default_rng(seed)
    p0 = (rng.uniform(-1, 1, (n_tri, 3)) * 3).astype(np.float32)
    p1 = p0 + rng.normal(size=(n_tri, 3)).astype(np.float32) * 0.4
    p2 = p0 + rng.normal(size=(n_tri, 3)).astype(np.float32) * 0.4
    tree = jbvh.align_leaves(jbvh.build_bvh(p0, p1, p2, max_leaf=8), align=8)
    order = tree.order
    safe = np.where(order < 0, 0, order)
    soup = np.concatenate([p0[safe], p1[safe] - p0[safe], p2[safe] - p0[safe]],
                          axis=-1).astype(np.float32)
    soup[order < 0] = 0.0
    o = (rng.uniform(-1, 1, (n_rays, 3)) * 6).astype(np.float32)
    tgt = rng.normal(size=(n_rays, 3)).astype(np.float32) * 1.5
    d = tgt - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return tree, soup, o, d


@pytest.mark.parametrize("any_hit", [False, True])
def test_plain_trace_matches_trace_packets4(any_hit):
    tree, soup, o, d = _random_scene()
    mint = np.full(len(o), 1e-4, np.float32)
    maxt = np.full(len(o), 1e30, np.float32)
    maxt[::7] = 2.0  # short segments for the any-hit early exit
    mint[::13] = 3e38  # dead lanes
    nb4, nm4 = collapse4(tree.bounds, tree.meta, width=8)
    packed = pack_scene(tree.bounds, tree.meta, soup)
    ref = [np.asarray(v) for v in trace_packets4(
        jnp.asarray(nb4), jnp.asarray(nm4), jnp.asarray(packed["tris"]),
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(mint), jnp.asarray(maxt),
        max_leaf=8, rows=8, width=8, any_hit=any_hit, interpret=True,
    )]
    nb, nc, _ = tt.collapse8(tree.bounds, tree.meta)
    scene = {"bvh8_bounds": torch.as_tensor(nb),
             "bvh8_child": torch.as_tensor(nc),
             "tri_rows": torch.as_tensor(tt.tri_rows(soup))}
    got = [v.numpy() for v in tt.trace(
        scene, torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(mint),
        torch.as_tensor(maxt), any_hit=any_hit)]
    h = ref[0]
    assert h.sum() > 100
    np.testing.assert_array_equal(got[0], h)
    assert not got[0][::13].any()
    if not any_hit:
        np.testing.assert_allclose(got[1][h], ref[1][h], rtol=1e-4)
        assert (got[1][~h] == tt.BIG_T).all()
        assert (got[2][h] == ref[2][h]).mean() >= 0.99
        assert (got[2][~h] == -1).all()


def test_plain_trace_refuses_stack_overflow(monkeypatch):
    tree, soup, o, d = _random_scene()
    nb, nc, _ = tt.collapse8(tree.bounds, tree.meta)
    scene = {"bvh8_bounds": torch.as_tensor(nb),
             "bvh8_child": torch.as_tensor(nc),
             "tri_rows": torch.as_tensor(tt.tri_rows(soup))}
    monkeypatch.setattr(tt, "STACK", 2)
    with pytest.raises(RuntimeError, match="overflow"):
        tt.trace_plain(scene, torch.as_tensor(o), torch.as_tensor(d),
                       torch.zeros(len(o)), torch.full((len(o),), 1e30))


def test_trace_checks_inputs_and_device():
    tree, soup, o, d = _random_scene(n_rays=8)
    nb, nc, _ = tt.collapse8(tree.bounds, tree.meta)
    scene = {"bvh8_bounds": torch.as_tensor(nb),
             "bvh8_child": torch.as_tensor(nc),
             "tri_rows": torch.as_tensor(tt.tri_rows(soup))}
    o, d = torch.as_tensor(o), torch.as_tensor(d)
    mint, maxt = torch.zeros(8), torch.full((8,), 1e30)
    with pytest.raises(TypeError):
        tt.trace(scene, o.double(), d, mint, maxt)
    with pytest.raises(ValueError):
        tt.trace(scene, o, d, mint[:4], maxt)
    with pytest.raises(ValueError):
        tt.trace(scene, o.t().contiguous().t(), d, mint, maxt)
    with pytest.raises(ValueError):
        tt.trace(scene, o.to("meta"), d.to("meta"), mint.to("meta"),
                 maxt.to("meta"))
