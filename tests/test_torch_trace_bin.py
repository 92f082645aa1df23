"""goblin_tpu_torch's width-1 trace (the binary-BVH kernel's plain version,
on the CPU) and the BVH8 trace's per-ray visit counts, against goblin_tpu
and against walkers written here.

Inputs are made with numpy from a seed and handed to both packages.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goblin_tpu.accel import bvh as jbvh
from goblin_tpu.ops.pallas_trace import pack_scene, trace_packets
from goblin_tpu.scene import loader as jloader
from goblin_tpu_torch.ops import trace as tt
from goblin_tpu_torch.scene import bake as tbake
from goblin_tpu_torch.scene import loader as tloader

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUNNY = os.path.join(REPO, "examples", "bunny.json")


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _random_scene(seed, n_tri=600, n_rays=1024, max_leaf=32):
    """test_pallas_trace.py's 600-triangle / 1024-ray case, on the
    production tree (8-aligned leaves of at most max_leaf triangles)."""
    rng = np.random.default_rng(seed)
    p0 = (rng.uniform(-1, 1, (n_tri, 3)) * 3).astype(np.float32)
    p1 = p0 + rng.normal(size=(n_tri, 3)).astype(np.float32) * 0.4
    p2 = p0 + rng.normal(size=(n_tri, 3)).astype(np.float32) * 0.4
    tree = jbvh.align_leaves(jbvh.build_bvh(p0, p1, p2, max_leaf=max_leaf),
                             align=8)
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


def _bin_scene(tree, soup):
    nb, nm = tt.bin_tables(tree.bounds, tree.meta)
    return {"bin_bounds": _t(nb), "bin_meta": _t(nm),
            "tri_rows": _t(tt.tri_rows(soup))}


def _bvh8_scene(tree, soup):
    nb, nc, _ = tt.collapse8(tree.bounds, tree.meta)
    return {"bvh8_bounds": _t(nb), "bvh8_child": _t(nc),
            "tri_rows": _t(tt.tri_rows(soup))}


@pytest.mark.parametrize("any_hit", [False, True])
def test_bin_plain_matches_trace_packets(any_hit):
    """test_pallas_trace.py:45-52's bar against the TPU kernel in
    interpret mode: hit masks equal, t within 1e-4 rel, tri equal on
    >= 99% of hits."""
    tree, soup, o, d = _random_scene(seed=0 if not any_hit else 5)
    mint = np.full(len(o), 1e-4, np.float32)
    maxt = np.full(len(o), 4.0 if any_hit else 1e30, np.float32)
    maxt[::7] = 2.0  # short segments for the any-hit early exit
    mint[::13] = 3e38  # dead lanes
    packed = pack_scene(tree.bounds, tree.meta, soup)
    ref = [np.asarray(v) for v in trace_packets(
        jnp.asarray(packed["nodes"]), jnp.asarray(packed["meta"]),
        jnp.asarray(packed["tris"]), jnp.asarray(o), jnp.asarray(d),
        jnp.asarray(mint), jnp.asarray(maxt), max_leaf=32, any_hit=any_hit,
        aligned=True, interpret=True,
    )]
    got = [v.numpy() for v in tt.trace_bin(
        _bin_scene(tree, soup), _t(o), _t(d), _t(mint), _t(maxt),
        any_hit=any_hit)]
    h = ref[0]
    assert h.sum() > 100
    np.testing.assert_array_equal(got[0], h)
    assert not got[0][::13].any()
    if not any_hit:
        np.testing.assert_allclose(got[1][h], ref[1][h], rtol=1e-4)
        assert (got[1][~h] == tt.BIG_T).all()
        assert (got[2][h] == ref[2][h]).mean() >= 0.99
        assert (got[2][~h] == -1).all()


def test_bin_plain_matches_bvh8_plain_on_bunny():
    """Width 1 and width 8 of the same bunny bake: the two trees hold the
    same triangles in the same order, so hits agree; on equal-t hits the
    two walks may pick different triangles (the >= 99% bar)."""
    s1, m1 = tloader.load_scene(BUNNY, device="cpu", trace_wide=1)
    s8, m8 = tloader.load_scene(BUNNY, device="cpu")
    assert (m1.trace_wide, m8.trace_wide) == (1, 8)
    assert torch.equal(s1["tri_rows"], s8["tri_rows"])
    rng = np.random.default_rng(1)
    n = 4096
    o = rng.uniform([-0.6, -0.9, -0.6], [1.2, 0.2, 0.6], (n, 3))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = [_t(o.astype(np.float32)), _t(d.astype(np.float32)),
            torch.full((n,), 1e-3), torch.full((n,), 3e37)]
    rays[3][::5] = 0.5
    for any_hit in (False, True):
        a = tt.trace(s8, *rays, any_hit=any_hit)
        b = tt.trace_bin(s1, *rays, any_hit=any_hit)
        assert int(a.hit.sum()) > 1000
        assert torch.equal(a.hit, b.hit)
        if not any_hit:
            assert torch.equal(a.t, b.t)
            assert (a.tri == b.tri).float().mean() >= 0.99


def test_binary_tables_equal_pack_scene(monkeypatch):
    """The width-1 bake of bunny equals goblin_tpu's pack_scene lanes: node
    bounds, the right child and miss link of every inner node, first and
    count of every leaf, and the triangle rows."""
    monkeypatch.setenv("GOBLIN_TRACE", "pallas")
    js, jm = jloader.load_scene(BUNNY)
    ts, tm = tloader.load_scene(BUNNY, device="cpu", trace_wide=1)
    n = tm.n_nodes
    assert n == jm.n_nodes
    nodes = np.asarray(js["pk_nodes"]).reshape(-1, 8)[:n]
    meta = np.asarray(js["pk_meta"]).reshape(-1, 4)[:n]
    got_b, got_m = ts["bin_bounds"].numpy(), ts["bin_meta"].numpy()
    np.testing.assert_array_equal(got_b, nodes)
    inner = got_m[:, 1] == 0
    assert inner.sum() == n // 2 and (got_m[~inner, 1] > 0).all()
    np.testing.assert_array_equal(got_m[inner][:, [0, 2]],
                                  meta[inner][:, [0, 2]])  # right child, miss
    np.testing.assert_array_equal(got_m[~inner][:, :2],
                                  meta[~inner][:, :2])  # first, count
    np.testing.assert_array_equal(got_m, meta)
    tris = np.asarray(js["pk_tris"]).reshape(-1, 16)[:tm.n_tris, :9]
    np.testing.assert_array_equal(ts["tri_rows"].numpy()[:, :9], tris)
    assert tm.bin_depth == tt.bin_depth(np.asarray(js["node_meta"]))
    assert tt.bin_stack_bound(tm.bin_depth) <= tt.BIN_STACK


def test_bake_refuses_widths_and_deep_binary_trees(monkeypatch):
    with pytest.raises(ValueError, match="trace_wide"):
        tloader.load_scene(BUNNY, device="cpu", trace_wide=2)
    monkeypatch.setattr(tbake, "BIN_STACK", 8)  # bunny needs 14 + 1
    with pytest.raises(ValueError, match="stack"):
        tloader.load_scene(BUNNY, device="cpu", trace_wide=1)


def test_bin_depth_and_single_leaf():
    meta = np.int32([[0, 5, 1]])
    assert tt.bin_depth(meta) == 0
    nb, nm = tt.bin_tables(np.float32([[0, 0, 0, 1, 1, 1]]), meta)
    assert nm.tolist() == [[0, 5, 1, 0]] and nb.shape == (1, 8)
    # root -> (leaf, inner -> (leaf, leaf))
    meta = np.int32([[0, 0, 5], [0, 8, 2], [0, 0, 5], [8, 8, 4], [16, 8, 5]])
    assert tt.bin_depth(meta) == 2
    _, nm = tt.bin_tables(np.zeros((5, 6), np.float32), meta)
    assert nm[:, 0].tolist() == [2, 0, 4, 8, 16]  # inner: right child


def test_bin_plain_refuses_stack_overflow(monkeypatch):
    tree, soup, o, d = _random_scene(seed=3, max_leaf=8)
    monkeypatch.setattr(tt, "BIN_STACK", 2)
    with pytest.raises(RuntimeError, match="overflow"):
        tt.trace_bin_plain(_bin_scene(tree, soup), _t(o), _t(d),
                           torch.zeros(len(o)), torch.full((len(o),), 1e30))


def test_trace_bin_checks_inputs():
    tree, soup, o, d = _random_scene(seed=3, n_rays=8)
    scene = _bin_scene(tree, soup)
    o, d = _t(o), _t(d)
    mint, maxt = torch.zeros(8), torch.full((8,), 1e30)
    with pytest.raises(TypeError):
        tt.trace_bin(scene, o.double(), d, mint, maxt)
    with pytest.raises(ValueError):
        tt.trace_bin(scene, o, d, mint[:4], maxt)
    with pytest.raises(ValueError):
        tt.trace_bin(dict(scene, bin_meta=scene["bin_meta"][:, :3].contiguous()),
                     o, d, mint, maxt)
    with pytest.raises(ValueError):
        tt.trace_bin(scene, o.to("meta"), d.to("meta"), mint.to("meta"),
                     maxt.to("meta"))


def _walk_counts(nb, nc, tris, o, d, mint, maxt, any_hit):
    """A scalar per-ray walk of the BVH8 tables in numpy float32 with the
    kernel's rules -> (inner visits, leaf visits, loop iterations)."""
    f32 = np.float32
    inv = f32(1) / np.where(d == 0, f32(1e-30), d)
    t_best = min(maxt, f32(3e38))
    stack = [0] if mint < t_best else []
    inner = leaf = iters = 0
    while stack:
        e = stack.pop()
        iters += 1
        if e >= 0:
            inner += 1
            t0 = (nb[e, 0:3] - o[:, None]) * inv[:, None]
            t1 = (nb[e, 3:6] - o[:, None]) * inv[:, None]
            tn = np.maximum(np.minimum(t0, t1).max(axis=0), mint)
            tf = np.minimum(np.maximum(t0, t1).min(axis=0), t_best)
            kids = [(tn[c], nc[e, c]) for c in range(8)
                    if nc[e, c] != -1 and tn[c] <= tf[c]]
            kids.sort(key=lambda k: k[0])  # stable: ties keep slot order
            stack.extend(e_c for _, e_c in reversed(kids))
            continue
        leaf += 1
        dec = -(e + 1)
        first, count = (dec >> 7) * 8, dec & 127
        for k in range(first, first + count):
            v0, e1, e2 = tris[k, 0:3], tris[k, 3:6], tris[k, 6:9]
            s1 = np.float32([d[1] * e2[2] - d[2] * e2[1],
                             d[2] * e2[0] - d[0] * e2[2],
                             d[0] * e2[1] - d[1] * e2[0]])
            div = s1[0] * e1[0] + s1[1] * e1[1] + s1[2] * e1[2]
            idiv = f32(1) / (div if div != 0 else f32(1e-30))
            s = o - v0
            b1 = (s[0] * s1[0] + s[1] * s1[1] + s[2] * s1[2]) * idiv
            s2 = np.float32([s[1] * e1[2] - s[2] * e1[1],
                             s[2] * e1[0] - s[0] * e1[2],
                             s[0] * e1[1] - s[1] * e1[0]])
            b2 = (d[0] * s2[0] + d[1] * s2[1] + d[2] * s2[2]) * idiv
            t = (e2[0] * s2[0] + e2[1] * s2[1] + e2[2] * s2[2]) * idiv
            eps = f32(1e-7)
            if (div != 0 and b1 + eps >= 0 and b1 - eps <= 1 and b2 + eps >= 0
                    and b1 + b2 - eps <= 1 and mint <= t <= t_best):
                t_best = t
                if any_hit:
                    return inner, leaf, iters
    return inner, leaf, iters


@pytest.mark.parametrize("any_hit", [False, True])
def test_stats_counts_match_a_scalar_walker(any_hit):
    tree, soup, o, d = _random_scene(seed=7, n_tri=300, n_rays=96, max_leaf=8)
    mint = np.full(len(o), 1e-4, np.float32)
    maxt = np.full(len(o), 1e30, np.float32)
    maxt[::5] = 3.0
    mint[::11] = 3e38
    scene = _bvh8_scene(tree, soup)
    res, counts = tt.trace(scene, _t(o), _t(d), _t(mint), _t(maxt),
                           any_hit=any_hit, stats=True)
    plain = tt.trace(scene, _t(o), _t(d), _t(mint), _t(maxt), any_hit=any_hit)
    assert torch.equal(res.hit, plain.hit) and torch.equal(res.t, plain.t)
    assert counts.dtype == torch.int32 and counts.shape == (len(o), 3)
    nb, nc = scene["bvh8_bounds"].numpy(), scene["bvh8_child"].numpy()
    tris = scene["tri_rows"].numpy()
    want = np.array([_walk_counts(nb, nc, tris, o[i], d[i], mint[i], maxt[i],
                                  any_hit) for i in range(len(o))])
    np.testing.assert_array_equal(counts.numpy(), want)
    assert (want[::11] == 0).all() and want[:, 1].sum() > 0
