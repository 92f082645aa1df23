"""The trace kernels' walk and the host functions they depend on, on the CPU.

The CUDA kernels cannot run here, so their walk is emulated one ray at a
time in numpy float32 with the kernel's data structures (one stack entry per
level: a node and its packed list of live children, nearest first; leaves
resolved by the reduction rule of the lanes that share a leaf) and held
against the plain PyTorch version, which the card holds the kernels
against. Equality is exact: the emulation does the same float32 operations
in the same order.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from goblin_tpu_torch.accel.bvh import align_leaves, build_bvh
from goblin_tpu_torch.ops import trace as tt
from goblin_tpu_torch.scene import bake as tbake
from goblin_tpu_torch.scene.loader import load_scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUNNY = os.path.join(REPO, "examples", "bunny.json")
F = np.float32
LEVELS = tt.WIDE_LEVELS


def _slab(lo, hi, o, inv, mint, t_best):
    """csrc/trace_common.cuh slab_test for a node's boxes at once: (enters,
    tn)."""
    t0 = (lo - o[:, None]) * inv[:, None]
    t1 = (hi - o[:, None]) * inv[:, None]
    near = np.minimum(t0, t1)
    far = np.maximum(t0, t1)
    t_in = np.maximum(np.maximum(near[0], near[1]), near[2])
    t_out = np.minimum(np.minimum(far[0], far[1]), far[2])
    tn = np.maximum(t_in, mint)
    return tn <= np.minimum(t_out, t_best), tn


def _visit_inner(bounds, child, e, o, inv, mint, t_best):
    """-> the packed list: four bits a live child, nearest first, slot + 1."""
    nb = bounds[e]  # (6, width)
    enters, tn = _slab(nb[0:3], nb[3:6], o, inv, mint, t_best)
    key = np.where((child[e] != tt.EMPTY) & enters, tn, F(np.inf))
    order = np.argsort(key, kind="stable")
    packed = 0
    for c, slot in enumerate(order):
        if key[slot] < np.inf:
            packed |= (int(slot) + 1) << (4 * c)
    return packed


def _leaf(tris, first, count, o, d, mint, t_best, any_hit):
    """The lanes' rule: a triangle to a lane, then of the accepted ones the
    least t and of equal t the highest index (any-hit: the lowest index).
    -> (k, t, b1, b2) or None."""
    tr = tris[first:first + count]
    v0, e1, e2 = tr[:, 0:3], tr[:, 3:6], tr[:, 6:9]

    def cross(a, b):
        return np.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                         a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                         a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)

    def dot(a, b):
        return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] \
            + a[..., 2] * b[..., 2]

    s1 = cross(np.broadcast_to(d, e2.shape), e2)
    div = dot(s1, e1)
    inv_div = F(1.0) / np.where(div == 0, F(1e-30), div)
    s = o[None, :] - v0
    b1 = dot(s, s1) * inv_div
    s2 = cross(s, e1)
    b2 = dot(np.broadcast_to(d, s2.shape), s2) * inv_div
    t = dot(e2, s2) * inv_div
    eps = F(1e-7)
    ok = ((div != 0) & (b1 + eps >= 0) & (b1 - eps <= 1) & (b2 + eps >= 0)
          & (b1 + b2 - eps <= 1) & (t >= mint) & (t <= t_best))
    if not ok.any():
        return None
    idx = np.nonzero(ok)[0]
    if any_hit:
        k = idx[0]
    else:
        k = idx[t[idx] == t[idx].min()][-1]
    return int(k), t[k], b1[k], b2[k]


def emulate_walk(scene, o, d, mint, maxt, any_hit, width=8):
    """One ray through trace_bvh8.cu's walk at `width` (8 or 4). -> (hit, t,
    tri, b1, b2, inner visits, leaf visits)."""
    bounds, child, tris = (scene[k].numpy() for k in tt.wide_tables(width))
    levels = tt.wide_levels(width)
    with np.errstate(divide="ignore"):
        inv = F(1.0) / np.where(d == 0, F(1e-30), d)
    t_best = min(maxt, F(tt.BIG_T))
    tri, b1, b2 = -1, F(0), F(0)
    stack = []  # one (node, packed list) per level below the top
    top_node, top_list = 0, 0
    n_inner = n_leaf = 0
    e, have = 0, bool(mint < t_best)

    def pop():
        nonlocal top_node, top_list
        if top_list == 0:
            if not stack:
                return None
            top_node, top_list = stack.pop()
        slot = (top_list & 15) - 1
        top_list >>= 4
        return int(child[top_node, slot])

    while have:
        if e >= 0:
            n_inner += 1
            packed = _visit_inner(bounds, child, e, o, inv, mint, t_best)
            if packed:
                if top_list:
                    assert len(stack) < levels - 1, "stack overflow"
                    stack.append((top_node, top_list))
                top_node, top_list = e, packed
        else:
            n_leaf += 1
            dec = -(e + 1)
            got = _leaf(tris, (dec >> 7) * 8, dec & 127, o, d, mint, t_best,
                        any_hit)
            if got is not None:
                k, t_best, b1, b2 = got
                tri = (dec >> 7) * 8 + k
                if any_hit:
                    break
        e = pop()
        have = e is not None
    hit = tri >= 0
    return hit, (t_best if hit else F(tt.BIG_T)), tri, b1, b2, n_inner, n_leaf


def _check_against_plain(scene, rays, any_hit, width=8):
    o, d, mint, maxt = rays
    ref, counts = tt.trace_plain(
        scene, *(torch.as_tensor(a) for a in rays), any_hit=any_hit,
        stats=True, width=width)
    n_hit = 0
    for i in range(o.shape[0]):
        hit, t, tri, b1, b2, n_inner, n_leaf = emulate_walk(
            scene, o[i], d[i], mint[i], maxt[i], any_hit, width)
        assert hit == bool(ref.hit[i]), i
        assert [n_inner, n_leaf, n_inner + n_leaf] == counts[i].tolist(), i
        if not any_hit or hit:
            assert (t, tri, b1, b2) == (ref.t[i].item(), ref.tri[i].item(),
                                        ref.b1[i].item(), ref.b2[i].item()), i
        n_hit += hit
    return n_hit


def _bunny_rays(width=8):
    scene, meta = load_scene(BUNNY, {"render_method": "path_tracing"},
                             device="cpu", trace_wide=width)
    cam = dataclasses.replace(meta.camera, film=dataclasses.replace(
        meta.camera.film, x_res=24, y_res=18))
    ys, xs = np.mgrid[0:18, 0:24]
    ray = cam.generate_ray(torch.as_tensor(xs.ravel() + 0.5, dtype=torch.float32),
                           torch.as_tensor(ys.ravel() + 0.5, dtype=torch.float32))
    rng = np.random.default_rng(11)
    lo, hi = (np.asarray(b, F) for b in meta.world_bounds)
    # the camera's 432 rays, then 120 rays between random points of the
    # world box, some cut short and some dead
    a = rng.uniform(lo, hi, (120, 3)).astype(F)
    b = rng.uniform(lo, hi, (120, 3)).astype(F)
    dd = b - a
    dd /= np.linalg.norm(dd, axis=-1, keepdims=True)
    o = np.concatenate([ray["o"].numpy(), a])
    d = np.concatenate([ray["d"].numpy(), dd.astype(F)])
    mint = np.concatenate([ray["mint"].numpy(), np.full(120, 1e-4, F)])
    maxt = np.concatenate([ray["maxt"].numpy(),
                           np.where(np.arange(120) % 3 == 0, 0.5, 1e30)
                           .astype(F)])
    mint[::17] = F(3e38)
    return scene, meta, [np.ascontiguousarray(x, F) for x in (o, d, mint, maxt)]


@pytest.fixture(scope="module")
def bunny():
    return _bunny_rays()


@pytest.mark.parametrize("any_hit", [False, True])
def test_level_stack_walk_matches_plain_on_bunny(bunny, any_hit):
    scene, meta, rays = bunny
    assert meta.wide_depth <= LEVELS
    assert _check_against_plain(scene, rays, any_hit) > 100


def _soup_scene(p0, p1, p2, max_leaf, width=8):
    tree = align_leaves(build_bvh(p0, p1, p2, max_leaf=max_leaf), align=8)
    order = tree.order
    safe = np.where(order < 0, 0, order)
    soup = np.concatenate([p0[safe], p1[safe] - p0[safe], p2[safe] - p0[safe]],
                          axis=-1).astype(F)
    soup[order < 0] = 0.0
    nb, nc, depth = tt.collapse_wide(tree.bounds, tree.meta, width)
    bb, bm = tt.bin_tables(tree.bounds, tree.meta)
    tables = {f"bvh{width}_bounds": nb, f"bvh{width}_child": nc,
              "bin_bounds": bb, "bin_meta": bm, "tri_rows": tt.tri_rows(soup)}
    return {k: torch.as_tensor(v) for k, v in tables.items()}, depth


@pytest.mark.parametrize("any_hit", [False, True])
def test_level_stack_walk_matches_plain_on_two_triangles(any_hit):
    # two coplanar triangles sharing an edge: rays through the shared edge
    # hit both at the same t, so the last-of-equal-t rule is exercised
    p0 = np.array([[0, 0, 0], [1, 1, 0]], F)
    p1 = np.array([[1, 0, 0], [0, 1, 0]], F)
    p2 = np.array([[0, 1, 0], [1, 0, 0]], F)
    scene, _ = _soup_scene(p0, p1, p2, max_leaf=8)
    rng = np.random.default_rng(5)
    n = 200
    target = np.concatenate([rng.uniform(-0.2, 1.2, (n - 40, 2)),
                             np.stack([np.linspace(0, 1, 40),
                                       1 - np.linspace(0, 1, 40)], -1)])
    o = np.concatenate([target, np.full((n, 1), 2.0)], -1).astype(F)
    d = np.tile(np.array([0, 0, -1], F), (n, 1))
    mint = np.full(n, 1e-4, F)
    maxt = np.where(np.arange(n) % 7 == 0, 1.0, 1e30).astype(F)
    assert _check_against_plain(scene, [o, d, mint, maxt], any_hit) > 50


@pytest.mark.parametrize("n_nodes,budget,want", [
    (464, 232448, 464),  # the whole table fits
    (3501, 16 + 3501 * 48, 3501),  # exactly at the budget
    (3501, 16 + 3501 * 48 - 1, 3500),  # one byte short: one node less
    (100000, 232448, (232448 - 16) // 48),  # a prefix of a large tree
    (10, 8, 0),  # no room beside the fixed part
])
def test_staged_nodes(n_nodes, budget, want):
    assert tt.staged_nodes(n_nodes, 48, 16, budget) == want


def test_staged_nodes_counts_the_fixed_bytes():
    # per-thread stacks beside the nodes come off the budget first
    assert tt.staged_nodes(1000, 240, 16 + 512 * 64, 115712) == \
        (115712 - 16 - 512 * 64) // 240


def test_wide_depth_limit():
    tt.check_wide_depth(tt.WIDE_LEVELS)
    with pytest.raises(ValueError, match="stack levels"):
        tt.check_wide_depth(tt.WIDE_LEVELS + 1)
    # trace_plain's stack of child entries holds what that depth can push
    assert tt.stack_bound(tt.WIDE_LEVELS) == tt.STACK


def test_load_scene_defaults_to_the_card_and_does_not_fall_back():
    if torch.cuda.is_available():
        scene, _ = load_scene(BUNNY)
        assert scene["tri_rows"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            load_scene(BUNNY)


def test_build_key_covers_the_shared_header(monkeypatch, tmp_path):
    key = tt.build_key("trace_bvh8")
    assert key == tt.build_key("trace_bvh8")
    assert key != tt.build_key("trace_bvh2")
    with open(tt.KERNEL_HEADERS[0], "rb") as f:
        text = f.read()
    edited = tmp_path / "trace_common.cuh"
    edited.write_bytes(text + b"\n// edited\n")
    monkeypatch.setattr(tt, "KERNEL_HEADERS", (str(edited),))
    assert tt.build_key("trace_bvh8") != key


def test_both_sources_include_the_shared_header():
    for path in tt.KERNEL_SOURCES.values():
        with open(path) as f:
            assert '#include "trace_common.cuh"' in f.read()


@pytest.mark.parametrize("any_hit", [False, True])
def test_bin_plain_census(any_hit):
    rng = np.random.default_rng(2)
    n_tri = 300
    p0 = (rng.uniform(-1, 1, (n_tri, 3)) * 3).astype(F)
    p1 = p0 + rng.normal(size=(n_tri, 3)).astype(F) * 0.4
    p2 = p0 + rng.normal(size=(n_tri, 3)).astype(F) * 0.4
    scene, _ = _soup_scene(p0, p1, p2, max_leaf=8)
    n = 400
    o = (rng.uniform(-1, 1, (n, 3)) * 6).astype(F)
    d = rng.normal(size=(n, 3)).astype(F) * 1.5 - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = [torch.as_tensor(a) for a in
            (o, d, np.full(n, 1e-4, F), np.full(n, 1e30, F))]
    ref = tt.trace_bin_plain(scene, *rays, any_hit=any_hit)
    got, counts = tt.trace_bin_plain(scene, *rays, any_hit=any_hit,
                                     census=True)
    assert all(torch.equal(a, b) for a, b in zip(ref, got))
    inner, leaf, tris = counts[:, 0], counts[:, 1], counts[:, 2]
    assert int(inner.min()) >= 1  # every ray visits the root
    assert bool((tris >= leaf).all()) and bool((tris <= 8 * leaf).all())
    assert bool((leaf[ref.hit] >= 1).all())


@pytest.mark.parametrize("any_hit", [False, True])
def test_plain_census_counts_live_slots_and_leaf_triangles(bunny, any_hit):
    """trace_plain's census: the walk's visits (equal to the stats counts),
    a box test for every non-empty slot of a visited node and a test for
    every triangle of a visited leaf, held to what the tables allow."""
    scene, _, rays = bunny
    rays = [torch.as_tensor(a) for a in rays]
    ref, counts = tt.trace_plain(scene, *rays, any_hit=any_hit, stats=True)
    got, work = tt.trace_plain(scene, *rays, any_hit=any_hit, census=True)
    assert all(torch.equal(a, b) for a, b in zip(ref, got))
    assert work.shape == (rays[0].shape[0], 4) and work.dtype == torch.int32
    assert torch.equal(work[:, :2], counts[:, :2])
    inner, leaf, boxes, tris = work.unbind(dim=1)
    child = scene["bvh8_child"]
    live = (child != tt.EMPTY).sum(dim=1)
    # the root is every live ray's first visit, so its slots are in the count
    assert bool((boxes[inner > 0] >= live[0]).all())
    assert bool((boxes >= int(live.min()) * inner).all())
    assert bool((boxes <= int(live.max()) * inner).all())
    assert int(live.min()) < tt.WIDTH  # bunny's tree leaves slots empty
    assert int(boxes.sum()) < tt.WIDTH * int(inner.sum())
    leaf_counts = (-(child[child < tt.EMPTY].long() + 1)) & 127
    assert bool((tris >= int(leaf_counts.min()) * leaf).all())
    assert bool((tris <= int(leaf_counts.max()) * leaf).all())
    with pytest.raises(ValueError, match="not both"):
        tt.trace_plain(scene, *rays, stats=True, census=True)
