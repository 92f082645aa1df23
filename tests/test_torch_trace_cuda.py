"""The CUDA trace kernels (the wide kernel at widths 8 and 4, their stats
instances, and the binary BVH) against their plain PyTorch versions, on the
card; ambient occlusion's 1,638,400-ray any-hit launch against the plain
version.

Needs an NVIDIA GPU and nvcc; skipped elsewhere. This file imports
neither JAX nor goblin_tpu, so it runs on a machine without them:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_trace_cuda.py
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from goblin_tpu_torch.accel.bvh import align_leaves, build_bvh
from goblin_tpu_torch.integrators import common
from goblin_tpu_torch.ops import trace as tt
from goblin_tpu_torch.render import make_li
from goblin_tpu_torch.scene.loader import load_scene

pytestmark = pytest.mark.cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _scene(device, seed=3, n_tri=600, n_rays=1 << 14, max_leaf=8):
    """Random triangles and rays, with the BVH8, BVH4 and binary tables."""
    rng = np.random.default_rng(seed)
    p0 = (rng.uniform(-1, 1, (n_tri, 3)) * 3).astype(np.float32)
    p1 = p0 + rng.normal(size=(n_tri, 3)).astype(np.float32) * 0.4
    p2 = p0 + rng.normal(size=(n_tri, 3)).astype(np.float32) * 0.4
    tree = align_leaves(build_bvh(p0, p1, p2, max_leaf=max_leaf), align=8)
    order = tree.order
    safe = np.where(order < 0, 0, order)
    soup = np.concatenate([p0[safe], p1[safe] - p0[safe], p2[safe] - p0[safe]],
                          axis=-1).astype(np.float32)
    soup[order < 0] = 0.0
    nb, nc, _ = tt.collapse8(tree.bounds, tree.meta)
    nb4, nc4, depth4 = tt.collapse_wide(tree.bounds, tree.meta, 4)
    tt.check_wide_depth(depth4, 4)
    bb, bm = tt.bin_tables(tree.bounds, tree.meta)
    tables = {"bvh8_bounds": nb, "bvh8_child": nc, "bvh4_bounds": nb4,
              "bvh4_child": nc4, "bin_bounds": bb, "bin_meta": bm,
              "tri_rows": tt.tri_rows(soup)}
    scene = {k: torch.as_tensor(v, device=device) for k, v in tables.items()}
    o = (rng.uniform(-1, 1, (n_rays, 3)) * 6).astype(np.float32)
    d = rng.normal(size=(n_rays, 3)).astype(np.float32) * 1.5 - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    mint = np.full(n_rays, 1e-4, np.float32)
    maxt = np.where(np.arange(n_rays) % 5 == 0, 2.0, 1e30).astype(np.float32)
    mint[::11] = 3e38  # dead lanes
    rays = [torch.as_tensor(a, device=device) for a in (o, d, mint, maxt)]
    return scene, rays


@pytest.mark.parametrize("any_hit", [False, True])
def test_kernel_matches_plain(cuda, any_hit):
    scene, rays = _scene(cuda)
    tt.reset_launches()
    got = tt.trace(scene, *rays, any_hit=any_hit)
    torch.cuda.synchronize()
    assert tt.launches == {"trace_bvh8": 1, "trace_bvh8_stats": 0,
                           "trace_bvh4": 0, "trace_bvh4_stats": 0,
                           "trace_bvh2": 0}
    ref = tt.trace_plain(scene, *rays, any_hit=any_hit)
    h = ref.hit.cpu().numpy()
    assert h.sum() > 1000
    np.testing.assert_array_equal(got.hit.cpu().numpy(), h)
    if not any_hit:
        np.testing.assert_allclose(got.t.cpu().numpy(), ref.t.cpu().numpy(),
                                   rtol=1e-6)
        assert (got.tri == ref.tri).float().mean().item() >= 0.99


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("max_leaf", [8, 32])
def test_bin_kernel_matches_plain(cuda, any_hit, max_leaf):
    scene, rays = _scene(cuda, max_leaf=max_leaf)
    tt.reset_launches()
    got = tt.trace_bin(scene, *rays, any_hit=any_hit)
    torch.cuda.synchronize()
    assert tt.launches["trace_bvh2"] == 1 and tt.launches["trace_bvh8"] == 0
    ref = tt.trace_bin_plain(scene, *rays, any_hit=any_hit)
    h = ref.hit.cpu().numpy()
    assert h.sum() > 1000
    np.testing.assert_array_equal(got.hit.cpu().numpy(), h)
    if not any_hit:
        np.testing.assert_allclose(got.t.cpu().numpy(), ref.t.cpu().numpy(),
                                   rtol=1e-6)
        assert (got.tri == ref.tri).float().mean().item() >= 0.99
        # and the BVH8 kernel on the same rays
        k1 = tt.trace(scene, *rays)
        assert torch.equal(k1.hit, got.hit)
        assert (k1.tri == got.tri).float().mean().item() >= 0.99


@pytest.mark.parametrize("any_hit", [False, True])
def test_stats_kernel_matches_plain(cuda, any_hit):
    scene, rays = _scene(cuda)
    tt.reset_launches()
    got, counts = tt.trace(scene, *rays, any_hit=any_hit, stats=True)
    torch.cuda.synchronize()
    assert tt.launches["trace_bvh8_stats"] == 1
    assert tt.launches["trace_bvh8"] == 0
    ref, ref_counts = tt.trace_plain(scene, *rays, any_hit=any_hit,
                                     stats=True)
    assert torch.equal(counts, ref_counts)
    assert torch.equal(got.hit, ref.hit)
    assert int(counts[:, 1].sum()) > 0


def _assert_bit_equal(got, ref, any_hit):
    assert torch.equal(got.hit, ref.hit)
    if not any_hit:
        for name in ("t", "tri", "b1", "b2"):
            assert torch.equal(getattr(got, name), getattr(ref, name)), name


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("max_leaf", [8, 32])
def test_kernels_bit_equal_to_plain(cuda, any_hit, max_leaf):
    """Both kernels against their plain versions, bit for bit, on a ray
    count that is no multiple of a warp (the last batch is ragged), and the
    stats instance's counts on every ray."""
    scene, rays = _scene(cuda, n_rays=(1 << 14) + 5, max_leaf=max_leaf)
    k1 = tt.trace(scene, *rays, any_hit=any_hit)
    k2 = tt.trace_bin(scene, *rays, any_hit=any_hit)
    ks, counts = tt.trace(scene, *rays, any_hit=any_hit, stats=True)
    torch.cuda.synchronize()
    p1, ref_counts = tt.trace_plain(scene, *rays, any_hit=any_hit, stats=True)
    p2 = tt.trace_bin_plain(scene, *rays, any_hit=any_hit)
    assert int(p1.hit.sum()) > 1000
    _assert_bit_equal(k1, p1, any_hit)
    _assert_bit_equal(ks, p1, any_hit)
    _assert_bit_equal(k2, p2, any_hit)
    assert torch.equal(counts, ref_counts)
    assert torch.equal(counts[:, 2], counts[:, 0] + counts[:, 1])


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("max_leaf", [8, 32])
def test_w4_kernel_bit_equal_to_plain(cuda, any_hit, max_leaf):
    """The width-4 instance (4 lanes a ray, 4 triangles a round) against
    trace_plain at width 4, bit for bit, on a ragged ray count; its stats
    instance's counts on every ray; and the same hits as width 8."""
    scene, rays = _scene(cuda, n_rays=(1 << 14) + 5, max_leaf=max_leaf)
    tt.reset_launches()
    k4 = tt.trace(scene, *rays, any_hit=any_hit, width=4)
    ks, counts = tt.trace(scene, *rays, any_hit=any_hit, stats=True, width=4)
    torch.cuda.synchronize()
    assert (tt.launches["trace_bvh4"], tt.launches["trace_bvh4_stats"],
            tt.launches["trace_bvh8"]) == (1, 1, 0)
    p4, ref_counts = tt.trace_plain(scene, *rays, any_hit=any_hit, stats=True,
                                    width=4)
    assert int(p4.hit.sum()) > 1000
    _assert_bit_equal(k4, p4, any_hit)
    _assert_bit_equal(ks, p4, any_hit)
    assert torch.equal(counts, ref_counts)
    assert torch.equal(counts[:, 2], counts[:, 0] + counts[:, 1])
    k8 = tt.trace(scene, *rays, any_hit=any_hit)
    assert torch.equal(k8.hit, k4.hit)
    if not any_hit:
        assert (k8.tri == k4.tri).float().mean().item() >= 0.99


def test_w4_any_hit_exits_early(cuda):
    """An any-hit walk ends at its first accepted triangle: on the rays
    that hit it makes no more visits than the closest-hit walk, and fewer
    in total."""
    scene, rays = _scene(cuda)
    (_, closest), (res, first) = (
        tt.trace(scene, *rays, any_hit=a, stats=True, width=4)
        for a in (False, True))
    torch.cuda.synchronize()
    h = res.hit
    assert int(h.sum()) > 1000
    assert bool((first[h, 2] <= closest[h, 2]).all())
    assert int(first[h, 2].sum()) < int(closest[h, 2].sum())
    assert torch.equal(first[~h], closest[~h])


def test_w4_persistent_blocks_and_deep_tree(cuda):
    """Blocks hold 32 rays at width 4 (16 at width 8), and a tree deeper
    than the width-8 kernel's 9 levels walks at width 4."""
    assert tt.launch_blocks("trace_bvh4", 1, 0) == 1
    assert tt.launch_blocks("trace_bvh4", 64, 0) == 2
    assert tt.launch_blocks("trace_bvh8", 64, 0) == 4
    assert 0 < tt.launch_blocks("trace_bvh4", 300_000, 0) \
        == tt.launch_blocks("trace_bvh4", 3_000_000, 0)
    scene, rays = _scene(cuda, n_tri=60_000, n_rays=100_000, max_leaf=8)
    got = tt.trace(scene, *rays, width=4)
    torch.cuda.synchronize()
    _assert_bit_equal(got, tt.trace_plain(scene, *rays, width=4), False)


def test_persistent_blocks_draw_all_rays(cuda):
    """More rays than the resident blocks hold at once (ten times the rays
    get no more blocks): every warp draws several batches from the counter,
    and each ray's result is the one a small launch gives it."""
    scene, rays = _scene(cuda, n_rays=300_000)
    n_staged = tt.bin_staged_nodes(scene["bin_meta"].shape[0], cuda)
    for fn, name in ((tt.trace, "trace_bvh8"), (tt.trace_bin, "trace_bvh2")):
        full = fn(scene, *rays)
        staged = n_staged if name == "trace_bvh2" else 0
        assert 0 < tt.launch_blocks(name, 300_000, staged) \
            == tt.launch_blocks(name, 3_000_000, staged)
        assert tt.launch_blocks(name, 1, staged) == 1
        parts = [fn(scene, *(r[c:c + 50_000] for r in rays))
                 for c in range(0, 300_000, 50_000)]
        torch.cuda.synchronize()
        for a, b in zip(full, (torch.cat(v) for v in zip(*parts))):
            assert torch.equal(a, b)


@pytest.mark.parametrize("any_hit", [False, True])
def test_bin_kernel_stages_a_prefix_of_a_large_tree(cuda, any_hit):
    """A tree too large for shared memory: the kernel stages its first
    nodes and reads the others from device memory."""
    scene, rays = _scene(cuda, n_tri=60_000, max_leaf=8)
    n_nodes = scene["bin_meta"].shape[0]
    assert 0 < tt.bin_staged_nodes(n_nodes, cuda) < n_nodes
    got = tt.trace_bin(scene, *rays, any_hit=any_hit)
    torch.cuda.synchronize()
    ref = tt.trace_bin_plain(scene, *rays, any_hit=any_hit)
    assert int(ref.hit.sum()) > 1000
    _assert_bit_equal(got, ref, any_hit)


def test_kernel_checks_inputs(cuda):
    scene, (o, d, mint, maxt) = _scene(cuda, n_rays=64)
    with pytest.raises(ValueError):
        tt.trace(scene, o.cpu(), d, mint, maxt)
    with pytest.raises(TypeError):
        tt.trace(scene, o, d, mint.double(), maxt)
    with pytest.raises(ValueError):
        tt.trace(scene, o[::2], d[::2], mint[::2], maxt[::2][:16])


@pytest.mark.parametrize("name,wide", [("bunny", 8), ("bunny_studio", 4)])
def test_bunny_render_on_card_matches_cpu(cuda, name, wide):
    """48 x 36, 1 spp, depth 5: the kernel path on the card against the
    plain path on the CPU, with goblin_tpu's slice bar; bunny.json at width
    8 and the studio scene at width 4."""
    ovr = {"render_method": "path_tracing", "max_ray_depth": 5,
           "sample_per_pixel": 1}
    images = []
    for device in ("cpu", cuda):
        scene, meta = load_scene(os.path.join(REPO, "examples", f"{name}.json"),
                                 ovr, device=device, trace_wide=wide)
        meta.camera = dataclasses.replace(meta.camera, film=dataclasses.replace(
            meta.camera.film, x_res=48, y_res=36))
        images.append(common.render(scene, meta, make_li(meta)).cpu().numpy())
    cpu, gpu = images
    assert np.isfinite(gpu).all() and gpu.mean() > 0
    close = np.abs(gpu - cpu) <= 1e-4 + 1e-3 * np.abs(cpu)
    assert close.all(axis=-1).mean() >= 0.99
    assert abs(gpu.mean() - cpu.mean()) <= 1e-3 * cpu.mean()


@pytest.mark.parametrize("width", [8, 4])
def test_ao_any_hit_launch_matches_plain(cuda, width):
    """Ambient occlusion's launch, the largest any path makes: 65,536
    pixels x 25 directions = 1,638,400 any-hit rays from the gallery
    scene's first chunk, as integrators/ao.py casts them. One launch is
    bit-equal to the plain version on a sampled 1 in 16 of the rays and
    equal to the same rays in launches of 65,536."""
    from goblin_tpu_torch.integrators.ao import make_li as make_ao
    from goblin_tpu_torch.scene import intersect as scn

    scene, meta = load_scene(os.path.join(REPO, "examples",
                                          "bunny_gallery.json"),
                             {"render_method": "ao"}, device=cuda,
                             trace_wide=width)
    caught = []
    trace_rays = scn.trace_rays

    def catching(scene, meta, o, d, mint, maxt, any_hit=False):
        if any_hit:
            caught.append([r.contiguous() for r in (o, d, mint, maxt)])
        return trace_rays(scene, meta, o, d, mint, maxt, any_hit=any_hit)

    pix = torch.arange(1 << 16, dtype=torch.int32, device=cuda)
    x, y = common.pixel_samples(0, pix, meta.camera.film.x_res, 0, 1)
    scn.trace_rays = catching
    try:
        make_ao(25)(scene, meta, meta.camera.generate_ray(x, y), pix, 0, 0)
    finally:
        scn.trace_rays = trace_rays
    (rays,) = caught
    n = rays[0].shape[0]
    assert n == 25 << 16
    tt.reset_launches()
    whole = tt.trace(scene, *rays, any_hit=True, width=width)
    assert tt.launches[f"trace_bvh{width}"] == 1
    parts = [tt.trace(scene, *(r[c:c + (1 << 16)] for r in rays),
                      any_hit=True, width=width) for c in range(0, n, 1 << 16)]
    assert tt.launches[f"trace_bvh{width}"] == 26
    assert torch.equal(whole.hit, torch.cat([p.hit for p in parts]))
    some = [r[5::16].contiguous() for r in rays]
    plain = tt.trace_plain(scene, *some, any_hit=True, width=width)
    assert torch.equal(whole.hit[5::16], plain.hit)
    assert 0.02 < whole.hit.float().mean().item() < 0.9
