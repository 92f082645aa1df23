"""The CUDA BVH8 kernel against its plain PyTorch version, on the card.

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


def _scene(device, seed=3, n_tri=600, n_rays=1 << 14):
    rng = np.random.default_rng(seed)
    p0 = (rng.uniform(-1, 1, (n_tri, 3)) * 3).astype(np.float32)
    p1 = p0 + rng.normal(size=(n_tri, 3)).astype(np.float32) * 0.4
    p2 = p0 + rng.normal(size=(n_tri, 3)).astype(np.float32) * 0.4
    tree = align_leaves(build_bvh(p0, p1, p2, max_leaf=8), align=8)
    order = tree.order
    safe = np.where(order < 0, 0, order)
    soup = np.concatenate([p0[safe], p1[safe] - p0[safe], p2[safe] - p0[safe]],
                          axis=-1).astype(np.float32)
    soup[order < 0] = 0.0
    nb, nc, _ = tt.collapse8(tree.bounds, tree.meta)
    scene = {"bvh8_bounds": torch.as_tensor(nb, device=device),
             "bvh8_child": torch.as_tensor(nc, device=device),
             "tri_rows": torch.as_tensor(tt.tri_rows(soup), device=device)}
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
    assert tt.launches == 1
    ref = tt.trace_plain(scene, *rays, any_hit=any_hit)
    h = ref.hit.cpu().numpy()
    assert h.sum() > 1000
    np.testing.assert_array_equal(got.hit.cpu().numpy(), h)
    if not any_hit:
        np.testing.assert_allclose(got.t.cpu().numpy(), ref.t.cpu().numpy(),
                                   rtol=1e-6)
        assert (got.tri == ref.tri).float().mean().item() >= 0.99


def test_kernel_checks_inputs(cuda):
    scene, (o, d, mint, maxt) = _scene(cuda, n_rays=64)
    with pytest.raises(ValueError):
        tt.trace(scene, o.cpu(), d, mint, maxt)
    with pytest.raises(TypeError):
        tt.trace(scene, o, d, mint.double(), maxt)
    with pytest.raises(ValueError):
        tt.trace(scene, o[::2], d[::2], mint[::2], maxt[::2][:16])


def test_bunny_render_on_card_matches_cpu(cuda):
    """48 x 36 bunny, 1 spp, depth 5: the kernel path on the card against
    the plain path on the CPU, with goblin_tpu's slice bar."""
    ovr = {"render_method": "path_tracing", "max_ray_depth": 5,
           "sample_per_pixel": 1}
    images = []
    for device in ("cpu", cuda):
        scene, meta = load_scene(os.path.join(REPO, "examples", "bunny.json"),
                                 ovr, device=device)
        meta.camera = dataclasses.replace(meta.camera, film=dataclasses.replace(
            meta.camera.film, x_res=48, y_res=36))
        images.append(common.render(scene, meta, make_li(meta)).cpu().numpy())
    cpu, gpu = images
    assert np.isfinite(gpu).all() and gpu.mean() > 0
    close = np.abs(gpu - cpu) <= 1e-4 + 1e-3 * np.abs(cpu)
    assert close.all(axis=-1).mean() >= 0.99
    assert abs(gpu.mean() - cpu.mean()) <= 1e-3 * cpu.mean()
