"""The sample hash's CUDA kernel (csrc/rng_hash.cu) against the int64 form
(core/rng.py::hash_uniform_plain) on the same CUDA tensors, bit for bit, in
every call form the port uses and at the edges; and one bunny PT chunk that
launches the kernel once a call and reads nothing back.

Needs an NVIDIA GPU and nvcc; skipped elsewhere. This file imports neither
JAX nor goblin_tpu, so it runs on a machine without them:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_rng_cuda.py
"""

import numpy as np
import pytest
import torch

from goblin_tpu_torch import bench, telemetry
from goblin_tpu_torch.core import rng
from goblin_tpu_torch.integrators import common, path

LANES = 65_536
SEED = 3100001701


def forms(device):
    """name -> (seed, pixel, sample, bounce, dim): each call form of the
    port, and ints and arrays at the edges of the 32-bit reduction."""
    g = np.random.default_rng(17)

    def t(a, dtype=torch.int64):
        return torch.as_tensor(np.asarray(a), device=device).to(dtype)

    lane = np.arange(LANES)
    pix32 = t(lane * 3 + 11, torch.int32)
    wide = np.concatenate([g.integers(-(1 << 62), 1 << 62, LANES // 2),
                           g.integers(-(1 << 33), 1 << 33, LANES // 2)])
    return {
        # common.pixel_samples: an int sample index, the camera's bounce
        "int_sample": (SEED, pix32, 5, common.BOUNCE_CAMERA, 0),
        # the regenerative driver: one sample index a lane
        "tensor_sample": (SEED, pix32, t(g.integers(0, 4096, LANES)), 3, 9),
        "int32_sample": (SEED, pix32, t(g.integers(0, 64, LANES),
                                        torch.int32), 0x57A7, 2),
        "int64_pixel": (SEED, t(lane * 5 + 7), 1, 2, 3),
        # Whitted's node tags, BDPT's per-lane dims
        "per_lane_bounce_dim": (SEED, pix32, 4, t(g.integers(0, 20, LANES),
                                                  torch.int32),
                                t(g.integers(0, 16, LANES))),
        "per_lane_bounce": (SEED, pix32, 4, t(g.integers(0, 1 << 15, LANES)),
                            7),
        "per_lane_dim": (SEED, pix32, 4, 1, t(g.integers(0, 99, LANES),
                                               torch.int32)),
        # AO: (R, 1) pixels against (K,) dimensions
        "ao_broadcast": (SEED, pix32[:4096, None], 2, 1,
                         common.DIM_BASE + 2 * t(np.arange(16))),
        "negative_ints": (-1, pix32, -7, -3, -(1 << 40)),
        "ints_above_2_32": ((1 << 40) + 5, pix32, (1 << 33) + 1,
                            0xFFFFFFFF + 2, (1 << 62) + 9),
        "int64_above_2_32": (SEED, t(wide), t(wide[::-1].copy()), 0, t(wide)),
        "tensor_seed": (t(g.integers(0, 1 << 31, LANES)), pix32, 3, 2, 1),
        "int16_pixel": (SEED, t(lane % 30000, torch.int16), 1, 1, 1),
        "zero_dim_sample": (SEED, pix32, t(12), 2, 5),
        "non_contiguous": (SEED, t(np.arange(2 * LANES), torch.int32)[::2],
                           t(np.arange(3 * LANES))[::3], 6, 1),
        "lanes_0": (SEED, pix32[:0], 0, 0, 0),
        "lanes_1": (SEED, pix32[:1], 0, 0, 0),
        "lanes_196608": (SEED, t(np.arange(196_608), torch.int32), 2,
                         common.BOUNCE_CAMERA, 1),
    }


FORMS = tuple(forms("cpu"))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("form", FORMS)
def test_kernel_bit_equal_to_the_int64_form(cuda, form):
    coords = forms(cuda)[form]
    launches = telemetry.counters.get("rng.hash_launches", 0)
    got = rng.hash_uniform(*coords)
    ref = rng.hash_uniform_plain(*coords)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.device.type == "cuda"
    assert got.shape == ref.shape
    assert torch.equal(got, ref)
    assert telemetry.counters.get("rng.hash_launches", 0) - launches == \
        (1 if ref.numel() else 0)


@pytest.mark.cuda
def test_a_pt_chunk_launches_once_a_call_and_reads_nothing_back(cuda):
    scene, meta = bench.load_bunny(bench.PT_SETTINGS, "cuda")
    li = path.make_li(meta)
    spec = meta.camera.film
    pix = common.crop_pixel_ids(spec, cuda)[:LANES]
    n_grid = common.spp_grid(4)

    def chunk(s_idx):
        ray = common.camera_rays(meta.camera, 7, pix, s_idx, n_grid)
        return li(scene, meta, ray, pix, s_idx, 7)

    with torch.inference_mode():
        chunk(0)  # the libraries' first load
        torch.cuda.synchronize()
        calls = telemetry.counters.get("rng.hash_calls", 0)
        launches = telemetry.counters.get("rng.hash_launches", 0)
        torch.cuda.set_sync_debug_mode("error")
        try:
            L = chunk(1)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
    n_calls = telemetry.counters["rng.hash_calls"] - calls
    assert n_calls == 2 + 4 * 7  # the camera's 2, 7 in each of 4 bounces
    assert telemetry.counters["rng.hash_launches"] - launches == n_calls
    assert L.shape == (LANES, 3) and L.sum().item() > 0.0
