"""The sample hash's CUDA path, as far as the CPU reaches it: CPU tensors
still take the int64 form (calls counted, no launch, bit-equal to
goblin_tpu's); the wrapper's plan of a kernel call, case by case, and a
numpy emulation of the kernel's uint32 arithmetic over that plan, bit-equal
to the int64 form; the kernel library's build key.

The call forms are test_torch_rng_cuda.py's, which holds the kernel itself
to the int64 form on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goblin_tpu.core.rng import hash_uniform as j_hash
from goblin_tpu_torch import telemetry
from goblin_tpu_torch.core import rng
from goblin_tpu_torch.integrators import common
from goblin_tpu_torch.ops import trace as tt
from test_torch_rng_cuda import FORMS, LANES, SEED, forms

MASK = 0xFFFFFFFF


def _u32_numpy(x):
    """A coordinate as goblin_tpu takes it: reduced to uint32 in numpy."""
    if isinstance(x, torch.Tensor):
        return (x.numpy().astype(np.int64) & MASK).astype(np.uint32)
    return np.uint32(int(x) & MASK)


@pytest.mark.parametrize("form", FORMS)
def test_cpu_path_counts_calls_no_launch_and_matches_goblin_tpu(form):
    coords = forms("cpu")[form]
    calls = telemetry.counters.get("rng.hash_calls", 0)
    launches = telemetry.counters.get("rng.hash_launches", 0)
    got = rng.hash_uniform(*coords)
    assert telemetry.counters["rng.hash_calls"] - calls == 1
    assert telemetry.counters.get("rng.hash_launches", 0) == launches
    assert torch.equal(got, rng.hash_uniform_plain(*coords))
    seed, pixel, sample, bounce, dim = (_u32_numpy(x) for x in coords)
    ref = np.asarray(j_hash(seed, jnp.asarray(pixel), sample, bounce, dim))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)


def _mix(a, b):
    h = a * np.uint32(0x9E3779B1) + b
    h ^= h >> np.uint32(15)
    h *= np.uint32(0x85EBCA77)
    h ^= h >> np.uint32(13)
    h *= np.uint32(0xC2B2AE3D)
    return h ^ (h >> np.uint32(16))


def emulate(plan):
    """What csrc/rng_hash.cu computes for a plan, in numpy's wrapping uint32
    arithmetic, a lane at a time as the kernel's loop does."""
    n = int(np.prod(plan.shape, dtype=np.int64))

    def coord(op):
        if op.kind == rng.SCALAR:
            assert op.array is None
            return np.full(n, op.value, np.uint32)
        a = op.array
        assert a.is_contiguous() and a.shape == plan.shape
        assert a.dtype == (torch.int32 if op.kind == rng.INT32
                           else torch.int64)
        # the kernel reads an int64 as its low 32 bits
        return a.numpy().reshape(-1).astype(np.uint32)

    with np.errstate(over="ignore"):
        s = (np.full(n, plan.seed.value, np.uint32)
             if plan.seed.kind == rng.SCALAR
             else coord(plan.seed) + np.uint32(0x1234567))
        b = (np.full(n, plan.bounce.value, np.uint32)
             if plan.bounce.kind == rng.SCALAR
             else coord(plan.bounce) * np.uint32(0x01000193))
        h = _mix(s, coord(plan.pixel))
        h = _mix(h, coord(plan.sample))
        h = _mix(h, b + coord(plan.dim))
    out = (h >> np.uint32(8)).astype(np.float32) * np.float32(1.0 / (1 << 24))
    return out.reshape(tuple(plan.shape))


@pytest.mark.parametrize("form", FORMS)
def test_emulated_kernel_over_the_plan_matches_the_int64_form(form):
    coords = forms("cpu")[form]
    ref = rng.hash_uniform_plain(*coords)
    plan = rng.plan_hash(*coords)
    assert plan.shape == ref.shape and plan.device.type == "cpu"
    np.testing.assert_array_equal(emulate(plan), ref.numpy())


S, I32, I64 = rng.SCALAR, rng.INT32, rng.INT64
SALT, MUL = 0x1234567, 0x01000193


@pytest.mark.parametrize("form,kinds,values,shape", [
    # the common PT call reads one array: the seed and the key are folded
    ("int_sample", (S, I32, S, S, S),
     ((SEED + SALT) & MASK, 0, 5, common.BOUNCE_CAMERA * MUL & MASK, 0),
     (LANES,)),
    ("tensor_sample", (S, I32, I64, S, S),
     ((SEED + SALT) & MASK, 0, 0, (3 * MUL + 9) & MASK, 0), (LANES,)),
    ("int32_sample", (S, I32, I32, S, S),
     ((SEED + SALT) & MASK, 0, 0, (0x57A7 * MUL + 2) & MASK, 0), (LANES,)),
    ("int64_pixel", (S, I64, S, S, S),
     ((SEED + SALT) & MASK, 0, 1, (2 * MUL + 3) & MASK, 0), (LANES,)),
    ("per_lane_bounce_dim", (S, I32, S, I32, I64),
     ((SEED + SALT) & MASK, 0, 4, 0, 0), (LANES,)),
    # a per-lane bounce leaves the dim to the kernel, unfolded
    ("per_lane_bounce", (S, I32, S, I64, S),
     ((SEED + SALT) & MASK, 0, 4, 0, 7), (LANES,)),
    ("per_lane_dim", (S, I32, S, S, I32),
     ((SEED + SALT) & MASK, 0, 4, MUL, 0), (LANES,)),
    ("ao_broadcast", (S, I32, S, S, I64),
     ((SEED + SALT) & MASK, 0, 2, MUL, 0), (4096, 16)),
    ("negative_ints", (S, I32, S, S, S),
     ((-1 + SALT) & MASK, 0, -7 & MASK,
      ((-3 & MASK) * MUL + (-(1 << 40) & MASK)) & MASK, 0), (LANES,)),
    ("ints_above_2_32", (S, I32, S, S, S),
     ((5 + SALT) & MASK, 0, 1, (MUL + 9) & MASK, 0), (LANES,)),
    ("tensor_seed", (I64, I32, S, S, S),
     (0, 0, 3, (2 * MUL + 1) & MASK, 0), (LANES,)),
    ("int16_pixel", (S, I64, S, S, S),
     ((SEED + SALT) & MASK, 0, 1, (MUL + 1) & MASK, 0), (LANES,)),
    ("zero_dim_sample", (S, I32, I64, S, S),
     ((SEED + SALT) & MASK, 0, 0, (2 * MUL + 5) & MASK, 0), (LANES,)),
    ("lanes_0", (S, I32, S, S, S), ((SEED + SALT) & MASK, 0, 0, 0, 0), (0,)),
])
def test_plan_operands(form, kinds, values, shape):
    coords = forms("cpu")[form]
    plan = rng.plan_hash(*coords)
    ops = (plan.seed, plan.pixel, plan.sample, plan.bounce, plan.dim)
    assert tuple(op.kind for op in ops) == kinds
    assert tuple(op.value for op in ops) == values
    assert tuple(plan.shape) == shape
    for op in ops:
        if op.kind != rng.SCALAR:
            assert tuple(op.array.shape) == shape
            assert op.array.is_contiguous()


def test_plan_reads_a_contiguous_coordinate_in_place():
    seed, pixel, sample, bounce, dim = forms("cpu")["tensor_sample"]
    plan = rng.plan_hash(seed, pixel, sample, bounce, dim)
    assert plan.pixel.array.data_ptr() == pixel.data_ptr()
    assert plan.sample.array.data_ptr() == sample.data_ptr()
    # a strided view is copied into a contiguous array
    strided = forms("cpu")["non_contiguous"]
    plan = rng.plan_hash(*strided)
    assert not strided[1].is_contiguous()
    assert plan.pixel.array.is_contiguous()
    assert torch.equal(plan.pixel.array, strided[1])


@pytest.mark.parametrize("coords,error", [
    ((1, torch.arange(4, dtype=torch.float32), 0, 0, 0), TypeError),
    ((1, torch.arange(4), 0.5, 0, 0), TypeError),
    ((1, torch.arange(4), 0, torch.zeros(4, dtype=torch.float64), 0),
     TypeError),
    ((1, 2, 3, 4, 5), TypeError),
    ((1, torch.arange(4), torch.arange(4, device="meta"), 0, 0), ValueError),
])
def test_plan_refuses(coords, error):
    with pytest.raises(error):
        rng.plan_hash(*coords)


def test_hash_library_build_key(monkeypatch, tmp_path):
    trace_names = ("trace_bvh8", "trace_bvh4", "trace_bvh2")
    keys = {name: tt.build_key(name) for name in trace_names}
    key = tt.build_key("rng_hash")
    assert key not in keys.values()
    assert tt.KERNEL_SOURCES["rng_hash"] not in tt.KERNEL_HEADERS
    assert "rng_hash" not in tt.KERNEL_DEFINES
    # the trace libraries' keys do not read the hash's source
    edited = tmp_path / "rng_hash.cu"
    with open(tt.KERNEL_SOURCES["rng_hash"], "rb") as f:
        edited.write_bytes(f.read() + b"\n// edited\n")
    monkeypatch.setitem(tt.KERNEL_SOURCES, "rng_hash", str(edited))
    assert tt.build_key("rng_hash") != key
    assert {name: tt.build_key(name) for name in trace_names} == keys
