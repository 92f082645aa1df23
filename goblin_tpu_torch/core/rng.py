"""Counter-based stateless sample streams (port of goblin_tpu/core/rng.py).

Every random dimension is a pure function of (seed, pixel, sample, bounce,
dim), so a lane's sample stream is bit-equal to ``goblin_tpu``'s.

On CUDA tensors ``hash_uniform`` launches one kernel a call
(csrc/rng_hash.cu, uint32 arithmetic) and never falls back; on CPU tensors
it runs ``hash_uniform_plain``, the int64 form, which the tests hold the
kernel to. There the 32-bit arithmetic runs in int64 with the result masked
to 32 bits after each step: torch has no ``>>`` for uint32 tensors on the
CPU, and each multiply by a 32-bit constant is split in 16-bit halves so no
product leaves the int64 range. Coordinates given as Python ints stay Python
ints until they meet a tensor.
"""

from __future__ import annotations

import operator
from typing import NamedTuple

import torch

from .. import telemetry
from ..ops import trace as _trace

_MASK32 = 0xFFFFFFFF
_SEED_SALT = 0x1234567
_BOUNCE_MUL = 0x01000193

# what a coordinate is to the kernel
SCALAR, INT32, INT64 = 0, 1, 2


def _u32(x):
    """int or integer tensor -> its uint32 value (int, or int64 tensor)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & _MASK32
    return int(x) & _MASK32


def _mul32(a, k: int):
    """(a * k) mod 2**32 for a in [0, 2**32) and a 32-bit constant k."""
    lo = a * (k & 0xFFFF)
    hi = ((a * (k >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def _mix(a, b):
    """32-bit hash combine (xxhash-style avalanche), as goblin_tpu's _mix."""
    h = (_mul32(a, 0x9E3779B1) + b) & _MASK32
    h = h ^ (h >> 15)
    h = _mul32(h, 0x85EBCA77)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE3D)
    return h ^ (h >> 16)


def hash_uniform_plain(seed, pixel, sample, bounce, dim) -> torch.Tensor:
    """hash_uniform in int64 tensor ops: the CPU path and the kernel's
    reference."""
    h = _mix((_u32(seed) + _SEED_SALT) & _MASK32, _u32(pixel))
    h = _mix(h, _u32(sample))
    h = _mix(h, (_mul32(_u32(bounce), _BOUNCE_MUL) + _u32(dim)) & _MASK32)
    # top 24 bits -> [0, 1) with full mantissa coverage
    return (h >> 8).to(torch.float32) * (1.0 / (1 << 24))


class Operand(NamedTuple):
    """One coordinate as the kernel takes it."""
    kind: int  # SCALAR, INT32 or INT64
    array: torch.Tensor | None  # contiguous, of the output's shape; or None
    value: int  # a scalar's uint32 after the host's folding; else 0


class HashPlan(NamedTuple):
    """A call of the kernel: the output's shape and device, and the five
    coordinates' operands."""
    shape: torch.Size
    device: torch.device
    seed: Operand
    pixel: Operand
    sample: Operand
    bounce: Operand
    dim: Operand


def _operand(x, shape) -> Operand:
    if not isinstance(x, torch.Tensor):
        # operator.index refuses a float
        return Operand(SCALAR, None, operator.index(x) & _MASK32)
    if x.dtype not in (torch.int32, torch.int64):
        x = x.to(torch.int64)
    if x.shape != shape:
        x = x.expand(shape)
    x = x.contiguous()
    return Operand(INT32 if x.dtype == torch.int32 else INT64, x, 0)


def plan_hash(seed, pixel, sample, bounce, dim) -> HashPlan:
    """How the kernel computes hash_uniform(seed, pixel, sample, bounce,
    dim). Tensor coordinates are broadcast to the output's shape (copied
    where that or their layout differs), ints to their uint32. The host folds
    what scalars allow: a scalar seed carries its salt, a scalar bounce its
    multiplier, and with a scalar dim too the bounce carries their key and
    the dim is 0. Raises on a float coordinate, on no tensor, and on tensors
    on two devices."""
    coords = (seed, pixel, sample, bounce, dim)
    tensors = [x for x in coords if isinstance(x, torch.Tensor)]
    if not tensors:
        raise TypeError("hash_uniform: no coordinate is a tensor")
    shape, device = tensors[0].shape, tensors[0].device
    for x in tensors:
        if x.is_floating_point() or x.is_complex():
            raise TypeError(f"hash_uniform: coordinates are integers, got a "
                            f"{x.dtype} tensor")
        if x.device != device:
            raise ValueError("hash_uniform: coordinates on two devices")
        if x.shape != shape:
            shape = None
    if shape is None:
        # not torch.broadcast_shapes, whose first call imports sympy
        shape = torch.broadcast_tensors(*tensors)[0].shape
    s, p, q, b, d = (_operand(x, shape) for x in coords)
    if s.kind == SCALAR:
        s = Operand(SCALAR, None, (s.value + _SEED_SALT) & _MASK32)
    if b.kind == SCALAR:
        key = b.value * _BOUNCE_MUL
        if d.kind == SCALAR:
            key, d = key + d.value, Operand(SCALAR, None, 0)
        b = Operand(SCALAR, None, key & _MASK32)
    return HashPlan(shape, device, s, p, q, b, d)


def coord_args(plan: HashPlan) -> list:
    """The kernel entry's (kind, array pointer, value) for each coordinate
    of a plan, in order."""
    args = []
    for op in (plan.seed, plan.pixel, plan.sample, plan.bounce, plan.dim):
        args += (op.kind, None if op.array is None else op.array.data_ptr(),
                 op.value)
    return args


def _hash_cuda(plan: HashPlan) -> torch.Tensor:
    """Launch the kernel for a plan on the current stream."""
    if plan.device.index != torch.cuda.current_device():
        with torch.cuda.device(plan.device):
            return _hash_cuda(plan)
    out = torch.empty(plan.shape, dtype=torch.float32, device=plan.device)
    n = out.numel()
    if n == 0:
        return out
    err = _trace._kernel_lib("rng_hash").goblin_rng_hash(
        n, *coord_args(plan), out.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"rng_hash: launch failed with CUDA error {err}")
    telemetry.count("rng.hash_launches")
    return out


def hash_uniform(seed, pixel, sample, bounce, dim) -> torch.Tensor:
    """[0, 1) float32 from integer coordinates: ints or broadcastable
    integer tensors, with pixel a tensor. One kernel launch on CUDA
    tensors, the int64 form on CPU ones."""
    telemetry.count("rng.hash_calls")
    with telemetry.span("rng.hash"):
        coords = (seed, pixel, sample, bounce, dim)
        if any(isinstance(x, torch.Tensor) and x.is_cuda for x in coords):
            return _hash_cuda(plan_hash(*coords))
        return hash_uniform_plain(*coords)
