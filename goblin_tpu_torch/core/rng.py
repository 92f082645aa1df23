"""Counter-based stateless sample streams (port of goblin_tpu/core/rng.py).

Every random dimension is a pure function of (seed, pixel, sample, bounce,
dim), so a lane's sample stream is bit-equal to ``goblin_tpu``'s. The
32-bit arithmetic runs in int64 with the result masked to 32 bits after
each step: torch has no ``>>`` for uint32 tensors on the CPU, and each
multiply by a 32-bit constant is split in 16-bit halves so no product
leaves the int64 range. Coordinates given as Python ints stay Python ints
until they meet a tensor.
"""

from __future__ import annotations

import torch

from .. import telemetry

_MASK32 = 0xFFFFFFFF


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


def hash_uniform(seed, pixel, sample, bounce, dim) -> torch.Tensor:
    """[0, 1) float32 from integer coordinates: ints or broadcastable
    integer tensors, with pixel a tensor."""
    telemetry.count("rng.hash_calls")
    with telemetry.span("rng.hash"):
        h = _mix((_u32(seed) + 0x1234567) & _MASK32, _u32(pixel))
        h = _mix(h, _u32(sample))
        h = _mix(h, (_mul32(_u32(bounce), 0x01000193) + _u32(dim))
                 & _MASK32)
        # top 24 bits -> [0, 1) with full mantissa coverage
        return (h >> 8).to(torch.float32) * (1.0 / (1 << 24))
