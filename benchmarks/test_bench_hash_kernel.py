"""CPU tests of hash_kernel_share.render, the share of the sample hash's
calls that launched its kernel.

    python -m pytest benchmarks -q
"""

import os
import sys

import pytest

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
sys.path[:0] = [p for p in (ROOT, BENCH) if p not in sys.path]

from benchlib import spec, stages  # noqa: E402
from goblin_tpu_torch import telemetry  # noqa: E402

NAME = "hash_kernel_share.render"


@pytest.mark.parametrize("counters,share", [
    ({"rng.hash_calls": 92, "rng.hash_launches": 92}, 100.0),
    ({"rng.hash_calls": 92, "rng.hash_launches": 23}, 25.0),
    ({"rng.hash_calls": 92, "rng.hash_launches": 0}, 0.0),
    # a program without the kernel, or a run on the CPU: no launch counted
    ({"rng.hash_calls": 92}, None),
    ({}, None),
])
def test_share_of_calls_that_launched(monkeypatch, counters, share):
    monkeypatch.setattr(telemetry, "counters", counters)
    got = spec.reader(NAME)({"kind": "render"})
    assert got == (None if share is None else pytest.approx(share))


def test_nothing_outside_a_render_or_without_telemetry(monkeypatch):
    monkeypatch.setattr(telemetry, "counters",
                        {"rng.hash_calls": 4, "rng.hash_launches": 4})
    assert spec.reader(NAME)({"kind": "train"}) is None
    monkeypatch.setattr(stages, "telemetry", lambda: None)
    assert spec.reader(NAME)({"kind": "render"}) is None
