"""CPU tests of photons_per_walk.sppm, the photons a light walk of SPPM.

    python -m pytest benchmarks -q
"""

import json
import os
import sys

import pytest

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
sys.path[:0] = [p for p in (ROOT, BENCH) if p not in sys.path]

from benchlib import spec, stages  # noqa: E402
from goblin_tpu_torch import telemetry  # noqa: E402

NAME = "photons_per_walk.sppm"


@pytest.mark.parametrize("counters,photons", [
    # one walk an iteration, over 3 iterations of 196,608 photons
    ({"sppm.photons": 3 * 196_608, "sppm.photon_walks": 3}, 196_608.0),
    # a walk a chunk of 32,768
    ({"sppm.photons": 3 * 196_608, "sppm.photon_walks": 18}, 32_768.0),
    # a program that counts no walk
    ({"sppm.photons": 196_608}, None),
    ({"sppm.photons": 196_608, "sppm.photon_walks": 0}, None),
    ({}, None),
])
def test_photons_over_walks(monkeypatch, counters, photons):
    monkeypatch.setattr(telemetry, "counters", counters)
    got = spec.reader(NAME)({"kind": "render"})
    assert got == (None if photons is None else pytest.approx(photons))


def test_nothing_outside_a_render_or_without_telemetry(monkeypatch):
    monkeypatch.setattr(telemetry, "counters",
                        {"sppm.photons": 8, "sppm.photon_walks": 1})
    assert spec.reader(NAME)({"kind": "train"}) is None
    monkeypatch.setattr(stages, "telemetry", lambda: None)
    assert spec.reader(NAME)({"kind": "render"}) is None


def test_the_entry_and_the_cell():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        b = json.load(f)
    (m,) = [m for m in b["per_layer"] if m["name"] == NAME]
    assert m == {"name": NAME, "unit": "photons/walk", "better": "higher",
                 "source": "program_counter", "layer": "host orchestration",
                 "moves": "device_ms_per_msample",
                 "workloads": ["bunny_shipped.sppm"]}
    assert NAME in {x["name"] for x in
                    spec.Cell("bunny_shipped.sppm").metrics(True)}
