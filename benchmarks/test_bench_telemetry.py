"""CPU tests of the readers of the program's spans and counters
(benchlib/stages.py and the seven metrics over it): the clocks' offset,
self time and the device's idle time split by stage on synthetic traces
and spans, and small runs of both entries printing the seven metrics.

    python -m pytest benchmarks -q
"""

import argparse
import json
import os
import subprocess
import sys

import pytest

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
sys.path[:0] = [p for p in (ROOT, BENCH) if p not in sys.path]

from benchlib import spec, stages  # noqa: E402
from goblin_tpu_torch import telemetry  # noqa: E402

SEED = 3000000011
FILM = (32, 24)
STAGE_METRICS = ("hash_idle_share.render", "intersect_idle_share.render",
                 "shade_idle_share.render", "splat_idle_share.render")
NEW = STAGE_METRICS + ("hash_calls_per_msample.render",
                       "trace_library_s.setup", "first_pass_s.setup")
# the program's clock at the profile's start, in ns
T0 = 1_800_000_000_000_000_000


class FakeTrace:
    """What the readers use of benchlib.profile.Trace: the harness's spans
    and the device operations, in seconds from the profile's start."""

    def __init__(self, spans, device_ops):
        self.spans = spans
        self.device_ops = device_ops
        passes = [(a, b) for a, b, n in spans if n == "pass"]
        self.lo = min(a for a, _ in passes)
        self.hi = max(b for _, b in passes)


def ns(s):
    return T0 + round(s * 1e9)


def rec_of(spans, device_ops):
    return {"kind": "render", "trace": FakeTrace(spans, device_ops)}


@pytest.fixture
def program_spans(monkeypatch):
    """Set the program's hot span records the readers see."""
    def put(records):
        monkeypatch.setattr(telemetry, "spans", lambda: list(records))
    return put


def test_offset_is_the_smallest_lag(program_spans):
    # two harness passes at 1.0 and 2.0 s; the program's passes start
    # 30 and 10 us later on its own clock
    spans = [(1.0, 1.5, "pass"), (2.0, 2.5, "pass")]
    program_spans([
        ("render.pass", ns(0.2), ns(0.3), None),  # before the window
        ("render.pass", ns(1.000030), ns(1.4), None),
        ("render.pass", ns(2.000010), ns(2.4), None)])
    rec = rec_of(spans, [])
    assert stages.offsets_ns(rec) == [T0 + 30_000, T0 + 10_000]
    shifted = stages.aligned(rec)
    # the earlier pass falls outside the window; the others move by the
    # smallest lag, so the second starts with its harness pass
    assert [(a, b) for _, a, b, _ in shifted] == [
        (1_000_020_000, 1_399_990_000), (2_000_000_000, 2_399_990_000)]


def test_no_telemetry_no_number(program_spans, monkeypatch):
    rec = rec_of([(0.0, 1.0, "pass")], [])
    program_spans([])  # no spans recorded
    for name in STAGE_METRICS:
        assert spec.reader(name)(rec) is None
    assert spec.reader("hash_calls_per_msample.render")(
        {"kind": "train"}) is None
    # a program without telemetry (the parent of this change): nothing,
    # and no exception
    monkeypatch.setattr(stages, "telemetry", lambda: None)
    rec["trace"].device_ops = [(0.0, 0.5, "k")]
    for name in NEW:
        assert spec.reader(name)(rec) is None


def test_idle_split_by_stage(program_spans):
    # one pass, 0 .. 10 s on the trace's clock; the device busy 0-1 and
    # 6-7 s, so 8 s idle
    spans = [(0.0, 10.0, "pass")]
    ops = [(0.0, 1.0, "k"), (6.0, 7.0, "k")]
    program_spans([
        ("rng.hash", ns(1.0), ns(2.0), "pt.bounce"),
        ("scene.intersect", ns(2.5), ns(3.5), "pt.bounce"),
        ("pt.bounce", ns(0.5), ns(4.0), "render.pass"),
        ("rng.hash", ns(5.5), ns(6.5), "render.splat"),
        ("render.splat", ns(5.0), ns(8.0), "render.pass"),
        ("render.pass", ns(0.0), ns(9.0), None)])
    rec = rec_of(spans, ops)
    split = stages.idle_by_stage(rec)
    # idle 1-6 and 7-10. hash: 1-2 and 5.5-6 (6-6.5 is busy), 1.5 s;
    # intersect 2.5-3.5, 1.0 s; shade, the bounce's own: 2-2.5 and 3.5-4
    # (0.5-1 is busy), 1.0 s; splat's own: 5-5.5 and 7-8, 1.5 s; rest: the
    # pass's own 4-5 and 8-9 and no span 9-10, 3.0 s
    assert split["hash"] == pytest.approx(100 * 1.5 / 8)
    assert split["intersect"] == pytest.approx(100 * 1.0 / 8)
    assert split["shade"] == pytest.approx(100 * 1.0 / 8)
    assert split["splat"] == pytest.approx(100 * 1.5 / 8)
    assert split["rest"] == pytest.approx(100 * 3.0 / 8)
    assert sum(split.values()) == pytest.approx(100.0)
    for name in STAGE_METRICS:
        assert spec.reader(name)(rec) == pytest.approx(
            split[name.split("_")[0]])


def test_self_times_by_stage():
    recs = [("pt.bounce", 0, 100, None), ("rng.hash", 10, 30, "pt.bounce"),
            ("scene.occluded", 40, 90, "pt.bounce")]
    own = telemetry.self_times(recs)
    assert own == {"pt.bounce": 30, "rng.hash": 20, "scene.occluded": 50}
    assert [telemetry.STAGES[n] for n in ("pt.bounce", "rng.hash",
                                           "scene.occluded")] == [
        "shade", "hash", "intersect"]


def test_counters_and_setup_readers(monkeypatch):
    monkeypatch.setattr(telemetry, "counters",
                        {"rng.hash_calls": 92, "render.samples": 196_608})
    rec = {"kind": "render"}
    assert spec.reader("hash_calls_per_msample.render")(rec) == \
        pytest.approx(92 / 0.196608)
    monkeypatch.setattr(telemetry, "setup_spans", lambda: [
        ("setup.trace_library", 0, 2_000_000, None),
        ("setup.trace_library", 5_000_000, 6_000_000, None),
        ("setup.first_pass", 4_000_000, 9_000_000, None)])
    assert spec.reader("trace_library_s.setup")(rec) == pytest.approx(0.003)
    assert spec.reader("first_pass_s.setup")(rec) == pytest.approx(0.005)


CHILD_RUN = """
import argparse, json, sys, time
t0 = time.perf_counter()
sys.path[:0] = [{root!r}, {bench!r}]
import torch
torch.set_num_threads(2)
from benchlib import spec
if __name__ == "__main__":
    a = argparse.Namespace(workload={workload!r}, seed={seed}, seconds=1.0,
                           trace=1)
    cell = spec.Cell(a.workload)
    rec = cell.entry().run(cell, a, "cpu", t0, film={film!r})
    names = [m["name"] for m in cell.metrics(True)] + ["setup_s"]
    print(json.dumps({{n: spec.reader(n)(rec) for n in names}}))
"""


@pytest.mark.parametrize("workload", ["bunny.pt", "bunny.pt_x4"])
def test_small_runs_print_the_new_metrics(workload, tmp_path):
    """Each entry's small traced run in a process of its own, as a run is:
    the seven metrics, the shares within 100%, the hash calls the bunny's
    pass implies (2 + 4 x 7 a chunk, 2 a pass, one chunk at 32 x 24), and
    set-up's parts within setup_s."""
    script = tmp_path / "child_run.py"
    script.write_text(CHILD_RUN.format(root=ROOT, bench=BENCH,
                                       workload=workload, seed=SEED,
                                       film=FILM))
    p = subprocess.run([sys.executable, str(script)], capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    m = json.loads(p.stdout.strip().splitlines()[-1])
    assert all(m[n] is not None for n in NEW)
    shares = [m[n] for n in STAGE_METRICS]
    assert all(s >= 0.0 for s in shares) and sum(shares) <= 100.0 + 1e-9
    assert m["hash_calls_per_msample.render"] == pytest.approx(
        (2 + 4 * 7 + 2) / (FILM[0] * FILM[1] / 1e6))
    assert m["trace_library_s.setup"] == 0.0  # the CPU loads no library
    assert 0.0 < m["first_pass_s.setup"] < m["setup_s"]
