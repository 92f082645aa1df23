"""goblin_tpu_torch.telemetry: spans off and on, self times, the clock
against the torch profiler's, the path tracer's hash calls a pass, and a
film that recording leaves bit-equal; on the card, a pass that reads
nothing back to the host.

This file imports neither JAX nor goblin_tpu, so its card test runs on a
machine without them:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_telemetry.py
"""

import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from goblin_tpu_torch import bench, telemetry
from goblin_tpu_torch.camera import film as film_mod
from goblin_tpu_torch.integrators import common, path
from goblin_tpu_torch.parallel import mesh as pm

FILM = (32, 24)
CHUNK = 256  # three chunks a pass at 32 x 24
# the bunny's path tracer at depth 5: 2 camera hashes and 4 bounces of 7
# a chunk (the spot light is a delta light, so NEE draws no light sample),
# and the splat's 2 a pass
HASH_PER_CHUNK = 2 + 4 * 7
HASH_PER_SPLAT = 2


@pytest.fixture(autouse=True)
def fresh():
    """Recording off and no hot span before and after each test; the
    counters as they were."""
    saved = dict(telemetry.counters)
    telemetry.stop()
    telemetry.clear()
    yield
    telemetry.stop()
    telemetry.clear()
    telemetry.counters.clear()
    telemetry.counters.update(saved)


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def bunny():
    return bench.load_bunny(bench.PT_SETTINGS, "cpu", film=FILM)


def _pass(scene, meta, s_idx=0):
    """One pass of the path tracer on a fresh film -> (color, weight)."""
    rp, _ = common.make_render_pass(scene, meta, path.make_li(meta), 4, 7,
                                    CHUNK)
    color, weight = film_mod.new_film(meta.camera.film, "cpu")
    with torch.inference_mode():
        return rp(color, weight, s_idx)


def test_off_records_nothing():
    assert telemetry.span("a") is telemetry.span("b")  # one shared no-op
    with telemetry.span("a"):
        with telemetry.span("b"):
            pass
    assert telemetry.spans() == []
    telemetry.start()
    with telemetry.span("a"):
        pass
    telemetry.stop()
    with telemetry.span("c"):
        pass
    assert [r[0] for r in telemetry.spans()] == ["a"]


def test_nested_self_times():
    recs = [("a", 0, 100, None), ("b", 10, 40, "a"), ("c", 20, 30, "b"),
            ("d", 50, 60, "a"), ("e", 200, 210, None)]
    assert telemetry.self_times(recs) == {"a": 60, "b": 20, "c": 10,
                                          "d": 10, "e": 10}
    assert telemetry.innermost(recs) == [
        (0, 10, "a"), (10, 20, "b"), (20, 30, "c"), (30, 40, "b"),
        (40, 50, "a"), (50, 60, "d"), (60, 100, "a"), (200, 210, "e")]
    # recorded: parents by name, and the self times fill the outer span
    telemetry.start()
    with telemetry.span("outer"):
        with telemetry.span("mid"):
            with telemetry.span("leaf"):
                time.sleep(0.002)
        with telemetry.span("leaf"):
            time.sleep(0.001)
    recs = telemetry.spans()
    assert [(r[0], r[3]) for r in recs] == [
        ("leaf", "mid"), ("mid", "outer"), ("leaf", "outer"),
        ("outer", None)]
    own = telemetry.self_times(recs)
    outer = recs[-1][2] - recs[-1][1]
    assert sum(own.values()) == outer
    assert 3_000_000 <= own["leaf"] <= outer


def test_once_records_the_first_entry_only():
    name = "setup.test_once"
    before = len(telemetry.setup_spans())
    for _ in range(3):
        with telemetry.once(name):
            pass
    assert [r[0] for r in telemetry.setup_spans()[before:]] == [name]


def test_clock_is_the_profilers():
    """A span opened inside a profiler range lies within that range's
    kineto interval: both are on the host's wall clock."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("telemetry_test_range"):
            with telemetry.span("inner"):
                torch.ones(64).sum()
    rng = [e for e in prof.profiler.kineto_results.events()
           if e.name() == "telemetry_test_range"]
    assert len(rng) == 1
    (_, a, b, _), = telemetry.spans()
    assert rng[0].start_ns() <= a <= b <= rng[0].end_ns()
    # recording stopped with the profiler
    with telemetry.span("after"):
        pass
    assert len(telemetry.spans()) == 1


def test_pass_hash_calls(bunny):
    scene, meta = bunny
    n_chunks = -(-FILM[0] * FILM[1] // CHUNK)
    want = n_chunks * HASH_PER_CHUNK + HASH_PER_SPLAT
    calls = telemetry.counters.get("rng.hash_calls", 0)
    samples = telemetry.counters.get("render.samples", 0)
    telemetry.start()
    _pass(scene, meta)
    telemetry.stop()
    assert telemetry.counters["rng.hash_calls"] - calls == want == 92
    assert (telemetry.counters["render.samples"] - samples
            == FILM[0] * FILM[1])
    names = [r[0] for r in telemetry.spans()]
    assert names.count("rng.hash") == want
    assert names.count("render.pass") == 1
    assert names.count("render.camera") == n_chunks
    assert names.count("pt.bounce") == 4 * n_chunks
    assert names.count("scene.occluded") == 4 * n_chunks
    # the camera hit and three continuations: the last bounce's trace is
    # skipped with only delta lights
    assert names.count("scene.intersect") == 4 * n_chunks
    assert names.count("render.splat") == 1
    # every span of the path tracer's stages took some time of its own
    # (the sppm.* spans are SPPM's, tests/test_torch_sppm_plainref.py)
    own = telemetry.self_times(telemetry.spans())
    assert {n for n in telemetry.STAGES if not n.startswith("sppm.")} \
        <= set(own)


def test_recording_leaves_the_film_bit_equal(bunny):
    scene, meta = bunny
    off = _pass(scene, meta, 3)
    telemetry.start()
    on = _pass(scene, meta, 3)
    telemetry.stop()
    assert telemetry.spans()
    for a, b in zip(off, on):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_pass_reads_nothing_back():
    """A steady pass of the path tracer, and of the sharded pass at world
    1, makes no synchronizing call (no device-to-host read), so a pass can
    be queued without waiting on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    scene, meta = bench.load_bunny(bench.PT_SETTINGS, "cuda")
    li = path.make_li(meta)
    rp, _ = common.make_render_pass(scene, meta, li, 4, 7)
    srp, _ = pm.make_sharded_render_pass(scene, meta, li,
                                         pm.make_mesh(device="cuda"), 4, 7)
    for step in (rp, srp):
        color, weight = film_mod.new_film(meta.camera.film, "cuda")
        with torch.inference_mode():
            step(color, weight, 0)  # first calls: library load, caches
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                step(color, weight, 1)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
        assert weight.sum().item() > 0.0
