"""The SPPM cell, bunny_shipped.sppm: its files and names, small runs of
its entry, the faults its check has to fail and its control; on a card,
one iteration whose only synchronizing calls are the drain's reads.

    python -m pytest benchmarks/test_bench_sppm.py -q            # CPU
    python -m pytest benchmarks/test_bench_sppm.py -q -m cuda    # a card

The faults are planted at a 64 x 48 film over a 4 s window (3-5
iterations): at 32 x 24 the scene's radius of 0.01 gathers at a handful of
pixels, too few for a fault on the photon side to reach the checked ones.
"""

import argparse
import filecmp
import functools
import glob
import json
import os
import sys
import time
import warnings

import pytest

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
sys.path[:0] = [p for p in (ROOT, BENCH) if p not in sys.path]

import torch  # noqa: E402

import control_sppm  # noqa: E402
from benchlib import harness, render, spec, stages  # noqa: E402

CELL = "bunny_shipped.sppm"
FILM = (32, 24)
FAULT_FILM = (64, 48)
SEED = 3000000099
NEW = ("photon_idle_share.sppm", "grid_idle_share.sppm",
       "drain_idle_share.sppm", "drain_turns_per_iteration.sppm",
       "photons_per_msample.sppm")


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def run(seconds=1.0, film=FILM, trace=0):
    args = argparse.Namespace(workload=CELL, seed=SEED, seconds=seconds,
                              trace=trace)
    return harness.run(args, time.perf_counter(), device="cpu", film=film)


def fault_run():
    return run(seconds=4.0, film=FAULT_FILM)


# --- the files and names ---------------------------------------------------

def test_the_cell_and_its_files():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        b = json.load(f)
    (cfg,) = [c for c in b["configs"] if c["name"] == "bunny_shipped"]
    assert cfg["reduced"] == []
    assert cfg["file"] == "benchmarks/configs/bunny_shipped.json"
    (w,) = [w for w in b["workloads"] if w["name"] == CELL]
    assert (w["config"], w["traffic"], w["chips"]) == (
        "bunny_shipped", "sppm", 1)
    cell = spec.Cell(CELL)
    # the scene as shipped, with no render_setting override
    assert filecmp.cmp(cell.scene_path(),
                       os.path.join(ROOT, "examples", "bunny.json"),
                       shallow=False)
    assert "render_setting" not in cell.config
    assert cell.traffic["entry"] == "sppm_iteration"
    assert hasattr(cell.entry(), "run")
    assert {m["name"] for m in cell.metrics(False)} == {
        "device_ms_per_msample", "setup_s"}
    layer = {m["name"]: m for m in b["per_layer"]}
    for name in NEW:
        m = layer[name]
        assert m["workloads"] == [CELL]
        assert m["moves"] == "device_ms_per_msample"
        assert m["source"] in ("program_span", "program_counter")
        assert callable(spec.reader(name))
    assert set(NEW) <= {m["name"] for m in cell.metrics(True)}


def test_the_reference_imports_nothing_of_the_program():
    for path in glob.glob(os.path.join(BENCH, "plainref_sppm", "*.py")):
        with open(path) as f:
            for line in f:
                words = line.split()
                if words[:1] in (["import"], ["from"]) and len(words) > 1:
                    top = words[1].split(".")[0]
                    assert top not in ("jax", "jaxlib", "goblin_tpu",
                                       "goblin_tpu_torch"), (path, line)


def test_the_reference_turns_tf32_off(monkeypatch):
    from plainref_sppm import sppm as rsppm

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    cell = spec.Cell(CELL)
    sc = rsppm.load(cell.scene_path(), render.settings(cell, SEED),
                    film=FILM)
    assert sc.settings["render_method"] == "sppm"
    assert (sc.settings["max_ray_depth"], sc.settings["initial_radius"]) \
        == (20, 0.01)
    rsppm.Renderer(sc, "cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


# --- small runs ------------------------------------------------------------

def test_small_run():
    result = run()
    assert result["correct"] is True and result["attempted"] >= 1
    # the CPU has no device time to read
    assert set(result["metrics"]) == {"setup_s"}
    assert result["check"]["photon_bad_share"]["value"] == 0.0


def test_small_traced_run_reports_the_new_metrics(monkeypatch):
    """The entry's record read by the five new readers; the idle shares of
    every stage and `rest` sum to 100. The counters start from nothing, as
    in a run's own process."""
    from goblin_tpu_torch import telemetry

    monkeypatch.setattr(telemetry, "counters", {})
    cell = spec.Cell(CELL)
    args = argparse.Namespace(workload=CELL, seed=SEED, seconds=1.0,
                              trace=1)
    rec = cell.entry().run(cell, args, "cpu", time.perf_counter(),
                           film=FILM)
    assert bool(rec["correct"]) is True
    values = {n: spec.reader(n)(rec) for n in NEW}
    assert all(v is not None for v in values.values()), values
    split = stages.idle_by_stage(rec)
    assert {"shade", "photon", "grid", "drain", "splat", "rest"} <= set(
        split)
    assert sum(split.values()) == pytest.approx(100.0)
    assert values["photon_idle_share.sppm"] == split["photon"] > 0.0
    # one photon a camera sample
    assert values["photons_per_msample.sppm"] == pytest.approx(1e6)
    assert values["drain_turns_per_iteration.sppm"] > 0.0


# --- what the check has to fail --------------------------------------------

def test_sound_run_at_the_faults_film_passes():
    result = fault_run()
    assert result["correct"] is True and result["attempted"] >= 3


def _drains(monkeypatch, wrap):
    """Every drain through wrap(drain, call index)."""
    from goblin_tpu_torch.integrators import sppm

    orig = sppm.make_photon_passes

    def make(*a, **k):
        deposit, drain = orig(*a, **k)
        calls = []

        def planted(*d):
            calls.append(1)
            return wrap(drain, len(calls), *d)
        return deposit, planted

    monkeypatch.setattr(sppm, "make_photon_passes", make)


def test_a_photon_chunk_dropped_fails(monkeypatch):
    """Four chunks an iteration (the same photons), the first one's drain
    left out."""
    from goblin_tpu_torch.integrators import sppm

    n_pix = FAULT_FILM[0] * FAULT_FILM[1]
    monkeypatch.setattr(sppm, "make_sppm", functools.partial(
        sppm.make_sppm, chunk_size=n_pix // 4))

    def drop(drain, call, *d):
        phi, mi = d[-2:]
        return (phi, mi) if call % 4 == 1 else drain(*d)

    _drains(monkeypatch, drop)
    assert fault_run()["correct"] is False


def test_flux_altered_fails(monkeypatch):
    from goblin_tpu_torch.integrators import sppm

    update = sppm._update

    def more(*a):
        n, tau, r = update(*a)
        return n, tau * 1.01, r

    monkeypatch.setattr(sppm, "_update", more)
    assert fault_run()["correct"] is False


def test_alpha_altered_fails(monkeypatch):
    from goblin_tpu_torch.integrators import sppm

    monkeypatch.setattr(sppm, "ALPHA", 0.75)
    assert fault_run()["correct"] is False


def test_drain_one_turn_short_fails(monkeypatch):
    """Each cell's drain stops a turn short: its last entry is taken out
    of the sorted entries. (Skipping only the fullest cell's last turn
    changed no pixel at 64 x 48 or 128 x 96: that entry is a deposit's
    eighth cell, where no visible point lies within the radius.)"""
    def short(drain, call, vp, radius, rows, e_hash, e_idx, *rest):
        last = torch.ones_like(e_hash, dtype=torch.bool)
        last[:-1] = e_hash[1:] != e_hash[:-1]
        e_hash = torch.where(last, 0x7FFFFFFF, e_hash)
        e_hash, order = torch.sort(e_hash, stable=True)
        return drain(vp, radius, rows, e_hash, e_idx[order], *rest)

    _drains(monkeypatch, short)
    assert fault_run()["correct"] is False


def test_emitted_a_chunk_short_fails(monkeypatch):
    from goblin_tpu_torch.integrators import sppm

    make = sppm.make_sppm

    def counted_short(scene, meta, *a, **k):
        sp = make(scene, meta, *a, **k)
        n_pix = meta.camera.film.x_res * meta.camera.film.y_res

        def iterate(state, it):
            sp.iterate(state, it)
            state["emitted"] -= min(sppm.PHOTON_CHUNK, n_pix)
            return state
        return sp._replace(iterate=iterate)

    monkeypatch.setattr(sppm, "make_sppm", counted_short)
    assert fault_run()["correct"] is False


@pytest.mark.parametrize("seed", [3000000101, 3000000102])
def test_control_fails_every_comparison(seed):
    """The reference in bfloat16 in the program's place fails every
    compared number (lit_share is a floor, not a comparison)."""
    cell = spec.Cell(CELL)
    ok, numbers = control_sppm.readings(CELL, seed, 3, "cpu", film=FILM)
    assert ok is False
    for name, limit in cell.traffic["check"]["limits"].items():
        if name != "lit_share":
            assert numbers[name] > limit, (name, numbers[name])


# --- on a card -------------------------------------------------------------

@pytest.mark.cuda
def test_iteration_syncs_only_at_the_drain_reads():
    """One full-size iteration under torch.cuda.set_sync_debug_mode("warn"):
    its synchronizing calls are the drain's reads, one a photon chunk."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from goblin_tpu_torch import telemetry
    from goblin_tpu_torch.integrators import sppm

    cell = spec.Cell(CELL)
    scene, meta, _ = render.load(cell, SEED, "cuda")
    with torch.inference_mode():
        sp = sppm.make_sppm(scene, meta)
        st = sp.new_state()
        sp.iterate(st, 0)  # first calls: libraries, caches
        torch.cuda.synchronize()
        reads = telemetry.counters.get("sppm.drain_reads", 0)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                sp.iterate(st, 1)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
    # (set_sync_debug_mode warns too, that the mode is a prototype)
    syncs = [w for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    n_chunks = -(-meta.camera.film.x_res * meta.camera.film.y_res
                 // sppm.PHOTON_CHUNK)
    assert n_chunks == 6
    assert telemetry.counters["sppm.drain_reads"] - reads == n_chunks
    assert len(syncs) == n_chunks
    # each in the drain's one read
    line = sppm._drain_turns.__code__.co_firstlineno
    for w in syncs:
        assert w.filename == sppm.__file__ and line < w.lineno < line + 8
