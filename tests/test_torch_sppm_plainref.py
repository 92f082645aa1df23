"""goblin_tpu_torch's SPPM against the benchmark's plain SPPM reference
(benchmarks/plainref_sppm) on the CPU, and the stepped driver: bunny.json
as shipped at a 32 x 24 film, its state at every pixel and its film; the
stepped iteration against render_sppm and a resumed render; the drain's
turn counter; the SPPM spans inside the pass.

This file imports neither JAX nor goblin_tpu.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from goblin_tpu_torch import telemetry
from goblin_tpu_torch.camera import film as film_mod
from goblin_tpu_torch.integrators import sppm
from goblin_tpu_torch.scene.loader import load_scene
from goblin_tpu_torch.shading import bsdf as bx

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmarks")
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

from plainref_sppm import sppm as rsppm  # noqa: E402

# byte-equal to examples/bunny.json
SCENE = os.path.join(BENCH, "scenes", "bunny", "bunny.json")
FILM = (32, 24)
SEED = 3000000123  # above 2**31, as a benchmark run's seeds may be
IT0, N_IT = 2, 3


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def fresh_telemetry():
    saved = dict(telemetry.counters)
    telemetry.stop()
    telemetry.clear()
    yield
    telemetry.stop()
    telemetry.clear()
    telemetry.counters.clear()
    telemetry.counters.update(saved)


def _overrides(depth, radius=0.01):
    return {"sample_per_pixel": 100, "seed": SEED, "max_ray_depth": depth,
            "initial_radius": radius}


def _program(overrides):
    scene, meta = load_scene(SCENE, overrides, device="cpu")
    spec = dataclasses.replace(meta.camera.film, x_res=FILM[0],
                               y_res=FILM[1])
    meta.camera = dataclasses.replace(meta.camera, film=spec)
    return scene, meta


def _iterate(sp, its):
    st = sp.new_state()
    with torch.inference_mode():
        for it in its:
            sp.iterate(st, it)
    return st


@pytest.mark.parametrize("depth, radius", [(20, 0.01), (5, 0.01),
                                           (20, 0.1)])
def test_program_against_the_reference(depth, radius):
    """Iterations 2-4 of a fresh state, the scene as shipped (radius 0.01:
    a few pixels gather) and with radius 0.1 (hundreds of gathers)."""
    ov = _overrides(depth, radius)
    sp = sppm.make_sppm(*_program(ov))
    st = _iterate(sp, range(IT0, IT0 + N_IT))
    with torch.inference_mode():
        color, weight = sp.film(st, N_IT)
    ren = rsppm.Renderer(rsppm.load(SCENE, ov, film=FILM), "cpu")
    targets = np.arange(FILM[0] * FILM[1])
    with torch.no_grad():
        rc, rw, ref, sources = rsppm.film_at(ren, SEED, targets, IT0, N_IT)
    # every pixel is its own source: the state lines up pixel by pixel
    assert (sources == targets).all()
    assert st["emitted"] == ref["emitted"] == N_IT * FILM[0] * FILM[1]
    # N and the radius exactly: both follow from the gathered counts by
    # the same arithmetic, so a deposit that one side gathers and the
    # other does not shows here
    assert torch.equal(st["Ni"], ref["Ni"])
    assert torch.equal(st["radius"], ref["radius"])
    assert float(st["Ni"].sum()) > (100.0 if radius > 0.05 else 1.0)
    # Ld and tau within 1e-5 rel: the reference sums a gather's deposits
    # in another order, and its radical inverses in float64
    for key in ("Ld_acc", "Tau"):
        torch.testing.assert_close(st[key], ref[key], rtol=1e-5, atol=1e-7)
    assert float(st["Ld_acc"].amax()) > 0.0
    # the film within 1e-5 rel: the reference accumulates it in float64
    torch.testing.assert_close(color.reshape(-1, 3).double(), rc,
                               rtol=1e-5, atol=1e-9)
    torch.testing.assert_close(weight.reshape(-1).double(), rw, rtol=1e-5,
                               atol=0.0)


def test_stepped_driver_is_render_sppm(tmp_path):
    """render_sppm, the stepped iteration with the film, and a render
    resumed from a checkpoint after one step: bit-equal images."""
    scene, meta = _program(_overrides(5))
    full = sppm.render_sppm(scene, meta, iterations=3)
    sp = sppm.make_sppm(scene, meta, iterations=3)
    st = _iterate(sp, range(3))
    with torch.inference_mode():
        stepped = film_mod.to_image(*sp.film(st, 3))
    assert torch.equal(full, stepped) and float(full.mean()) > 0.0
    part = _iterate(sp, range(1))
    assert part["it"] == 1
    path = str(tmp_path / "sppm.npz")
    sppm.save_sppm_state(path, part)
    resumed = sppm.render_sppm(scene, meta, iterations=3,
                               state=sppm.load_sppm_state(path))
    assert torch.equal(full, resumed)


def test_drain_turns_counter_counts_the_turns(monkeypatch):
    """sppm.drain_turns is the turns the drain ran: one BSDF evaluation a
    turn, counted here inside the drain's span; one read a drain."""
    sp = sppm.make_sppm(*_program(_overrides(20, 0.1)))
    evals = []
    orig = bx.bsdf_eval

    def counted(*a, **k):
        if telemetry._open and telemetry._open[-1] == "sppm.drain":
            evals.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(bx, "bsdf_eval", counted)
    telemetry.counters.clear()
    telemetry.start()
    _iterate(sp, range(IT0, IT0 + N_IT))
    telemetry.stop()
    turns = telemetry.counters["sppm.drain_turns"]
    assert turns == len(evals) > N_IT
    assert telemetry.counters["sppm.drain_reads"] == N_IT


def test_spans_nest_under_render_pass():
    scene, meta = _program(_overrides(5))
    max_len = 5
    sp = sppm.make_sppm(scene, meta)
    telemetry.counters.clear()
    telemetry.start()
    _iterate(sp, [IT0])
    telemetry.stop()
    recs = telemetry.spans()
    (outer,) = [r for r in recs if r[0] == "render.pass"]
    names = [r[0] for r in recs]
    n_pix = FILM[0] * FILM[1]
    n_chunks = 1  # the film's 768 photons are one chunk
    assert names.count("sppm.ray") == max_len
    assert names.count("sppm.photon") == n_chunks
    assert names.count("sppm.drain") == n_chunks
    assert names.count("sppm.update") == 1
    # the cell layout, and each chunk's hashing and sort and its lookup
    assert names.count("sppm.grid") == 1 + 2 * n_chunks
    parents = {"sppm.ray": {"render.pass"}, "sppm.photon": {"render.pass"},
               "sppm.drain": {"render.pass"}, "sppm.update": {"render.pass"},
               "sppm.grid": {"render.pass", "sppm.drain"}}
    for name, a, b, parent in recs:
        assert outer[1] <= a <= b <= outer[2]
        if name in parents:
            assert parent in parents[name]
    own = telemetry.self_times(recs)
    assert {telemetry.STAGES[n] for n in parents} == {
        "shade", "photon", "grid", "drain", "splat"}
    assert set(parents) <= set(own)
    assert telemetry.counters["render.samples"] == n_pix
    assert telemetry.counters["sppm.photons"] == n_pix
    assert telemetry.counters["sppm.drain_reads"] == n_chunks
