"""SPPM's light walk over many chunks at once (integrators/sppm.py): the
stepped iteration, whose walk takes all of an iteration's photons (or as
many whole chunks as walk_lanes allows), against the per-chunk loop built
from make_photon_passes' own deposit_chunk and vp_drain, bit for bit; the
walk's width from the free bytes; the walk's spans and counters.

This file imports neither JAX nor goblin_tpu.
"""

import dataclasses
import os

import pytest
import torch

from goblin_tpu_torch import telemetry
from goblin_tpu_torch.integrators import sppm
from goblin_tpu_torch.integrators.common import spp_grid
from goblin_tpu_torch.scene.loader import load_scene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# byte-equal to examples/bunny.json
SCENE = os.path.join(ROOT, "benchmarks", "scenes", "bunny", "bunny.json")
FILM = (64, 48)
CHUNK = 512  # 3,072 photons an iteration: 6 chunks
N_CHUNKS = 6
SEED = 3000000321  # above 2**31, as a benchmark run's seeds may be
ITS = (2, 3, 4)
KEYS = ("Ld_acc", "Ni", "Tau", "radius")


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


def _program(film=FILM):
    """bunny.json as shipped (depth 20) with radius 0.1, so hundreds of
    visible points gather."""
    scene, meta = load_scene(
        SCENE, {"seed": SEED, "initial_radius": 0.1}, device="cpu")
    spec = dataclasses.replace(meta.camera.film, x_res=film[0],
                               y_res=film[1])
    meta.camera = dataclasses.replace(meta.camera, film=spec)
    return scene, meta


def _per_chunk_iterations(scene, meta, its):
    """The iteration with a walk a chunk: each chunk's deposit_chunk (its
    walk and grid), then its drain."""
    st = sppm.make_sppm(scene, meta, chunk_size=CHUNK).new_state()
    max_len = int(meta.settings["max_ray_depth"])
    n_pix = FILM[0] * FILM[1]
    pixel_ids = torch.arange(n_pix, dtype=torch.int32)
    ray_pass = sppm.make_ray_pass(
        scene, meta, SEED, max_len,
        spp_grid(int(meta.settings["sample_per_pixel"])))
    deposit_chunk, vp_drain = sppm.make_photon_passes(
        scene, meta, SEED + 77, max_len, n_pix)
    for it in its:
        Ld_it, vp = ray_pass(pixel_ids, it)
        st["Ld_acc"] = st["Ld_acc"] + Ld_it
        radius, emitted = st["radius"], st["emitted"]
        bbox_min, inv_len, max_r = sppm.vp_cell_meta(vp, radius)
        Phi, Mi = torch.zeros((n_pix, 3)), torch.zeros(n_pix)
        for c in range(N_CHUNKS):
            ids = torch.arange(emitted + c * CHUNK, emitted + (c + 1) * CHUNK,
                               dtype=torch.int32)
            rows, e_hash, e_idx = deposit_chunk(ids, it, bbox_min, inv_len,
                                                max_r)
            Phi, Mi = vp_drain(vp, radius, rows, e_hash, e_idx, bbox_min,
                               inv_len, Phi, Mi)
        st["Ni"], st["Tau"], st["radius"] = sppm._update(
            st["Ni"], st["Tau"], radius, Phi, Mi, vp["tp"], vp["valid"])
        st["emitted"] = emitted + N_CHUNKS * CHUNK
    return st


@pytest.fixture(scope="module")
def per_chunk():
    with torch.inference_mode():
        return _per_chunk_iterations(*_program(), ITS)


@pytest.mark.parametrize("walk_chunks", [None, 2])
def test_walk_is_the_per_chunk_loop(per_chunk, monkeypatch, walk_chunks):
    """All six chunks in one walk, and walk_lanes held to two chunks
    (three walks): the state bit-equal to a walk a chunk, the drain still
    one read a chunk, the grid's spans a chunk's, a photon span a walk."""
    if walk_chunks is not None:
        monkeypatch.setattr(sppm, "walk_lanes",
                            lambda n_pix, cs, *a: walk_chunks * cs)
    walks = N_CHUNKS // (walk_chunks or N_CHUNKS)
    sp = sppm.make_sppm(*_program(), chunk_size=CHUNK)
    st = sp.new_state()
    telemetry.counters.clear()
    telemetry.start()
    with torch.inference_mode():
        for it in ITS:
            sp.iterate(st, it)
    telemetry.stop()
    for k in KEYS:
        assert torch.equal(st[k], per_chunk[k]), k
    n_pix = FILM[0] * FILM[1]
    assert st["emitted"] == per_chunk["emitted"] == len(ITS) * n_pix
    assert float(st["Ni"].sum()) > 100.0
    n = len(ITS)
    assert telemetry.counters["sppm.drain_reads"] == N_CHUNKS * n
    assert telemetry.counters["sppm.photon_walks"] == walks * n
    assert telemetry.counters["sppm.photons"] == n_pix * n
    names = [r[0] for r in telemetry.spans()]
    assert names.count("sppm.photon") == walks * n
    # the cell layout, and each chunk's hashing and sort and its lookup
    assert names.count("sppm.grid") == (1 + 2 * N_CHUNKS) * n
    assert names.count("sppm.drain") == N_CHUNKS * n


def test_one_walk_an_iteration_on_a_small_film():
    sp = sppm.make_sppm(*_program((32, 24)))
    telemetry.counters.clear()
    telemetry.start()
    with torch.inference_mode():
        st = sp.new_state()
        for it in ITS:
            sp.iterate(st, it)
    telemetry.stop()
    assert telemetry.counters["sppm.photon_walks"] == len(ITS)
    names = [r[0] for r in telemetry.spans()]
    assert names.count("sppm.photon") == len(ITS)


# bunny's card: 196,608 photons at depth 20 in chunks of 32,768; a chunk's
# walk holds 32,768 x (2 x 82 x 20 + 41 x 19) = 133,005,312 B
FULL, CS, DEPTH = 512 * 384, sppm.PHOTON_CHUNK, 20


@pytest.mark.parametrize("n_pix, free, lanes", [
    (FULL, None, FULL),  # the CPU: every chunk
    (FULL, 80e9, FULL),  # the walk fits
    (FULL, 4 * 2.5 * 133_005_312, 2 * CS),  # two chunks fit, not three
    (FULL, 4 * 3 * 133_005_312, 3 * CS),  # exactly three
    (FULL, 1e8, CS),  # less than a chunk fits: one chunk
    (FULL, 0, CS),
    (100_000, None, 4 * CS),  # chunks rounded up: the last one whole
    (100_000, 80e9, 4 * CS),
    (100_000, 4 * 3.5 * 133_005_312, 3 * CS),
    (768, None, 768),  # a film smaller than a chunk (cs = n_pix)
])
def test_walk_lanes(n_pix, free, lanes):
    cs = min(CS, n_pix)
    assert sppm.walk_lanes(n_pix, cs, DEPTH, free) == lanes
