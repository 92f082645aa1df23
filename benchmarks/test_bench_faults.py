"""The check has to fail what it is there to catch: the control (the
reference in bfloat16 in the program's place) and the faults a render
cell can have, each planted under a run that goes through the rest of the
harness. The reference itself is held to the program lane by lane.

CPU, 32 x 24 films; `python -m pytest benchmarks -q`.
"""

import argparse
import os
import sys
import time

import pytest

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
sys.path[:0] = [p for p in (ROOT, BENCH) if p not in sys.path]

import torch  # noqa: E402

import control  # noqa: E402
from benchlib import harness  # noqa: E402

FILM = (32, 24)
SEED = 3000000099


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def run(workload="bunny.pt", seconds=1.0, film=FILM):
    args = argparse.Namespace(workload=workload, seed=SEED, seconds=seconds,
                              trace=0)
    return harness.run(args, time.perf_counter(), device="cpu", film=film)


@pytest.mark.parametrize("seed", [3000000101, 3000000102, 3000000103])
def test_control_fails(seed):
    ok, numbers = control.readings("bunny.pt", seed, 4, "cpu", film=FILM)
    assert ok is False
    assert numbers["colour_err_median"] > 1e-2


def test_sound_run_passes():
    assert run()["correct"] is True


def _wrap_li(monkeypatch, alter):
    from goblin_tpu_torch.integrators import path

    make = path.make_li

    def make_li(meta, *a, **k):
        li = make(meta, *a, **k)
        return lambda *args: alter(li(*args))

    monkeypatch.setattr(path, "make_li", make_li)


def test_state_unchanged_fails(monkeypatch):
    from goblin_tpu_torch.camera import film
    from goblin_tpu_torch.integrators import common

    make = common.make_render_pass

    def frozen(scene, meta, *a, **k):
        rp, n = make(scene, meta, *a, **k)
        scratch = film.new_film(meta.camera.film, "cpu")

        def unchanged(color, weight, s):
            rp(*scratch, s)  # the work is done, the film is left as it was
            return color, weight
        return unchanged, n

    monkeypatch.setattr(common, "make_render_pass", frozen)
    assert run()["correct"] is False


def test_half_the_batch_left_out_fails(monkeypatch):
    def half(L):
        L = L.clone()
        L[L.shape[0] // 2:] = 0.0
        return L

    _wrap_li(monkeypatch, half)
    assert run()["correct"] is False


def test_answer_altered_fails(monkeypatch):
    _wrap_li(monkeypatch, lambda L: L * 1.01)
    assert run()["correct"] is False


LOCAL_ONLY = """
import torch
from goblin_tpu_torch.parallel import mesh as pm


def local_only(self, t):
    out = torch.zeros((self.world,) + tuple(t.shape), dtype=t.dtype,
                      device=t.device)
    out[self.rank] = t
    return out


pm.Mesh.all_gather = local_only
"""


def test_exchange_left_out_fails(tmp_path):
    """Every rank keeps its own share of each pass and zeros for the other
    ranks': the fault goes into every rank's process through a
    sitecustomize module on its path."""
    from test_bench_harness import child_run

    site = tmp_path / "site"
    site.mkdir()
    (site / "sitecustomize.py").write_text(LOCAL_ONLY)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(site), ROOT, os.environ.get("PYTHONPATH", "")]))
    # one chunk of 12,288 pixels, 3,072 a rank (a smaller film fits in
    # rank 0's share of its one padded chunk of 4,096)
    result = child_run("bunny.pt_x4", tmp_path, film=(128, 96), env=env)
    assert result["correct"] is False


def test_reference_follows_the_program_lane_by_lane():
    """The plain reference's radiance equals the program's on every lane
    of two passes, up to rounding."""
    import dataclasses

    from goblin_tpu_torch.integrators import common, path
    from goblin_tpu_torch.scene.loader import load_scene
    from benchlib import render, spec
    from plainref import pathtrace, scene as rscene

    cell = spec.Cell("bunny.pt")
    ov = render.settings(cell, SEED)
    sc, meta = load_scene(cell.scene_path(), ov, device="cpu")
    fs = dataclasses.replace(meta.camera.film, x_res=FILM[0], y_res=FILM[1])
    meta.camera = dataclasses.replace(meta.camera, film=fs)
    li = path.make_li(meta)
    ids = common.crop_pixel_ids(fs, "cpu")
    spp = int(cell.traffic["spp"])
    ren = pathtrace.Renderer(rscene.load(cell.scene_path(), ov, film=FILM),
                             "cpu")
    with torch.inference_mode():
        for s in (0, 517):
            ray = common.camera_rays(meta.camera, SEED, ids, s,
                                     common.spp_grid(spp))
            Lp = li(sc, meta, ray, ids, s, SEED)
            g = pathtrace.grid(spp)
            Lr, _, _ = ren.li(SEED, ids.long(),
                              torch.full((ids.numel(),), s), g, g * g, 5)
            err = (Lr - Lp).abs().amax(-1) / (Lp.abs().amax(-1) + 1e-6)
            assert float(Lp.amax()) > 0.0
            assert float((err > 1e-4).float().mean()) <= 0.01
