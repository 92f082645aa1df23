"""goblin_tpu_torch/bench.py and bench_torch.py, the port's counterparts of
bench.py, bench_methods.py, bench_scaling.py and bench_trace.py, on the CPU
at 16 x 12 (depth 5, one chunk): the pt line's census against make_li's
and its rate arithmetic against bench.py's, a chunk's 8 trace calls, the
methods' lane-ray counts against bench_methods.py's, the captured
wavefront classes against the census, joined over chunks, and their replay
against the recorded results at every width, a trace's bound with dead
lanes, the scaling line at world 1 and world 2 over gloo, and
bench_torch.py's refusal to run without a card or with --wide off pt.

The census on the card at 48 x 36 against the CPU's is marked cuda. This
file imports neither JAX nor goblin_tpu at its top, so it runs on a machine
without them:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_bench.py
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import bench_torch
from goblin_tpu_torch import bench
from goblin_tpu_torch.camera import film as film_mod
from goblin_tpu_torch.integrators import common
from goblin_tpu_torch.integrators.path import make_li
from goblin_tpu_torch.ops import trace as tt
from goblin_tpu_torch.parallel import mesh as tmesh
from goblin_tpu_torch.parallel import multihost
from goblin_tpu_torch.scene import intersect as scn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILM = (16, 12)
N_PIX = FILM[0] * FILM[1]
# bench.py's line, less vs_baseline and trace_backend
BENCH_PY_FIELDS = ("metric", "value", "unit", "useful_mrays",
                   "dispatched_mrays", "dispatched_rays_per_lane_sample",
                   "shadow_fraction_per_bounce", "cont_fraction_per_bounce",
                   "max_leaf", "spp", "depth", "seconds_per_pass")
# bench_methods.py's lane-rays at (spp 2, 512 x 384, depth 5)
FULL_SIZE_LANE_RAYS = {"sppm": 5_505_024, "bdpt": 13_762_560,
                       "light_tracing": 3_932_160}
CLASSES = ["primary", "shadow1", "continuation1", "shadow2",
           "continuation2", "shadow3", "continuation3", "shadow4"]


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """Two intra-op threads, as test_torch_textures.few_torch_threads: the
    suite runs in several worker processes on few cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pt_bunny():
    return bench.load_bunny(bench.PT_SETTINGS, "cpu", film=FILM)


@pytest.fixture(scope="module")
def pt_line(pt_bunny):
    return bench.run_pt(*pt_bunny)


@pytest.fixture(scope="module")
def waves(pt_bunny):
    return bench.capture_wavefronts(*pt_bunny)


def _census(scene, meta, n_grid=2):
    """make_li(meta, with_stats=True) over the whole film in one batch."""
    ids = torch.arange(N_PIX, dtype=torch.int32)
    ray = common.camera_rays(meta.camera, 0, ids, 0, n_grid)
    _, (cons, cont) = make_li(meta, with_stats=True)(scene, meta, ray, ids,
                                                     0, 0)
    return cons.tolist(), cont.tolist()


def test_pt_line_census_equals_make_li(pt_bunny, pt_line):
    """The line's census fractions are make_li(with_stats=True)'s on the
    same film (test_torch_slice.py::test_census_matches_goblin_tpu holds
    that census to goblin_tpu's), and its fields are bench.py's."""
    cons, cont = _census(*pt_bunny)
    assert pt_line["shadow_fraction_per_bounce"] == [a / N_PIX for a in cons]
    assert pt_line["cont_fraction_per_bounce"] == [a / N_PIX for a in cont]
    assert len(cons) == 4 and cont[-1] == 0 and min(cons) > 0
    for key in BENCH_PY_FIELDS + ("trace_wide", "trace_launches_per_pass"):
        assert key in pt_line, key
    assert "vs_baseline" not in pt_line and "trace_backend" not in pt_line
    assert pt_line["metric"] == "bunny_path_trace_throughput"
    assert pt_line["trace_wide"] == 8 and pt_line["max_leaf"] == 32
    assert (pt_line["spp"], pt_line["depth"]) == (4, 5)
    # the CPU runs the plain versions: no kernel launched
    assert pt_line["trace_launches_per_pass"] == 0


def test_pt_line_rates_are_bench_py_arithmetic(pt_bunny, pt_line):
    """bench.py:86-103 on the line's own seconds and census: 9 lane-rays a
    lane-sample, 8 dispatched (bunny's spot light is a delta light)."""
    cons, cont = _census(*pt_bunny)
    dt = pt_line["seconds_per_pass"] * 4
    rays_per_lane = 1 + 2 * (5 - 1)
    disp_per_lane = rays_per_lane - 1
    assert pt_bunny[1].all_delta_lights
    assert pt_line["dispatched_rays_per_lane_sample"] == disp_per_lane == 8
    assert pt_line["value"] == pytest.approx(
        4 * N_PIX * rays_per_lane / dt / 1e6, rel=1e-12)
    assert pt_line["useful_mrays"] == pytest.approx(
        4 * (N_PIX + sum(cons) + sum(cont)) / dt / 1e6, rel=1e-12)
    assert pt_line["dispatched_mrays"] == pytest.approx(
        4 * N_PIX * disp_per_lane / dt / 1e6, rel=1e-12)


@pytest.mark.parametrize("all_delta", [True, False])
def test_pt_rates(all_delta):
    """pt_rates at a second size: 7 lane-rays at depth 4, one fewer
    dispatched only where every light is a delta light."""
    r = bench.pt_rates(100, 3, 4, all_delta, [50, 20, 5], [80, 30, 0], 2.0)
    assert r["value"] == pytest.approx(3 * 100 * 7 / 2.0 / 1e6)
    assert r["useful_mrays"] == pytest.approx(3 * 285 / 2.0 / 1e6)
    assert r["dispatched_rays_per_lane_sample"] == (6 if all_delta else 7)
    assert r["shadow_fraction_per_bounce"] == [0.5, 0.2, 0.05]
    assert r["cont_fraction_per_bounce"] == [0.8, 0.3, 0.0]


@pytest.mark.parametrize("wide", bench.WIDTHS)
def test_a_chunk_makes_eight_trace_calls(monkeypatch, wide):
    """1 primary, 4 shadow and 3 continuation calls a chunk (the last
    bounce's continuation peeled), counted by wrapping ops.trace.trace and
    trace_bin where the scene's intersect calls them."""
    scene, meta = bench.load_bunny(bench.PT_SETTINGS, "cpu", film=FILM,
                                   trace_wide=wide)
    calls = []

    def counted(fn):
        def wrapper(*args, **kw):
            calls.append(kw.get("any_hit", False))
            return fn(*args, **kw)
        return wrapper

    monkeypatch.setattr(scn, "trace", counted(tt.trace))
    monkeypatch.setattr(scn, "trace_bin", counted(tt.trace_bin))
    with torch.inference_mode():
        render_pass, _ = common.make_render_pass(scene, meta, make_li(meta),
                                                 4, 0, bench.CHUNK)
        render_pass(*film_mod.new_film(meta.camera.film, "cpu"), 0)
    assert len(calls) == 8
    assert calls == [False] + [True, False] * 3 + [True]


@pytest.mark.parametrize("method", bench.METHODS)
def test_method_lane_rays(method):
    """bench_methods.py's table at (spp 2, 196,608 pixels, depth 5), and its
    formulas at an odd size."""
    assert bench.method_lane_rays(method, 2, 512 * 384, 5) == \
        FULL_SIZE_LANE_RAYS[method]
    spp, n_pix, d = 3, 35 * 27, 7
    want = {"sppm": spp * n_pix * ((1 + 2 * (d - 1)) + d),
            "bdpt": spp * n_pix * (2 * d + d * d),
            "light_tracing": spp * n_pix * 2 * d}[method]
    assert bench.method_lane_rays(method, spp, n_pix, d) == want


@pytest.mark.parametrize("method", bench.METHODS)
def test_method_line(method):
    """One method's line at 16 x 12: the lane-rays, the renderer's own
    chunk (SPPM 32,768 photons, BDPT 65,536 camera samples, light tracing
    16,384 paths), no launch on the CPU."""
    scene, meta = bench.load_bunny(bench.method_settings(method), "cpu",
                                   film=FILM)
    line = bench.run_method(method, scene, meta)
    assert line["metric"] == f"bunny_{method}_throughput"
    assert (line["spp"], line["depth"]) == (2, 5)
    assert line["lane_rays"] == bench.method_lane_rays(method, 2, N_PIX, 5)
    assert line["value"] == pytest.approx(
        line["lane_rays"] / line["seconds"] / 1e6)
    assert line["chunk"] == {"sppm": 1 << 15, "bdpt": 1 << 16,
                             "light_tracing": 1 << 14}[method]
    assert line["trace_launches"] == 0


def test_captured_classes_equal_the_census(pt_bunny, waves):
    """The frame's classes in call order, each the frame's lanes, with the
    census's live lanes: every primary, the shadow rays considered and the
    continuation rays traced of each bounce; dead lanes at mint 3e38,
    maxt 0."""
    cons, cont = _census(*pt_bunny)
    assert [w["name"] for w in waves] == CLASSES
    assert all(w["o"].shape == (N_PIX, 3) for w in waves)
    live = {w["name"]: bench.live_lanes(w) for w in waves}
    assert live["primary"] == N_PIX
    for b in range(4):
        assert live[f"shadow{b + 1}"] == cons[b]
    for b in range(3):
        assert live[f"continuation{b + 1}"] == cont[b]
    for w in waves:
        dead = ~(w["maxt"] > w["mint"])
        assert bool((w["mint"][dead] == 3e38).all())
        assert bool((w["maxt"][dead] == 0).all())
        assert w["any_hit"] == w["name"].startswith("shadow")


def test_capture_joins_the_chunks_of_the_frame(pt_bunny, waves):
    """Captured in three chunks of 64 pixels, each class is the one-chunk
    capture's: its calls of every chunk joined in pixel order."""
    parts = bench.capture_wavefronts(*pt_bunny, chunk=64)
    assert [w["name"] for w in parts] == CLASSES
    for a, b in zip(parts, waves):
        assert a["any_hit"] == b["any_hit"]
        for key in ("o", "d", "mint", "maxt"):
            assert torch.equal(a[key], b[key]), (a["name"], key)
        for x, y in zip(a["result"], b["result"]):
            assert torch.equal(x, y), a["name"]


@pytest.mark.parametrize("live", [1000, 250, 0])
def test_bound_counts_a_dead_lane_by_its_interval(live):
    """A live lane's bytes are its 32 B of ray, a dead lane's only its
    mint and maxt (8 B); every lane writes its 17 B of result; the tables
    once. The operations are the tests' flop; the larger time bounds."""
    b = bench.bound(1000, 5000, 10, 20, 1.0, live=live)
    n_bytes = live * 32 + (1000 - live) * 8 + 1000 * 17 + 5000
    assert b["bound_counts"]["bytes"] == n_bytes
    assert b["bound_counts"]["flop"] == 10 * 25 + 20 * 53
    assert b["bound_ms"] == pytest.approx(max(n_bytes / 3.35e12,
                                              1310 / 67e12) * 1e3)
    assert b["bound_by"] == "bytes"
    assert b["roofline_share"] == b["bound_ms"]
    assert bench.bound(1000, 5000, 10, 20, 1.0) == \
        bench.bound(1000, 5000, 10, 20, 1.0, live=1000)


def test_replay_gives_back_the_recorded_results(pt_bunny, waves):
    """trace_plain on each captured class returns what the render's call
    returned."""
    scene, _ = pt_bunny
    for w in waves:
        got = tt.trace_plain(scene, *bench.rays(w), any_hit=w["any_hit"])
        for a, b in zip(got, w["result"]):
            assert torch.equal(a, b), w["name"]


@pytest.mark.parametrize("wide", (4, 1))
def test_replay_at_other_widths_agrees_with_width_8(waves, wide):
    """Each class through its own bake at width 4 and 1: hit masks equal
    and t within T_RTOL of width 8's; the census of the walk's work."""
    scene, _ = bench.load_bunny(bench.PT_SETTINGS, "cpu", film=FILM,
                                trace_wide=wide)
    for w in waves:
        res = bench.replay(scene, w, wide)
        assert bench.results_agree(res, w["result"], w["any_hit"]) == \
            (True, True), w["name"]
        box, tri = bench.replay_work(scene, w, wide)
        assert box > 0 and tri > 0
    assert sum(scene[k].numel() for k in bench.table_names(wide)) > 0


def test_scaling_line_at_world_1():
    scene, meta = bench.load_bunny(bench.scaling_settings(), "cpu", film=FILM)
    line, images = bench.run_scaling(scene, meta, tmesh.make_mesh(
        device="cpu"), chunk=64)
    assert line["world"] == 1 and line["unsharded_vs_mesh_maxdiff"] == 0.0
    assert line["mesh1_mrays"] > 0 and "efficiency_1" not in line
    assert line["sharding_overhead"] == pytest.approx(
        line["seconds_mesh1"] / line["seconds_unsharded"])
    assert images["unsharded"].shape == (12, 16, 3)


SCALING_CHILD = textwrap.dedent("""
    import json, sys
    import numpy as np, torch
    from goblin_tpu_torch import bench
    from goblin_tpu_torch.parallel import mesh as pm, multihost

    torch.set_num_threads(1)
    out = sys.argv[1]
    assert multihost.init_from_env(device="cpu"), "no process group"
    mesh = pm.make_mesh(2, device="cpu")
    scene, meta = bench.load_bunny(bench.scaling_settings(), "cpu",
                                   film=(16, 12))
    line, images = bench.run_scaling(scene, meta, mesh, chunk=64)
    np.savez(out + f".r{mesh.rank}.npz", line=json.dumps(line), **images)
    torch.distributed.destroy_process_group()
""")


def test_scaling_world_2_over_gloo_against_world_1(tmp_path):
    """bench_scaling.py's fake-mesh check on the port: two gloo ranks'
    sharded image against the world-1 image within 1e-5, and rank 0's line
    with mesh2_mrays and efficiency_2."""
    from test_torch_sharded import TIMEOUT

    script = tmp_path / "child.py"
    script.write_text(SCALING_CHILD)
    out = str(tmp_path / "out")
    results = multihost.launch_local(
        2, [str(script), out], port=multihost.free_port(), timeout=TIMEOUT,
        env_extra={"PYTHONPATH": REPO + os.pathsep
                   + os.environ.get("PYTHONPATH", "")})
    for rc, log in results:
        assert rc == 0, f"child failed:\n{log[-3000:]}"
    ranks = [dict(np.load(out + f".r{r}.npz")) for r in range(2)]
    scene, meta = bench.load_bunny(bench.scaling_settings(), "cpu", film=FILM)
    _, one = bench.run_scaling(scene, meta, tmesh.make_mesh(device="cpu"),
                               chunk=64)
    for r in ranks:
        np.testing.assert_allclose(r["mesh"], one["mesh"], atol=1e-5)
        np.testing.assert_allclose(r["unsharded"], one["unsharded"], atol=0)
    line = json.loads(str(ranks[0]["line"]))
    assert line["world"] == 2 and line["mesh2_mrays"] > 0
    assert line["unsharded_vs_mesh_maxdiff"] <= 1e-5
    assert line["efficiency_2"] == pytest.approx(
        line["seconds_unsharded"] / (2 * line["seconds_mesh2"]))


@pytest.mark.parametrize("command", bench_torch.COMMANDS)
def test_bench_torch_refuses_without_a_card(monkeypatch, capsys, command):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench_torch.main([command]) != 0
    out, err = capsys.readouterr()
    assert not any(line.startswith("{") for line in out.splitlines())
    assert "CUDA is not available" in err


@pytest.mark.parametrize("command", ("methods", "scaling", "trace"))
def test_bench_torch_takes_a_width_for_pt_only(capsys, command):
    """--wide sets pt's bake; methods and scaling trace at width 8 and
    trace at every width, so the flag is refused there before any work."""
    with pytest.raises(SystemExit) as exc:
        bench_torch.main([command, "--wide", "4"])
    assert exc.value.code != 0
    out, err = capsys.readouterr()
    assert out == "" and "--wide applies to pt only" in err


def test_bench_imports_neither_jax_nor_goblin_tpu(tmp_path):
    """A fresh interpreter imports goblin_tpu_torch.bench and bench_torch,
    takes the census and a captured class at 8 x 6 on the CPU, and never
    imports jax or goblin_tpu."""
    script = textwrap.dedent("""
        import sys
        import bench_torch
        from goblin_tpu_torch import bench
        scene, meta = bench.load_bunny(bench.PT_SETTINGS, "cpu", film=(8, 6))
        shadow, cont = bench.pt_census(scene, meta)
        assert len(shadow) == len(cont) == 4
        waves = bench.capture_wavefronts(scene, meta)
        assert waves[0]["name"] == "primary" and len(waves) == 8
        assert bench_torch.COMMANDS == ("pt", "methods", "scaling", "trace")
        bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
               or m == "goblin_tpu" or m.startswith("goblin_tpu.")]
        assert not bad, bad
        print("OK")
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", script], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "OK"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("wide", bench.WIDTHS)
def test_census_on_the_card_equals_the_cpu(cuda, wide):
    """The pt census at 48 x 36 through the kernel of each width equals the
    CPU's: integer counts, and the kernels are bit-equal to the plain
    versions."""
    counts = [bench.pt_census(*bench.load_bunny(
        bench.PT_SETTINGS, device, film=(48, 36), trace_wide=wide))
        for device in ("cpu", cuda)]
    assert counts[0] == counts[1]
    assert min(counts[0][0]) > 0
