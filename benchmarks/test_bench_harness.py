"""CPU tests of the benchmark's harness: its files, its arithmetic, a small
run of each cell's path, its refusals and its imports.

    python -m pytest benchmarks -q            # here, on the CPU
    python -m pytest benchmarks -q -m cuda    # on a machine with a card

Runs go through benchlib.harness.run with device "cpu" and a 32 x 24
film, which only the tests pass; the command line has no such option.
"""

import argparse
import glob
import io
import json
import os
import subprocess
import sys
import time
from contextlib import redirect_stdout

import pytest

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
sys.path[:0] = [p for p in (ROOT, BENCH) if p not in sys.path]

import torch  # noqa: E402

from benchlib import check, harness, spec, stats  # noqa: E402

FILM = (32, 24)
SEED = 3000000007  # above 2**31, as a run's seeds may be


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def small_run(workload, trace=0, seconds=1.0, seed=SEED):
    args = argparse.Namespace(workload=workload, seed=seed, seconds=seconds,
                              trace=trace)
    return harness.run(args, time.perf_counter(), device="cpu", film=FILM)


# --- the files -------------------------------------------------------------

def test_every_file_loads():
    for path in glob.glob(os.path.join(BENCH, "**", "*.json"),
                          recursive=True):
        with open(path) as f:
            json.load(f)
    for path in glob.glob(os.path.join(BENCH, "metrics", "*.py")):
        name = os.path.basename(path)[:-3]
        assert callable(spec.reader(name))


def test_every_cell_names_what_exists():
    b = bench()
    names = {m["name"] for m in b["end_to_end"] + b["per_layer"]}
    for w in b["workloads"]:
        cell = spec.Cell(w["name"])
        assert os.path.exists(cell.scene_path())
        assert hasattr(cell.entry(), "run")
        assert os.path.exists(os.path.join(ROOT, cell.config_entry["file"]))
        assert {"setup_s"} <= {m["name"] for m in cell.metrics(False)}
        assert len(cell.metrics(False)) >= 2 and cell.metrics(True)
    for name in names:
        assert os.path.exists(os.path.join(BENCH, "metrics", f"{name}.py"))
    cells = {w["name"] for w in b["workloads"]}
    for m in b["end_to_end"] + b["per_layer"]:
        assert set(m.get("workloads", [])) <= cells
        assert m["moves"] in {e["name"] for e in b["end_to_end"]} \
            if "moves" in m else True


# --- the arithmetic --------------------------------------------------------

def test_percentile_and_spread():
    v = list(range(1, 101))
    assert stats.percentile(v, 95) == 95
    assert stats.percentile([3.0], 95) == 3.0
    assert stats.percentile([5, 1, 4, 2, 3], 50) == 3
    # statistics.quantiles' default method on 1..8: 2.25, 4.5, 6.75
    assert stats.spread(list(range(1, 9))) == pytest.approx(4.5 / 4.5)


def test_union_busy_and_gaps():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6), (9.0, 12.0)]
    assert stats.union(iv) == [(0.0, 2.0), (3.0, 4.0), (9.0, 12.0)]
    # overlapping work counts once; the window clips
    assert stats.busy(iv, 0.0, 10.0) == pytest.approx(4.0)
    assert stats.gaps(iv, 0.0, 10.0) == [(2.0, 3.0), (4.0, 9.0)]
    assert stats.gaps([], 1.0, 2.0) == [(1.0, 2.0)]


def test_rate_and_idle_readers():
    class T:
        device_ops = [(0.0, 0.25, "k"), (0.1, 0.3, "k"), (0.5, 0.6, "Memcpy")]
        lo, hi, window_s = 0.0, 1.0, 1.0

        def busy_s(self):
            return stats.busy([(a, b) for a, b, _ in self.device_ops],
                              self.lo, self.hi)

    rec = {"kind": "render", "pass_s": [0.1, 0.2, 0.3, 0.4],
           "window_s": 2.0, "samples_per_pass": 500_000, "trace": T()}
    assert spec.reader("msamples_per_s")(rec) == pytest.approx(1.0)
    assert spec.reader("msamples_per_s.host_bound")(rec) == \
        pytest.approx(1.0)
    assert spec.reader("pass_p95_ms.host_bound")(rec) == pytest.approx(400.0)
    assert spec.reader("device_idle_share.render")(rec) == pytest.approx(60.0)
    # 0.4 s busy over two device-timed passes of half a million samples
    assert spec.reader("device_ms_per_msample")(rec) is None
    rec.update(device_busy_s=0.4, device_passes=2)
    assert spec.reader("device_ms_per_msample")(rec) == pytest.approx(400.0)


def test_bytes_bound_by_hand():
    # one launch of 1,000 lanes, 250 live, over 10 triangles:
    # 250 * 32 + 1,000 * 17 + 10 * 36 = 25,360 bytes
    assert stats.trace_bound_s([(1000, 250)], 10) == pytest.approx(
        25_360 / 3.35e12)
    rec = {"launch_lanes": [(1000, 250)], "n_triangles": 10,
           "trace": type("T", (), {
               "device_time": lambda self, k: 1e-6 if "wide" in k else 0.0
           })()}
    assert spec.reader("trace_roofline")(rec) == pytest.approx(
        100 * 25_360 / 3.35e12 / 1e-6)


def test_check_numbers():
    ref = torch.tensor([[1.0, 2.0, 0.5], [0.0, 0.0, 0.0], [4.0, 4.0, 4.0]])
    w = torch.tensor([1.0, 1.0, 2.0])
    n = check.compare(ref, w, ref, w)
    assert n["colour_err_median"] == 0.0 and n["colour_bad_share"] == 0.0
    assert n["lit_share"] == pytest.approx(2 / 3)
    off = ref.clone()
    off[2] *= 1.01
    n = check.compare(off, w, ref, w)
    assert n["colour_bad_share"] == pytest.approx(0.5)
    assert check.judge(n, {"colour_bad_share": 0.1})[0] is False
    nan = ref.clone()
    nan[0, 0] = float("nan")
    # a non-finite pixel counts as lit and as wrong
    assert check.compare(nan, w, ref, w)["colour_bad_share"] == \
        pytest.approx(0.5)


def test_pixels_follow_the_seed():
    a = check.pixels(SEED, 64, 48, 5, 4)
    assert (a == check.pixels(SEED, 64, 48, 5, 4)).all()
    assert not (len(a) == len(check.pixels(SEED + 1, 64, 48, 5, 4))
                and (a == check.pixels(SEED + 1, 64, 48, 5, 4)).all())
    assert a.min() >= 0 and a.max() < 64 * 48


# --- runs ------------------------------------------------------------------

def test_small_run_prints_the_contract_line():
    out = io.StringIO()
    result = small_run("bunny.pt")
    with redirect_stdout(out):
        harness.emit(result)
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert list(line)[-1] == "check"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(
        line)
    assert line["correct"] is True and line["attempted"] >= 1
    names = {m["name"] for m in spec.Cell("bunny.pt").metrics(False)}
    assert {"device_ms_per_msample", "setup_s"} <= names
    # the CPU has no device time to read
    assert set(line["metrics"]) == names - {"device_ms_per_msample"}
    for name in line["metrics"]:
        assert line["metrics"][name]["value"] > 0.0
    assert line["device"]["platform"] == "cpu"


def test_small_traced_run():
    result = small_run("bunny.pt", trace=1)
    assert result["correct"] is True
    m = result["metrics"]
    assert m["load_bake_s"]["value"] > 0.0
    assert m["msamples_per_s.host_bound"]["value"] > 0.0
    assert m["pass_p95_ms.host_bound"]["value"] > 0.0
    # the CPU has no device trace and the program counts no kernel
    # launches there (its plain versions run): those readers return nothing
    for name in ("trace_roofline", "kernels_per_msample.render",
                 "trace_launches_per_msample.render",
                 "device_idle_share.render"):
        assert name not in m
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


CHILD_RUN = """
import argparse, json, sys, time
sys.path[:0] = [{root!r}, {bench!r}]
import torch
torch.set_num_threads(2)
from benchlib import harness
if __name__ == "__main__":
    a = argparse.Namespace(workload={workload!r}, seed={seed}, seconds=1.0,
                           trace={trace})
    r = harness.run(a, time.perf_counter(), device="cpu", film={film!r})
    r.pop("_log")
    r.pop("breakdown", None)
    print(json.dumps(r))
"""


def child_run(workload, tmp_path, trace=0, film=FILM, env=None):
    """A small run in a process of its own: a process joins one process
    group in its life, as a run does."""
    script = tmp_path / "child_run.py"
    script.write_text(CHILD_RUN.format(root=ROOT, bench=BENCH,
                                       workload=workload, seed=SEED,
                                       trace=trace, film=film))
    p = subprocess.run([sys.executable, str(script)], capture_output=True,
                       text=True, timeout=600, env=env)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


def test_sharded_run_on_four_cpu_ranks(tmp_path):
    result = child_run("bunny.pt_x4", tmp_path, trace=1)
    assert result["correct"] is True
    assert result["metrics"]["scaling_efficiency.sharded"]["value"] > 0.0


def test_no_card_no_result():
    """The command line without CUDA: exit 1, nothing on standard
    output."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run(
        [sys.executable, os.path.join(BENCH, "run.py"), "--workload",
         "bunny.pt", "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert p.returncode == 1 and p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_no_jax_in_the_harness_process():
    small_run("bunny.pt")
    assert harness.forbidden_loaded() == []
    # names are compared whole: the port's name begins with the JAX
    # package's
    sys.modules["goblin_tpu_fake.sub"] = sys.modules["json"]
    try:
        assert harness.forbidden_loaded() == []
        sys.modules["goblin_tpu.sub"] = sys.modules["json"]
        assert harness.forbidden_loaded() == ["goblin_tpu"]
    finally:
        sys.modules.pop("goblin_tpu_fake.sub", None)
        sys.modules.pop("goblin_tpu.sub", None)


def test_no_source_imports_jax():
    for path in glob.glob(os.path.join(BENCH, "**", "*.py"), recursive=True):
        with open(path) as f:
            for line in f:
                words = line.split()
                if words[:1] in (["import"], ["from"]) and len(words) > 1:
                    top = words[1].split(".")[0]
                    assert top not in harness.FORBIDDEN, (path, line)


@pytest.mark.cuda
def test_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p = subprocess.run(
        [sys.executable, os.path.join(BENCH, "run.py"), "--workload",
         "bunny.pt", "--seed", str(SEED), "--seconds", "3", "--trace", "0"],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-2000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
    assert line["metrics"]["device_ms_per_msample"]["value"] > 0.0
