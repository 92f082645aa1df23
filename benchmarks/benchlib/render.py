"""The parts of a render cell that both render entries share: the window of
passes, the traced passes and their replay, and the reference's check.

A pass renders one stratified camera sample for every pixel of the film
and ends in torch.cuda.synchronize(): progressive rendering reads each
pass's film. Warm-up passes take sample indices 0 .. warmup - 1 on a film
of their own; the window's passes continue from there on a fresh film,
which is the film the check reads; the device-timed passes and, in a
traced run, the traced passes follow on scratch films.
"""

from __future__ import annotations

import contextlib
import time

import torch

from . import check, stats
from .profile import profile

def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def span(name):
    from torch.profiler import record_function

    return record_function(name)


def spanned(li):
    """li with a `chunk` range around each call, for the traced passes."""
    def li_chunk(*args):
        with span("chunk"):
            return li(*args)
    return li_chunk


def settings(cell, seed):
    """The scene's render_setting overrides of a run: the configuration's,
    the traffic's samples a pixel and the seed."""
    out = dict(cell.config.get("render_setting", {}))
    out.update(sample_per_pixel=int(cell.traffic["spp"]), seed=int(seed))
    return out


def load(cell, seed, device, film=None):
    """The program's scene on device, timed by the harness's `load` span
    -> (scene, meta, seconds). film (x_res, y_res) resizes the film (the
    tests' small runs)."""
    import dataclasses

    from goblin_tpu_torch.scene.loader import load_scene

    a = time.perf_counter()
    with span("load"):
        scene, meta = load_scene(cell.scene_path(), settings(cell, seed),
                                 device=device,
                                 trace_wide=int(cell.traffic["trace_width"]))
    sync(device)
    seconds = time.perf_counter() - a
    if film is not None:
        spec = dataclasses.replace(meta.camera.film, x_res=film[0],
                                   y_res=film[1])
        meta.camera = dataclasses.replace(meta.camera, film=spec)
    return scene, meta, seconds


def window(step, s0, seconds, device, stop=None):
    """Run step(s) for s = s0, s0 + 1, ... until `seconds` have passed at
    a pass's end -> (seconds a pass, the window's seconds). stop(done)
    makes the decision where every rank has to agree on it."""
    times = []
    s = s0
    t0 = time.perf_counter()
    while True:
        a = time.perf_counter()
        step(s)
        sync(device)
        b = time.perf_counter()
        times.append(b - a)
        s += 1
        done = b - t0 >= seconds
        if (stop(done) if stop is not None else done):
            break
    return times, time.perf_counter() - t0


def device_busy_s(step, s0, n, device):
    """The device's busy seconds over n whole passes step(s), s = s0 ..
    s0 + n - 1, profiled with device activity only: the union of the
    intervals of its kernels, copies and sets, so overlapping work counts
    once. NCCL's kernels are left out: a collective runs on the device
    for as long as it waits for the slowest rank, which is the hosts'
    time, not the device's work. None without a CUDA device."""
    if torch.device(device).type != "cuda":
        return None
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    sync(device)
    with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
        for s in range(s0, s0 + n):
            step(s)
        sync(device)
    iv = [(e.start_ns() * 1e-9, e.end_ns() * 1e-9)
          for e in prof.profiler.kineto_results.events()
          if e.device_type() == DeviceType.CUDA
          and "nccl" not in e.name().lower()]
    return sum(b - a for a, b in stats.union(iv))


@contextlib.contextmanager
def counting_lanes(lanes):
    """Record (lanes, live lanes) of every trace launch the program makes
    inside the block: its trace entry is wrapped by name, as the module
    that calls it looks it up. A lane is live where mint <= maxt."""
    from goblin_tpu_torch.scene import intersect as scn

    orig = scn.trace_rays

    def traced(scene, meta, o, d, mint, maxt, any_hit=False):
        lanes.append((mint.numel(), (mint <= maxt).sum()))
        return orig(scene, meta, o, d, mint, maxt, any_hit=any_hit)

    scn.trace_rays = traced
    try:
        yield
    finally:
        scn.trace_rays = orig


def traced_passes(make_pass, s0, n, device, new_film):
    """Profile n whole passes from sample index s0 on a scratch film, then
    replay the same passes (the same samples, so the same rays) counting
    each trace launch's live lanes -> rec entries."""
    from goblin_tpu_torch.ops import trace as ops_trace

    step = make_pass(True)
    film = new_film()
    sync(device)
    ops_trace.reset_launches()
    t = []

    def body():
        for s in range(s0, s0 + n):
            a = time.perf_counter()
            with span("pass"):
                step(film, s)
                sync(device)
            t.append(time.perf_counter() - a)

    trace = profile(body)
    launches = sum(ops_trace.launches.values())
    lanes = []
    plain = make_pass(False)
    film = new_film()
    with counting_lanes(lanes):
        for s in range(s0, s0 + n):
            plain(film, s)
    sync(device)
    return {"trace": trace, "traced_passes": n, "traced_pass_s": t,
            "trace_launches": launches,
            "launch_lanes": [(int(a), int(b)) for a, b in lanes]}


def reference_check(cell, seed, film, ids, color, weight, s0, n_pass,
                    device):
    """The reference's film at the checked pixels over passes s0 ..
    s0 + n_pass - 1, compared with the program's -> (correct, rows,
    numbers, reference seconds, triangles)."""
    from plainref import pathtrace, scene as rscene

    t0 = time.perf_counter()
    sc = rscene.load(cell.scene_path(), settings(cell, seed), film=film)
    spp = int(cell.traffic["spp"])
    depth = int(sc.settings.get("max_ray_depth", 5))
    ren = pathtrace.Renderer(sc, device)
    with torch.no_grad():
        rc, rw = pathtrace.film_at(ren, seed, ids, s0, n_pass, spp,
                                   pathtrace.grid(spp) ** 2, depth)
    sync(device)
    numbers = check.compare(color, weight, rc, rw)
    ok, rows = check.judge(numbers, cell.traffic["check"]["limits"])
    return ok, rows, numbers, time.perf_counter() - t0, sc.n_tris
