"""The workloads of the repo's four measuring programs on the port, and the
parts of them that run on any device.

goblin_tpu measures itself with bench.py (the path tracer's throughput
line), bench_methods.py (SPPM, BDPT and light tracing), bench_scaling.py
(the sharded path's overhead) and bench_trace.py (the traversal on captured
wavefronts). This module holds their counterparts' workloads on the port:
bunny.json at its 512 x 384 film, depth 5, the census and the lane-ray
arithmetic of the JAX programs, the timed runs, and the wavefront capture
and replay, and the timing and bound of a kernel launch on the card that
bench_torch.py and chip_smoke.py share. Every function takes its scene (so
its device) or a device explicitly. bench_torch.py at the repo's root is
the command line: it runs these on the card only and refuses to run
without one. The tests call them on the CPU at small sizes, where the
traces run the kernels' plain versions.
"""

from __future__ import annotations

import dataclasses
import inspect
import os
import subprocess
import time

import numpy as np
import torch

from .camera import film as film_mod
from .integrators import common
from .integrators.path import make_li
from .ops import trace as tt
from .scene import intersect as scn
from .scene.loader import load_scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUNNY = os.path.join(REPO, "examples", "bunny.json")
DEPTH = 5
SEED = 0
CHUNK = 1 << 16
UNIT = "Mrays/s/chip"
# bench.py: path tracing at depth 5 (bunny.json's 20 is its SPPM setting),
# 4 passes of one stratified sample a pixel
PT_SETTINGS = {"render_method": "path_tracing", "max_ray_depth": DEPTH}
PT_SPP = 4
# bench_methods.py
METHODS = ("sppm", "bdpt", "light_tracing")
METHOD_SPP = 2
METHOD_RADIUS = 0.01
# bench_scaling.py: a pass's seconds, the mean of REPS calls after one
SCALING_SPP = 1
REPS = 2
# bench_trace.py's classes are replayed through every trace width
WIDTHS = (8, 4, 1)
KERNELS = {8: "trace_bvh8", 4: "trace_bvh4", 1: "trace_bvh2"}
T_RTOL = 1e-4
# timed launches of a kernel, queued behind a spinning kernel of about 10 ms
KERNEL_REPS = 20
SPIN_CYCLES = 20_000_000
# NVIDIA H100 SXM: device memory rate and float32 rate outside tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_FLOP_S = 67e12
# float operations of one slab test and one Moller-Trumbore test, as the
# kernels write them (csrc/trace_common.cuh)
SLAB_FLOP = 25
TRI_FLOP = 53
NO_LIBRARY = "none: no PyTorch call traverses a BVH"
# a ray's bytes in: o and d (24 B) and mint, maxt (8 B), the only part of a
# dead lane (mint 3e38 > maxt 0) that a trace reads; out: hit, t, tri and
# the two barycentrics, written on every lane
RAY_BYTES, DEAD_RAY_BYTES, HIT_BYTES = 32, 8, 17


# ---------------------------------------------------------------------------
# measuring on the card
# ---------------------------------------------------------------------------

def nvidia_smi(query):
    """nvidia-smi's first line for --query-gpu=query, as csv without a
    header."""
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps):
    """Mean ms of fn() over reps calls, CUDA events around the batch. A
    batch of more than one call queues behind a spinning kernel, so the
    device runs the calls back to back however slowly the host issues
    them."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    if reps > 1:
        torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(n_rays, table_bytes, box_tests, tri_tests, ms, out_bytes=HIT_BYTES,
          live=None):
    """The least time the card could take for a trace of n_rays lanes, live
    of them live (all by default): the larger of its bytes (a live lane's
    RAY_BYTES in, a dead lane's DEAD_RAY_BYTES, out_bytes out a lane, the
    tables once) over the memory rate and its operations (this run's box
    and triangle tests) over the float32 rate. Returns the row's bound
    keys."""
    live = n_rays if live is None else live
    n_bytes = (live * RAY_BYTES + (n_rays - live) * DEAD_RAY_BYTES
               + n_rays * out_bytes + table_bytes)
    flop = box_tests * SLAB_FLOP + tri_tests * TRI_FLOP
    by_bytes, by_ops = n_bytes / PEAK_BYTES_S * 1e3, flop / PEAK_FLOP_S * 1e3
    bound_ms = max(by_bytes, by_ops)
    return {"bound_ms": bound_ms,
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bound_counts": {"rays": n_rays, "live": live, "bytes": n_bytes,
                             "table_bytes": table_bytes,
                             "box_tests": box_tests, "tri_tests": tri_tests,
                             "flop": flop},
            "roofline_share": bound_ms / ms,
            "library_ms": None, "library": NO_LIBRARY}


def table_bytes(scene, names):
    return sum(scene[k].numel() * scene[k].element_size() for k in names)


# ---------------------------------------------------------------------------
# workloads
# ---------------------------------------------------------------------------

def load_bunny(overrides, device, trace_wide=8, film=None):
    """bunny.json with overrides on device at trace_wide; film (x_res,
    y_res) resizes the film, as the tests and the card-against-CPU checks
    cut it."""
    scene, meta = load_scene(BUNNY, overrides, device=device,
                             trace_wide=trace_wide)
    if film is not None:
        spec = dataclasses.replace(meta.camera.film, x_res=film[0],
                                   y_res=film[1])
        meta.camera = dataclasses.replace(meta.camera, film=spec)
    return scene, meta


def sync(device) -> None:
    """Wait for the device's queued work (nothing to wait for on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def trace_launches() -> int:
    """Trace kernel launches of every kernel since the last reset."""
    return sum(tt.launches.values())


def check_image(img, what):
    if not bool(torch.isfinite(img).all()) or not float(img.mean()) > 0.0:
        raise RuntimeError(f"{what}: the image is not finite and non-black")


# ---------------------------------------------------------------------------
# pt: bench.py
# ---------------------------------------------------------------------------

def pt_census(scene, meta, chunk=CHUNK):
    """bench.py's untimed census (bench.py:70-85): make_li(meta,
    with_stats=True) over every pixel of pass 0, chunk by chunk -> (shadow
    rays considered, continuation rays traced), lists of ints a bounce."""
    li = make_li(meta, with_stats=True)
    ids = common.crop_pixel_ids(meta.camera.film, scene["tri_rows"].device)
    n_grid = common.spp_grid(PT_SPP)
    shadow, cont = 0, 0
    with torch.inference_mode():
        for c0 in range(0, ids.numel(), chunk):
            pix = ids[c0:c0 + chunk]
            ray = common.camera_rays(meta.camera, SEED, pix, 0, n_grid)
            _, (considered, traced) = li(scene, meta, ray, pix, 0, SEED)
            shadow = shadow + considered.long()
            cont = cont + traced.long()
    return shadow.tolist(), cont.tolist()


def pt_rates(n_pix, spp, depth, all_delta, n_shadow, n_cont, seconds):
    """bench.py's rate arithmetic (bench.py:86-103) over `seconds` for spp
    passes: lane-rays (1 + 2 (depth - 1) a lane-sample), the useful rays of
    the census, the dispatched lane-rays (one fewer where every light is a
    delta light and the last bounce's continuation is peeled) and the
    census as fractions of the pixels."""
    per_lane = 1 + 2 * (depth - 1)
    dispatched = per_lane - (1 if all_delta else 0)
    useful = n_pix + sum(n_shadow) + sum(n_cont)
    return {
        "value": spp * n_pix * per_lane / seconds / 1e6,
        "useful_mrays": spp * useful / seconds / 1e6,
        "dispatched_mrays": spp * n_pix * dispatched / seconds / 1e6,
        "dispatched_rays_per_lane_sample": dispatched,
        "shadow_fraction_per_bounce": [a / n_pix for a in n_shadow],
        "cont_fraction_per_bounce": [a / n_pix for a in n_cont],
    }


def run_pt(scene, meta, chunk=CHUNK):
    """bench.py's measurement on a loaded scene: one warm-up pass (sample
    0), then passes 0 .. 3 timed by the host's clock between two
    synchronizations (a pass is some 17,000 launches, most of them the
    host's), then the census. Returns bench.py's line without its
    vs_baseline and trace_backend, with trace_wide, chunk and the trace
    launches a timed pass."""
    dev = scene["tri_rows"].device
    spec = meta.camera.film
    spp = PT_SPP
    depth = int(meta.settings["max_ray_depth"])
    with torch.inference_mode():
        render_pass, _ = common.make_render_pass(scene, meta, make_li(meta),
                                                 spp, SEED, chunk)
        color, weight = film_mod.new_film(spec, dev)
        color, weight = render_pass(color, weight, 0)
        sync(dev)
        tt.reset_launches()
        t0 = time.perf_counter()
        for s in range(spp):
            color, weight = render_pass(color, weight, s)
        sync(dev)
        seconds = time.perf_counter() - t0
        launches = trace_launches()
        check_image(film_mod.to_image(color, weight), "pt")
    n_shadow, n_cont = pt_census(scene, meta, chunk)
    _, xc, _, yc = spec.crop_window()
    n_pix = xc * yc
    return {
        "metric": "bunny_path_trace_throughput",
        "unit": UNIT,
        **pt_rates(n_pix, spp, depth, meta.all_delta_lights, n_shadow,
                   n_cont, seconds),
        "trace_wide": meta.trace_wide,
        "max_leaf": meta.max_leaf,
        "spp": spp,
        "depth": depth,
        "seconds_per_pass": seconds / spp,
        "trace_launches_per_pass": launches / spp,
        "chunk": chunk,
    }


# ---------------------------------------------------------------------------
# methods: bench_methods.py
# ---------------------------------------------------------------------------

def method_settings(method):
    return {"render_method": method, "max_ray_depth": DEPTH,
            "sample_per_pixel": METHOD_SPP, "initial_radius": METHOD_RADIUS}


def method_lane_rays(method, spp, n_pix, depth):
    """bench_methods.py's lane-rays of a render (bench_methods.py:67-72):
    SPPM's camera pass (1 + 2 (d - 1)) and photon pass (d); BDPT's two
    walks (2 d) and connections (d^2); light tracing's walk and camera
    connections (2 d)."""
    if method == "sppm":
        return spp * n_pix * ((1 + 2 * (depth - 1)) + depth)
    if method == "bdpt":
        return spp * n_pix * (2 * depth + depth * depth)
    if method == "light_tracing":
        return spp * n_pix * 2 * depth
    raise ValueError(f"no lane-ray count for {method!r}")


def method_chunk(method):
    """The chunk the port's renderer of a method takes by default (photons,
    camera samples or light paths), where bench_methods.py passes 32,768 to
    every method."""
    from . import splatting
    from .integrators import bdpt, sppm

    fn = {"sppm": sppm.render_sppm, "bdpt": bdpt.render_bdpt,
          "light_tracing": splatting.render_light_tracer}[method]
    return inspect.signature(fn).parameters["chunk_size"].default


def run_method(method, scene, meta):
    """bench_methods.py's measurement of one method on a loaded scene: a
    warm-up render through render_dispatch, then one render timed by the
    host's clock to a synchronization. Returns its line, with the trace
    launches of the timed render and the chunk."""
    from .splatting import render_dispatch

    dev = scene["tri_rows"].device
    spec = meta.camera.film
    spp = int(meta.settings["sample_per_pixel"])
    depth = int(meta.settings["max_ray_depth"])
    render_dispatch(scene, meta, method)
    sync(dev)
    tt.reset_launches()
    t0 = time.perf_counter()
    img = render_dispatch(scene, meta, method)
    sync(dev)
    seconds = time.perf_counter() - t0
    launches = trace_launches()
    check_image(img, method)
    lane_rays = method_lane_rays(method, spp, spec.x_res * spec.y_res, depth)
    return {"metric": f"bunny_{method}_throughput",
            "value": lane_rays / seconds / 1e6, "unit": UNIT,
            "seconds": seconds, "spp": spp, "depth": depth,
            "lane_rays": lane_rays, "trace_wide": meta.trace_wide,
            "trace_launches": launches, "chunk": method_chunk(method)}


# ---------------------------------------------------------------------------
# scaling: bench_scaling.py
# ---------------------------------------------------------------------------

def scaling_settings():
    return dict(PT_SETTINGS, sample_per_pixel=SCALING_SPP)


def _timed(fn, dev):
    """Seconds of one call of fn, the mean of REPS calls after one warm-up
    call (bench_scaling.py's _timed: a first call may set up)."""
    fn()
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(REPS):
        fn()
    sync(dev)
    return (time.perf_counter() - t0) / REPS


def run_scaling(scene, meta, mesh, chunk=CHUNK):
    """bench_scaling.py --tpu's measurement (bench_scaling.py:108-136) on a
    loaded scene: one prebuilt pass of common.make_render_pass against the
    same pass through parallel.mesh.render_sharded_dense on the mesh's
    group, each timed over REPS calls after a warm-up. Returns (line, the
    two images as numpy arrays): at world N the line has meshN_mrays and,
    for N > 1, efficiency_N = t1 / (N tN)."""
    from .parallel.mesh import render_sharded_dense

    dev = scene["tri_rows"].device
    spec = meta.camera.film
    spp = int(meta.settings["sample_per_pixel"])
    depth = int(meta.settings["max_ray_depth"])
    seed = int(meta.settings.get("seed", SEED))
    li = make_li(meta)
    with torch.inference_mode():
        render_pass, _ = common.make_render_pass(scene, meta, li, spp, seed,
                                                 chunk)

    def unsharded():
        with torch.inference_mode():
            color, weight = film_mod.new_film(spec, dev)
            for s in range(spp):
                color, weight = render_pass(color, weight, s)
            return film_mod.to_image(color, weight)

    def sharded():
        return render_sharded_dense(scene, meta, li, mesh, spp=spp,
                                    chunk_size=chunk)

    t1 = _timed(unsharded, dev)
    tt.reset_launches()
    t_mesh = _timed(sharded, dev)
    launches = trace_launches()
    images = {"unsharded": unsharded().cpu().numpy(),
              "mesh": sharded().cpu().numpy()}
    for what, img in images.items():
        check_image(torch.as_tensor(img), f"scaling {what}")
    rays = spp * spec.x_res * spec.y_res * (1 + 2 * (depth - 1))
    n = mesh.world
    line = {"metric": "scaling_efficiency", "resolution": [spec.x_res,
                                                           spec.y_res],
            "spp": spp, "depth": depth, "world": n,
            "unsharded_mrays": rays / t1 / 1e6,
            f"mesh{n}_mrays": rays / t_mesh / 1e6,
            "sharding_overhead": t_mesh / t1,
            "unsharded_vs_mesh_maxdiff": float(np.abs(
                images["unsharded"] - images["mesh"]).max()),
            "seconds_unsharded": t1, f"seconds_mesh{n}": t_mesh,
            "trace_launches_per_sharded_pass": launches / (REPS + 1),
            "chunk": chunk}
    if n > 1:
        line[f"efficiency_{n}"] = t1 / (n * t_mesh)
    return line, images


# ---------------------------------------------------------------------------
# trace: bench_trace.py
# ---------------------------------------------------------------------------

def capture_wavefronts(scene, meta, chunk=CHUNK):
    """The wavefronts of pass 0 of path tracing over the whole frame, as the
    path tracer casts them chunk by chunk: every call of ops.trace.trace
    recorded, its rays (dead lanes at mint 3e38, maxt 0), hit mode and
    result, and a class's calls of every chunk joined in pixel order. The
    scene's width must be 8 or 4 (width 1 calls trace_bin). Returns a list
    in call order of {"name": primary | shadow<b> | continuation<b>,
    "any_hit", "o", "d", "mint", "maxt", "result"}; a last bounce whose
    continuation the path tracer peels has none."""
    if meta.trace_wide not in (4, 8):
        raise ValueError("capture_wavefronts: the scene's trace width must be "
                         f"8 or 4, not {meta.trace_wide}")
    ids = common.crop_pixel_ids(meta.camera.film, scene["tri_rows"].device)
    rec = []
    trace = scn.trace

    def recorder(scene_, o, d, mint, maxt, any_hit=False, **kw):
        res = trace(scene_, o, d, mint, maxt, any_hit=any_hit, **kw)
        rec.append({"any_hit": any_hit, "o": o.clone(), "d": d.clone(),
                    "mint": mint.clone(), "maxt": maxt.clone(),
                    "result": res})
        return res

    li = make_li(meta)
    chunks = []
    scn.trace = recorder
    try:
        with torch.inference_mode():
            for c0 in range(0, ids.numel(), chunk):
                pix = ids[c0:c0 + chunk]
                ray = common.camera_rays(meta.camera, SEED, pix, 0,
                                         common.spp_grid(PT_SPP))
                li(scene, meta, ray, pix, 0, SEED)
                chunks.append(rec[:])
                rec.clear()
    finally:
        scn.trace = trace
    modes = {tuple(c["any_hit"] for c in calls) for calls in chunks}
    if len(modes) != 1:
        raise RuntimeError("capture_wavefronts: the chunks made different "
                           f"trace calls: {sorted(modes)}")
    waves, seen = [], {True: 0, False: 0}
    for k, calls in enumerate(zip(*chunks)):
        any_hit = calls[0]["any_hit"]
        wave = {"any_hit": any_hit,
                **{key: torch.cat([c[key] for c in calls])
                   for key in ("o", "d", "mint", "maxt")},
                "result": tt.TraceResult(*(
                    torch.cat(v) for v in zip(*(c["result"]
                                                for c in calls))))}
        if k == 0:
            wave["name"] = "primary"
        else:
            seen[any_hit] += 1
            kind = "shadow" if any_hit else "continuation"
            wave["name"] = f"{kind}{seen[any_hit]}"
        waves.append(wave)
    return waves


def rays(wave):
    return wave["o"], wave["d"], wave["mint"], wave["maxt"]


def live_lanes(wave) -> int:
    """Lanes that trace: a dead lane has mint 3e38 > maxt 0."""
    return int((wave["maxt"] > wave["mint"]).sum())


def replay(scene, wave, width):
    """The wavefront through the trace of `width` on the scene baked at that
    width: trace (8, 4) or trace_bin (1), the kernel on the card and the
    plain version on the CPU."""
    with torch.inference_mode():
        if width == 1:
            return tt.trace_bin(scene, *rays(wave), any_hit=wave["any_hit"])
        return tt.trace(scene, *rays(wave), any_hit=wave["any_hit"],
                        width=width)


def replay_work(scene, wave, width):
    """The work the walk of `width` needs on the wavefront, from its plain
    version's census -> (child boxes tested, triangles tested)."""
    with torch.inference_mode():
        if width == 1:
            _, c = tt.trace_bin_plain(scene, *rays(wave),
                                      any_hit=wave["any_hit"], census=True)
            return 2 * int(c[:, 0].sum()), int(c[:, 2].sum())
        _, c = tt.trace_plain(scene, *rays(wave), any_hit=wave["any_hit"],
                              census=True, width=width)
        return int(c[:, 2].sum()), int(c[:, 3].sum())


def table_names(width):
    return tt.BIN_TABLES if width == 1 else tt.wide_tables(width)


def results_agree(res, ref, any_hit):
    """(hit masks equal, t within T_RTOL where both hit; True for any-hit,
    where only the mask is defined)."""
    hits = bool(torch.equal(res.hit, ref.hit))
    if any_hit:
        return hits, True
    both = res.hit & ref.hit
    t_ok = bool(torch.all((res.t[both] - ref.t[both]).abs()
                          <= T_RTOL * ref.t[both].abs()))
    return hits, t_ok
