#!/usr/bin/env python3
"""Smoke run of goblin_tpu_torch's paths on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed on its own lines, and any failure exits non-zero:
  1. card: nvidia-smi's name and power limit, torch's device name;
  2. build: csrc/trace_bvh8.cu at widths 8 and 4 and csrc/trace_bvh2.cu,
     one nvcc each, started together (seconds; ptxas's registers, shared
     memory and stack frame; each kernel's block size, stack levels and
     shared-memory budget);
  3. kernel vs plain: the BVH8 kernel against its plain PyTorch version on
     the full-frame bunny primary, bounce-1 continuation and bounce-1
     shadow wavefronts, traced in the main path's 65,536-ray chunks, in
     both hit modes, with times;
  4. reference: a 48 x 36 bunny render on the card against the CPU's;
  5. main path: bunny.json with path_tracing at 512 x 384, 4 spp, depth 5,
     chunk 65,536, through load_scene -> make_li -> render -> EXR; the
     image must be finite and non-black and the kernel must have launched
     8 times per chunk (1 primary, 4 shadow, 3 continuation) x 3 chunks
     x 4 passes = 96;
  6. the binary-BVH kernel (trace width 1) against its plain version and
     against the BVH8 kernel, on phase 3's wavefronts plus the first bounce
     of one 32,768-photon chunk, both hit modes, in 65,536-ray chunks and
     in one full-frame launch, with times;
  7. the BVH8 kernel's stats instance: a visit census of the primary and
     continuation wavefronts (2 launches), whose per-ray inner / leaf /
     iteration counts equal the plain version's;
  8. bunny.json as shipped (SPPM, 512 x 384, depth 20, initial radius
     0.01) with sample_per_pixel cut from 100 to 4 iterations, through
     render_context at trace width 1 and at 8: finite non-black images
     that agree, and exactly 1 + 2 x 20 + 6 x 20 = 161 launches per
     iteration of the width's kernel and none of the other; the widths
     render in turns (1, 8, 8, 1), so neither always runs first;
  9. a 48 x 36, 2-iteration, depth-5 SPPM render at width 1 on the card
     against the CPU's;
 10. the wide kernel's width-4 instance against its plain version and
     against the width-8 instance, on bunny.json's and bunny_studio.json's
     primary, continuation and shadow wavefronts, both hit modes, in chunks
     and in one launch, with times; its stats instance's counts against the
     plain version's, and the visit census its bound is computed from;
 11. examples/bunny_studio.json (area and sphere lights, analytic spheres
     and disks, a thin lens, Blinn / mirror / mask materials) with
     path_tracing at 512 x 384, 4 spp, depth 5 through render_context at
     trace width 8 and 4 in turns (8, 4, 4, 8): 1 primary + 4 bounces x (4
     punch-through shadow rounds + 1 continuation) = 21 launches a chunk,
     252 a render, of the width's kernel and none of another; the two
     widths' images agree; a 48 x 36 render at width 4 on the card against
     the CPU's;
 12. the studio scene under SPPM, 512 x 384, depth 5, 2 iterations at
     width 4: a finite non-black image and 1 + 2 x 5 + 6 x 5 = 41 launches
     an iteration (SPPM's shadow rays take the any-hit query, masks or
     not); a 48 x 36 render on the card against the CPU's.
The last two lines are the kernel table and {"ok": true, "device": ...}.
Each kernel's row carries its time (CUDA events over launches queued behind
a spinning kernel, so the host's launch rate stays out of it), its plain
version's time, and its bound: the larger of the bytes it must move over
3.35 TB/s and the operations this run's rays need (from the visit census)
over 67 TFLOP/s. The census is exact: a box test for every child a visited
node holds, a test for every triangle of a visited leaf, counted by each
kernel's plain version on the same rays. No PyTorch call traverses a BVH, so library_ms is null.
"""

import dataclasses
import json
import os
import re
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
BUNNY = os.path.join(REPO, "examples", "bunny.json")
STUDIO = os.path.join(REPO, "examples", "bunny_studio.json")
SETTINGS = {"render_method": "path_tracing", "max_ray_depth": 5,
            "sample_per_pixel": 4}
CHUNK = 1 << 16
EXPECTED_LAUNCHES = 8 * 3 * 4
KERNEL_REPS = 20
# the spinning kernel that timed launches queue behind: about 10 ms
SPIN_CYCLES = 20_000_000
# NVIDIA H100 SXM: device memory rate and float32 rate outside tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_FLOP_S = 67e12
# float operations of one slab test and one Moller-Trumbore test, as the
# kernels write them (csrc/trace_common.cuh)
SLAB_FLOP = 25
TRI_FLOP = 53
NO_LIBRARY = "none: no PyTorch call traverses a BVH"
# phase 8: bunny.json's own settings but 4 of its 100 iterations
SPPM_ITERATIONS = 4
# phase 12: the studio scene's SPPM iterations
STUDIO_SPPM_ITERATIONS = 2
# closest-hit rounds of a shadow ray where the scene has a mask material
# (scene/intersect.py occluded_attenuated's max_punch)
MAX_PUNCH = 4



class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def no_launches(**counts):
    """The launch counters' expected state: zero but for counts."""
    from goblin_tpu_torch.ops import trace as tt

    want = dict.fromkeys(tt.launches, 0)
    want.update(counts)
    return want


def nvidia_smi(query):
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def ptxas_numbers(log):
    """What ptxas -v said of each entry function in a build's output ->
    {"production" | "stats": {registers, shared_bytes, stack_frame_bytes,
    spill_bytes}}; the stats instance is the template's <true>."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = out.setdefault(
                "stats" if "ILb1E" in m.group(1) else "production", {})
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur.update(stack_frame_bytes=int(m.group(1)),
                       spill_bytes=int(m.group(2)) + int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            smem = re.search(r"(\d+) bytes smem", line)
            cur.update(registers=int(m.group(1)),
                       shared_bytes=int(smem.group(1)) if smem else 0)
    return out


def chunked(fn, scene, rays, any_hit, **kw):
    """fn over the main path's chunks, results concatenated."""
    import torch

    n = rays[0].shape[0]
    parts = [fn(scene, *(r[c:c + CHUNK] for r in rays), any_hit=any_hit, **kw)
             for c in range(0, n, CHUNK)]
    return [torch.cat(v) for v in zip(*parts)]


def time_ms(fn, reps):
    """Mean ms of fn() over reps calls, CUDA events around the batch. A
    batch of more than one call queues behind a spinning kernel, so the
    device runs the calls back to back however slowly the host issues
    them."""
    import torch

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


def bound(n_rays, table_bytes, box_tests, tri_tests, ms, out_bytes=17):
    """The least time the card could take for a trace: the larger of its
    bytes (each ray 32 B in and out_bytes out, the tables once) over the
    memory rate and its operations (this run's box and triangle tests) over
    the float32 rate. Returns the row's bound keys."""
    n_bytes = n_rays * (32 + out_bytes) + table_bytes
    flop = box_tests * SLAB_FLOP + tri_tests * TRI_FLOP
    by_bytes, by_ops = n_bytes / PEAK_BYTES_S * 1e3, flop / PEAK_FLOP_S * 1e3
    bound_ms = max(by_bytes, by_ops)
    return {"bound_ms": bound_ms,
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bound_counts": {"rays": n_rays, "bytes": n_bytes,
                             "table_bytes": table_bytes,
                             "box_tests": box_tests, "tri_tests": tri_tests,
                             "flop": flop},
            "roofline_share": bound_ms / ms,
            "library_ms": None, "library": NO_LIBRARY}


def table_bytes(scene, names):
    return sum(scene[k].numel() * scene[k].element_size() for k in names)


def wavefronts(scene, meta):
    """Full-frame primary, bounce-1 continuation and bounce-1 shadow rays
    of pass 0, made by the port's raygen, intersect, BSDF and light code
    with the path tracer's sample dimensions (lens samples for a thin lens,
    light samples where a light reads them, the mask pick where the scene
    has a mask)."""
    import torch

    from goblin_tpu_torch.core.rng import hash_uniform
    from goblin_tpu_torch.integrators import common, path
    from goblin_tpu_torch.integrators.materials import gather_material
    from goblin_tpu_torch.lights import lights as lt
    from goblin_tpu_torch.scene.intersect import intersect
    from goblin_tpu_torch.shading import bsdf as bx

    spec = meta.camera.film
    dev = scene["tri_rows"].device
    seed, s_idx, b, n_spp = 0, 0, 0, 4
    pix = torch.arange(spec.x_res * spec.y_res, dtype=torch.int32, device=dev)
    x, y = common.pixel_samples(seed, pix, spec.x_res, s_idx, 2)
    lens = ()
    if not meta.camera.is_delta:
        lens = [hash_uniform(seed, pix, s_idx, common.BOUNCE_CAMERA, dim)
                for dim in (common.DIM_LENS_U, common.DIM_LENS_V)]
    ray = meta.camera.generate_ray(x, y, *lens)
    primary = [ray["o"], ray["d"], ray["mint"], ray["maxt"]]
    frag = intersect(scene, meta, *primary, dxd=ray["dxd"], dyd=ray["dyd"])
    u_mask = None
    if meta.has_null:
        u_mask = hash_uniform(seed, pix, s_idx, b, path.DIM_BSDF_COMP)
    mat = gather_material(scene, meta, frag, u_mask=u_mask)
    p, ns, wo, eps, active = (frag["p"], frag["ns"], frag["wo"], frag["eps"],
                              frag["hit"])
    bu1, bu2 = common.stratified_2d(seed, pix, s_idx, n_spp, b,
                                    path.DIM_BSDF_U1, path.DIM_BSDF_U2)
    bcomp = common.stratified_1d(seed, pix, s_idx, n_spp, b,
                                 path.DIM_BSDF_COMP + 3)
    bs = bx.bsdf_sample(mat, ns, frag["dpdu"], wo, bu1, bu2, bcomp,
                        bx.BSDF_ALL)
    cont_ok = active & bs["valid"] & (bs["f"] > 0.0).any(dim=-1)
    cont = [p, bs["wi"], torch.where(cont_ok, eps, 3e38),
            torch.where(cont_ok, 3e37, 0.0)]
    u_pick = common.stratified_1d(seed, pix, s_idx, n_spp, b, path.DIM_PICK)
    lid, _ = lt.pick_light(scene["lights"], u_pick)
    u1 = u2 = None
    if not meta.all_delta_lights:
        u1, u2 = common.stratified_2d(seed, pix, s_idx, n_spp, b,
                                      path.DIM_LIGHT_U1, path.DIM_LIGHT_U2)
    ls = lt.sample_li(scene["lights"], path._em_tri_data(scene), lid, p, eps,
                      u1, u2)
    f_l = bx.bsdf_eval(mat, ns, wo, ls["wi"], bx.BSDF_ALL)
    consider = (active & (ls["pdf"] > 0.0) & (ls["Li"] > 0.0).any(dim=-1)
                & (f_l > 0.0).any(dim=-1))
    shadow = [p, ls["wi"], torch.where(consider, eps, 3e38),
              torch.where(consider, ls["shadow_maxt"], 0.0)]
    return {"primary": primary, "continuation": cont, "shadow": shadow}


def compare_kernel(scene, meta):
    """Phase 3: the kernel against trace_plain. Returns the kernel row."""
    import torch

    from goblin_tpu_torch.ops import trace as tt

    worst_err, ms, plain_ms = 0.0, {}, {}
    for name, rays in wavefronts(scene, meta).items():
        rays = [r.contiguous() for r in rays]
        live = (rays[2] < rays[3]).float().mean().item()
        for any_hit in (False, True):
            got = chunked(tt.trace, scene, rays, any_hit)
            ref = chunked(tt.trace_plain, scene, rays, any_hit)
            torch.cuda.synchronize()
            n = got[0].numel()
            hit_diff = (got[0] != ref[0]).float().mean().item()
            both = got[0] & ref[0]
            n_both = int(both.sum())
            mode = "any-hit" if any_hit else "closest"
            line = (f"  {name:12s} {mode:8s} rays {n} live {live:.4f} "
                    f"hits {int(ref[0].sum())} hit-mask diff {hit_diff:.2e}")
            check(hit_diff <= 1e-4, f"{name} {mode}: hit masks differ on "
                                    f"{hit_diff:.2e} of lanes")
            if not any_hit and n_both:
                dt = (got[1][both] - ref[1][both]).abs()
                rel = (dt / ref[1][both].abs().clamp(min=1e-30)).max().item()
                tri_eq = (got[2][both] == ref[2][both]).float().mean().item()
                worst_err = max(worst_err, dt.max().item())
                line += (f" t max abs err {dt.max().item():.3e} max rel "
                         f"{rel:.3e} tri equal {tri_eq:.6f}")
                check(rel <= 1e-4, f"{name}: t differs by rel {rel:.3e}")
                check(tri_eq >= 0.99, f"{name}: tri equal on {tri_eq:.4f}")
            key = f"{name}/{mode}"
            ms[key] = time_ms(lambda: chunked(tt.trace, scene, rays, any_hit),
                              KERNEL_REPS) / len(range(0, n, CHUNK))
            plain_ms[key] = time_ms(
                lambda: chunked(tt.trace_plain, scene, rays, any_hit), 1
            ) / len(range(0, n, CHUNK))
            print(line + f" | per 65,536-ray chunk: kernel {ms[key]:.4f} ms,"
                         f" plain {plain_ms[key]:.2f} ms", flush=True)
    print(f"  trace_bvh8 per 65,536-ray chunk: "
          f"{tt.launch_blocks('trace_bvh8', CHUNK)} persistent blocks, 8 "
          "lanes to a ray, no nodes staged", flush=True)
    return {
        "name": "trace_bvh8",
        "route": "cuda",
        "source": "goblin_tpu_torch/csrc/trace_bvh8.cu",
        "replaces": "goblin_tpu/ops/pallas_trace.py:522",
        "max_abs_err": worst_err,
        # the primary closest-hit chunk; every wavefront's time is above
        "ms": ms["primary/closest"],
        "plain_ms": plain_ms["primary/closest"],
    }


def reference_check(path=BUNNY, wide=8):
    """Phases 4 and 11: a small path-traced render on the card against the
    plain CPU path."""
    import numpy as np

    from goblin_tpu_torch.integrators import common
    from goblin_tpu_torch.render import make_li
    from goblin_tpu_torch.scene.loader import load_scene

    ovr = dict(SETTINGS, sample_per_pixel=1)
    images = []
    for device in ("cpu", "cuda"):
        scene, meta = load_scene(path, ovr, device=device, trace_wide=wide)
        meta.camera = dataclasses.replace(
            meta.camera,
            film=dataclasses.replace(meta.camera.film, x_res=48, y_res=36))
        images.append(common.render(scene, meta, make_li(meta)).cpu().numpy())
    cpu, gpu = images
    close = (np.abs(gpu - cpu) <= 1e-4 + 1e-3 * np.abs(cpu)).all(axis=-1)
    rel_mean = abs(gpu.mean() - cpu.mean()) / cpu.mean()
    print(f"  48x36 1 spp, width {wide}: pixels within 1e-4 + 1e-3 rel "
          f"{close.mean():.4f}, mean card {gpu.mean():.6f} cpu {cpu.mean():.6f} "
          f"(rel diff {rel_mean:.2e})", flush=True)
    check(np.isfinite(gpu).all(), "card image has non-finite pixels")
    check(close.mean() >= 0.99, "card and CPU images disagree")
    check(rel_mean <= 1e-3, "card and CPU image means disagree")


def main_path():
    """Phase 5: the full render through the user's entry points."""
    import numpy as np
    import torch

    from goblin_tpu_torch.io.exr import write_exr
    from goblin_tpu_torch.ops import trace as tt
    from goblin_tpu_torch.render import render_context

    marks = []

    def report(done, total):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    tt.reset_launches()
    t0 = time.perf_counter()
    img, meta = render_context(BUNNY, SETTINGS, device="cuda",
                               chunk_size=CHUNK, report=report)
    torch.cuda.synchronize()
    launches = dict(tt.launches)
    img = img.cpu().numpy()
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "bunny.exr")
        write_exr(out, img)
        exr_bytes = os.path.getsize(out)
    spec = meta.camera.film
    n_pix = spec.x_res * spec.y_res
    spp = meta.settings["sample_per_pixel"]
    passes = np.diff([t0] + marks)
    check(img.shape == (384, 512, 3), f"image shape {img.shape}")
    check(np.isfinite(img).all(), "image has non-finite pixels")
    check(img.mean() > 0, "image is black")
    check(launches == no_launches(trace_bvh8=EXPECTED_LAUNCHES),
          f"kernel launches {launches}, expected {EXPECTED_LAUNCHES} of "
          "trace_bvh8 and no other")
    # bench.py's accounting: 1 + 2 (depth - 1) = 9 lane-rays per
    # lane-sample, 8 dispatched with the all-delta last-bounce peel. The
    # first pass also holds the scene load.
    steady = float(np.mean(passes[1:]))
    print(f"  {spec.x_res}x{spec.y_res} {spp} spp depth 5: seconds per pass "
          f"{' '.join(f'{p:.4f}' for p in passes)} (the first with the load);"
          f" passes 2-{spp}: {steady:.4f} s/pass, "
          f"{n_pix * 9 / steady / 1e6:.3f} lane Mrays/s, "
          f"{n_pix * 8 / steady / 1e6:.3f} dispatched Mrays/s", flush=True)
    print(f"  image mean {img.mean():.6f} max {img.max():.4f}; EXR "
          f"{exr_bytes} bytes; kernel launches {launches}", flush=True)
    return launches


def photon_wavefront(scene, seed):
    """First bounce of photon chunk 0 of iteration 0, as SPPM's light walk
    casts it (seed + 77, 32,768 photons)."""
    import torch

    from goblin_tpu_torch import splatting as sp
    from goblin_tpu_torch.core.rng import hash_uniform
    from goblin_tpu_torch.integrators import sppm
    from goblin_tpu_torch.integrators.path import _em_tri_data
    from goblin_tpu_torch.lights import lights as lt

    dev = scene["tri_rows"].device
    ids = torch.arange(sppm.PHOTON_CHUNK, dtype=torch.int32, device=dev)

    def u(dim):
        return hash_uniform(seed + 77, ids, 0, 0, dim)

    lid, _ = lt.pick_light(scene["lights"], u(sp.DIM_PICK))
    em = lt.sample_emission(scene["lights"], _em_tri_data(scene), lid,
                            u(sp.DIM_POS1), u(sp.DIM_POS2), u(sp.DIM_DIR1),
                            u(sp.DIM_DIR2))
    return [em["p"], em["dir"],
            torch.full((sppm.PHOTON_CHUNK,), 1e-3, device=dev),
            torch.full((sppm.PHOTON_CHUNK,), 3e37, device=dev)]


def compare_traces(name, mode, got, ref, what):
    """The kernel bar: hit masks differ on <= 1e-4 of lanes; on common
    closest hits t within 1e-4 rel and tri equal on >= 99%. Returns (line,
    t max abs error)."""
    hit_diff = (got[0] != ref[0]).float().mean().item()
    line = f"{what}: hit-mask diff {hit_diff:.2e}"
    check(hit_diff <= 1e-4, f"{name} {mode} {what}: hit masks differ on "
                            f"{hit_diff:.2e} of lanes")
    both = got[0] & ref[0]
    err = 0.0
    if mode == "closest" and int(both.sum()):
        dt = (got[1][both] - ref[1][both]).abs()
        rel = (dt / ref[1][both].abs().clamp(min=1e-30)).max().item()
        tri_eq = (got[2][both] == ref[2][both]).float().mean().item()
        err = dt.max().item()
        line += (f", t max abs {err:.3e} rel {rel:.3e}, tri equal "
                 f"{tri_eq:.6f}")
        check(rel <= 1e-4, f"{name} {what}: t differs by rel {rel:.3e}")
        check(tri_eq >= 0.99, f"{name} {what}: tri equal on {tri_eq:.4f}")
    return line, err


def compare_bin_kernel(scene8, meta8, scene1):
    """Phase 6: K2 against its plain version and against K1. Returns (K2
    row, K1 full-frame times)."""
    import torch

    from goblin_tpu_torch.ops import trace as tt

    fronts = wavefronts(scene8, meta8)
    fronts["photon"] = photon_wavefront(scene8, meta8.settings["seed"])
    worst, ms, k1_ms = 0.0, {}, {}
    for name, rays in fronts.items():
        rays = [r.contiguous() for r in rays]
        n = rays[0].shape[0]
        n_chunks = len(range(0, n, CHUNK))
        live = (rays[2] < rays[3]).float().mean().item()
        for any_hit in (False, True):
            mode = "any-hit" if any_hit else "closest"
            full = tt.trace_bin(scene1, *rays, any_hit=any_hit)
            chunks = chunked(tt.trace_bin, scene1, rays, any_hit)
            plain = tt.trace_bin_plain(scene1, *rays, any_hit=any_hit)
            k1 = tt.trace(scene8, *rays, any_hit=any_hit)
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(full, chunks)),
                  f"{name} {mode}: chunked and full-frame K2 differ")
            l1, e1 = compare_traces(name, mode, full, plain, "vs plain")
            l2, _ = compare_traces(name, mode, full, k1, "vs K1")
            worst = max(worst, e1)
            key = f"{name}/{mode}"
            ms[key] = {
                "chunk": time_ms(lambda: chunked(tt.trace_bin, scene1, rays,
                                                 any_hit), KERNEL_REPS)
                / n_chunks,
                "full": time_ms(lambda: tt.trace_bin(scene1, *rays,
                                                     any_hit=any_hit),
                                KERNEL_REPS),
                "plain_chunk": time_ms(lambda: chunked(
                    tt.trace_bin_plain, scene1, rays, any_hit), 1) / n_chunks,
                "plain_full": time_ms(lambda: tt.trace_bin_plain(
                    scene1, *rays, any_hit=any_hit), 1),
            }
            k1_ms[key] = {
                "full": time_ms(lambda: tt.trace(scene8, *rays,
                                                 any_hit=any_hit),
                                KERNEL_REPS),
                "plain_full": time_ms(lambda: tt.trace_plain(
                    scene8, *rays, any_hit=any_hit), 1),
            }
            t = ms[key]
            print(f"  {name:12s} {mode:8s} rays {n} live {live:.4f} hits "
                  f"{int(plain[0].sum())} | {l1} | {l2} | K2 "
                  f"{t['chunk']:.4f} ms per {min(n, CHUNK)}-ray chunk, "
                  f"{t['full']:.4f} ms per {n}-ray launch; plain "
                  f"{t['plain_chunk']:.2f} / {t['plain_full']:.2f} ms; K1 "
                  f"{k1_ms[key]['full']:.4f} ms per {n}-ray launch, plain "
                  f"{k1_ms[key]['plain_full']:.2f} ms", flush=True)
    primary = [r.contiguous() for r in fronts["primary"]]
    _, counts = tt.trace_bin_plain(scene1, *primary, census=True)
    census = [int(v) for v in counts.sum(dim=0)]
    n = primary[0].shape[0]
    n_nodes = scene1["bin_meta"].shape[0]
    n_staged = tt.bin_staged_nodes(n_nodes, primary[0].device)
    print(f"  trace_bvh2 per {n}-ray launch: "
          f"{tt.launch_blocks('trace_bvh2', n, n_staged)} persistent blocks, "
          f"{n_staged} of {n_nodes} nodes staged in shared memory; "
          f"primary census (plain version): {census[0] / n:.3f} inner visits, "
          f"{census[1] / n:.3f} leaf visits, {census[2] / n:.3f} triangles "
          "tested per ray", flush=True)
    row = {
        "name": "trace_bvh2",
        "route": "cuda",
        "source": "goblin_tpu_torch/csrc/trace_bvh2.cu",
        "replaces": "goblin_tpu/ops/pallas_trace.py:114",
        "max_abs_err": worst,
        # the full-frame primary closest-hit launch, SPPM's shape
        "ms": ms["primary/closest"]["full"],
        "plain_ms": ms["primary/closest"]["plain_full"],
        "ms_chunk": ms["primary/closest"]["chunk"],
        "plain_ms_chunk": ms["primary/closest"]["plain_chunk"],
    }
    row.update(bound(n, table_bytes(scene1, tt._BIN_TABLES), 2 * census[0],
                     census[2], row["ms"]))
    return row, k1_ms


def compare_stats(scene8, meta8):
    """Phase 7: the stats instance's visit census of the primary and
    continuation wavefronts (the use goblin_tpu's tools/trace_profile.py
    makes of it), then its counts against trace_plain's. Returns (row,
    the census's launches, the primary wavefront's sums of inner visits,
    leaf visits, child boxes tested and triangles tested, from the plain
    version's census of the same walk)."""
    import torch

    from goblin_tpu_torch.ops import trace as tt

    fronts = wavefronts(scene8, meta8)
    names = ("primary", "continuation")
    fronts = {name: [r.contiguous() for r in fronts[name]] for name in names}
    tt.reset_launches()
    census = {name: tt.trace(scene8, *fronts[name], stats=True)
              for name in names}
    torch.cuda.synchronize()
    launches = tt.launches["trace_bvh8_stats"]
    check(launches == len(names), f"census launched the stats instance "
                                  f"{launches} times, expected {len(names)}")
    ms, plain_ms, worst = {}, {}, 0
    for name in names:
        rays = fronts[name]
        res, counts = census[name]
        ref, ref_counts = tt.trace_plain(scene8, *rays, stats=True)
        worst = max(worst, int((counts - ref_counts).abs().max()))
        check(torch.equal(counts, ref_counts),
              f"{name}: stats counts differ from the plain version's on "
              f"{int((counts != ref_counts).any(dim=1).sum())} rays")
        check(torch.equal(res.hit, ref.hit), f"{name}: stats hit masks differ")
        live = rays[2] < rays[3]
        c = counts[live].float()
        ms[name] = time_ms(lambda: tt.trace(scene8, *rays, stats=True),
                           KERNEL_REPS)
        prod_ms = time_ms(lambda: tt.trace(scene8, *rays), KERNEL_REPS)
        plain_ms[name] = time_ms(
            lambda: tt.trace_plain(scene8, *rays, stats=True), 1)
        print(f"  {name:12s} counts equal on {counts.shape[0]} rays; per live "
              f"ray ({int(live.sum())}): inner visits mean "
              f"{c[:, 0].mean().item():.3f} max {int(c[:, 0].max())}, leaf "
              f"visits mean {c[:, 1].mean().item():.3f} max "
              f"{int(c[:, 1].max())}, iterations mean "
              f"{c[:, 2].mean().item():.3f} max {int(c[:, 2].max())} | stats "
              f"kernel {ms[name]:.4f} ms per {counts.shape[0]}-ray launch "
              f"(production instance {prod_ms:.4f} ms), plain "
              f"{plain_ms[name]:.2f} ms", flush=True)
    # the work K1's walk needs on the primary frame: a box test for every
    # slot of a visited node that holds a child, a test for every triangle
    # of a visited leaf
    _, work = tt.trace_plain(scene8, *fronts["primary"], census=True)
    check(torch.equal(work[:, :2], census["primary"][1][:, :2]),
          "primary: the census's visits differ from the stats counts")
    work = [int(v) for v in work.sum(dim=0)]
    n = fronts["primary"][0].shape[0]
    print(f"  primary census (plain version): {work[2] / work[0]:.3f} child "
          f"boxes tested per inner visit, {work[3] / work[1]:.3f} triangles "
          f"per leaf visit; {work[2] / n:.3f} boxes and {work[3] / n:.3f} "
          "triangles per ray", flush=True)
    return {
        "name": "trace_bvh8_stats",
        "route": "cuda",
        "source": "goblin_tpu_torch/csrc/trace_bvh8.cu",
        "replaces": "goblin_tpu/ops/pallas_trace.py:952",
        # largest count difference against the plain version
        "max_abs_err": float(worst),
        "ms": ms["primary"],
        "plain_ms": plain_ms["primary"],
    }, launches, work


def sppm_main_path():
    """Phase 8: bunny.json as shipped (SPPM) through render_context at
    trace width 1 and 8, in turns (1, 8, 8, 1). Returns {width: launches}."""
    import numpy as np
    import torch

    from goblin_tpu_torch.integrators import sppm
    from goblin_tpu_torch.ops import trace as tt
    from goblin_tpu_torch.render import render_context

    ovr = {"sample_per_pixel": SPPM_ITERATIONS}
    print(f"  bunny.json as shipped, sample_per_pixel cut from 100 to "
          f"{SPPM_ITERATIONS} iterations", flush=True)
    ray_s = []
    make_ray_pass = sppm.make_ray_pass

    def timed_make_ray_pass(*args):
        ray_pass = make_ray_pass(*args)

        def timed(*a):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = ray_pass(*a)
            torch.cuda.synchronize()
            ray_s.append(time.perf_counter() - t)
            return out

        return timed

    images, counts, mean_s = {}, {}, {1: [], 8: []}
    sppm.make_ray_pass = timed_make_ray_pass
    try:
        for turn, wide in enumerate((1, 8, 8, 1)):
            marks, ray_s[:] = [], []

            def report(done, total):
                torch.cuda.synchronize()
                marks.append(time.perf_counter())

            torch.cuda.synchronize()
            tt.reset_launches()
            t0 = time.perf_counter()
            img, meta = render_context(BUNNY, ovr, device="cuda",
                                       report=report, trace_wide=wide)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            launches = dict(tt.launches)
            img = img.cpu().numpy()
            max_len = meta.settings["max_ray_depth"]
            spec = meta.camera.film
            n_pix = spec.x_res * spec.y_res
            n_chunks = -(-n_pix // sppm.PHOTON_CHUNK)
            per_it = 1 + 2 * max_len + n_chunks * max_len
            mine = "trace_bvh2" if wide == 1 else "trace_bvh8"
            want = no_launches(**{mine: per_it * SPPM_ITERATIONS})
            its = np.diff([t0] + marks)
            mean_s[wide].append(float(np.mean(its)))
            print(f"  turn {turn + 1}, width {wide}: {spec.x_res}x{spec.y_res} "
                  f"depth {max_len} "
                  f"initial radius {meta.settings['initial_radius']}; seconds "
                  f"per iteration {' '.join(f'{s:.3f}' for s in its)} (ray "
                  f"pass {' '.join(f'{s:.3f}' for s in ray_s)}, photon pass "
                  f"and update {' '.join(f'{a - b:.3f}' for a, b in zip(its, ray_s))}); "
                  f"total {t1 - t0:.2f} s with the load; launches {launches} "
                  f"(expected {per_it} per iteration: 1 + 2 x {max_len} ray "
                  f"pass + {n_chunks} chunks x {max_len} photon bounces); "
                  f"image mean {img.mean():.6f} max {img.max():.4f}",
                  flush=True)
            check(img.shape == (384, 512, 3), f"image shape {img.shape}")
            check(np.isfinite(img).all(), f"width {wide}: non-finite pixels")
            check(img.mean() > 0, f"width {wide}: image is black")
            check(launches == want, f"width {wide}: launches {launches}, "
                                    f"expected {want}")
            images[wide], counts[wide] = img, launches
    finally:
        sppm.make_ray_pass = make_ray_pass
    print(f"  mean seconds per iteration by turn: width 1 "
          f"{' '.join(f'{v:.3f}' for v in mean_s[1])} (turns 1 and 4), "
          f"width 8 {' '.join(f'{v:.3f}' for v in mean_s[8])} (turns 2 and "
          "3)", flush=True)
    a, b = images[1], images[8]
    close = (np.abs(a - b) <= 1e-4 + 1e-3 * np.abs(b)).all(axis=-1)
    rel_mean = abs(a.mean() - b.mean()) / b.mean()
    print(f"  width 1 vs width 8: pixels within 1e-4 + 1e-3 rel "
          f"{close.mean():.6f}, means {a.mean():.6f} / {b.mean():.6f} (rel "
          f"diff {rel_mean:.2e})", flush=True)
    check(close.mean() >= 0.99, "width-1 and width-8 images disagree")
    check(rel_mean <= 1e-3, "width-1 and width-8 image means disagree")
    return counts


def sppm_reference_check(path=BUNNY, wide=1):
    """Phases 9 and 12: a small SPPM render on the card against the plain
    CPU path."""
    import numpy as np

    from goblin_tpu_torch.integrators.sppm import render_sppm
    from goblin_tpu_torch.scene.loader import load_scene

    ovr = {"render_method": "sppm", "sample_per_pixel": 2, "max_ray_depth": 5}
    images = []
    for device in ("cpu", "cuda"):
        scene, meta = load_scene(path, ovr, device=device, trace_wide=wide)
        meta.camera = dataclasses.replace(
            meta.camera,
            film=dataclasses.replace(meta.camera.film, x_res=48, y_res=36))
        images.append(render_sppm(scene, meta).cpu().numpy())
    cpu, gpu = images
    close = (np.abs(gpu - cpu) <= 1e-4 + 1e-3 * np.abs(cpu)).all(axis=-1)
    rel_mean = abs(gpu.mean() - cpu.mean()) / cpu.mean()
    print(f"  48x36 2 iterations depth 5, width {wide}: pixels within 1e-4 + "
          f"1e-3 rel {close.mean():.4f}, mean card {gpu.mean():.6f} cpu "
          f"{cpu.mean():.6f} (rel diff {rel_mean:.2e})", flush=True)
    check(np.isfinite(gpu).all(), "card SPPM image has non-finite pixels")
    check(cpu.mean() > 0, "CPU SPPM image is black")
    check(close.mean() >= 0.99, "card and CPU SPPM images disagree")
    check(rel_mean <= 1e-3, "card and CPU SPPM image means disagree")


def compare_width4(label, path):
    """Phase 10 for one scene: the width-4 instance against trace_plain at
    width 4 and against the width-8 instance on the scene's wavefronts, then
    its stats instance and the census of its primary frame. Returns the
    scene's numbers for the width-4 row."""
    import torch

    from goblin_tpu_torch.ops import trace as tt
    from goblin_tpu_torch.scene.loader import load_scene

    scene, meta = load_scene(path, SETTINGS, device="cuda")
    scene4, meta4 = load_scene(path, SETTINGS, device="cuda", trace_wide=4)
    check(torch.equal(scene4["tri_rows"], scene["tri_rows"]),
          f"{label}: width-4 and width-8 bakes hold different triangles")
    scene.update({k: scene4[k] for k in tt.wide_tables(4)})
    print(f"  {label}: {meta.n_tris} triangle rows, {meta.n_nodes} binary "
          f"nodes; width 4: {meta4.n_wide_nodes} nodes, depth "
          f"{meta4.wide_depth} of {tt.wide_levels(4)} levels; width 8: "
          f"{meta.n_wide_nodes} nodes, depth {meta.wide_depth} of "
          f"{tt.wide_levels(8)}", flush=True)
    fronts = {name: [r.contiguous() for r in rays]
              for name, rays in wavefronts(scene, meta).items()}
    worst, ms = 0.0, {}
    for name, rays in fronts.items():
        n = rays[0].shape[0]
        n_chunks = len(range(0, n, CHUNK))
        live = (rays[2] < rays[3]).float().mean().item()
        for any_hit in (False, True):
            mode = "any-hit" if any_hit else "closest"
            full = tt.trace(scene, *rays, any_hit=any_hit, width=4)
            chunks = chunked(tt.trace, scene, rays, any_hit, width=4)
            plain = tt.trace_plain(scene, *rays, any_hit=any_hit, width=4)
            k8 = tt.trace(scene, *rays, any_hit=any_hit)
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(full, chunks)),
                  f"{label} {name} {mode}: chunked and full-frame launches "
                  "of the width-4 kernel differ")
            l1, e1 = compare_traces(name, mode, full, plain, "vs plain")
            l2, _ = compare_traces(name, mode, full, k8, "vs width 8")
            fields = (0,) if any_hit else range(5)
            bit_equal = all(torch.equal(full[k], plain[k]) for k in fields)
            worst = max(worst, e1)
            t = ms[f"{name}/{mode}"] = {
                "chunk": time_ms(lambda: chunked(tt.trace, scene, rays,
                                                 any_hit, width=4),
                                 KERNEL_REPS) / n_chunks,
                "full": time_ms(lambda: tt.trace(scene, *rays,
                                                 any_hit=any_hit, width=4),
                                KERNEL_REPS),
                "plain_chunk": time_ms(lambda: chunked(
                    tt.trace_plain, scene, rays, any_hit, width=4), 1)
                / n_chunks,
                "plain_full": time_ms(lambda: tt.trace_plain(
                    scene, *rays, any_hit=any_hit, width=4), 1),
                "w8_full": time_ms(lambda: tt.trace(scene, *rays,
                                                    any_hit=any_hit),
                                   KERNEL_REPS),
            }
            print(f"  {label} {name:12s} {mode:8s} rays {n} live {live:.4f} "
                  f"hits {int(plain[0].sum())} | {l1}, bit-equal "
                  f"{'yes' if bit_equal else 'no'} | {l2} | width 4 "
                  f"{t['chunk']:.4f} ms per {min(n, CHUNK)}-ray chunk, "
                  f"{t['full']:.4f} ms per {n}-ray launch; plain "
                  f"{t['plain_chunk']:.2f} / {t['plain_full']:.2f} ms; width "
                  f"8 {t['w8_full']:.4f} ms per {n}-ray launch", flush=True)
    # the stats instance: counts equal to the plain version's on every ray
    stats_ms = {}
    tt.reset_launches()
    for name in ("primary", "continuation"):
        rays = fronts[name]
        res, counts = tt.trace(scene, *rays, stats=True, width=4)
        ref, ref_counts = tt.trace_plain(scene, *rays, stats=True, width=4)
        torch.cuda.synchronize()
        check(torch.equal(counts, ref_counts),
              f"{label} {name}: width-4 stats counts differ from the plain "
              f"version's on {int((counts != ref_counts).any(dim=1).sum())} "
              "rays")
        check(torch.equal(res.hit, ref.hit),
              f"{label} {name}: width-4 stats hit masks differ")
        c = counts[rays[2] < rays[3]].float()
        stats_ms[name] = time_ms(
            lambda: tt.trace(scene, *rays, stats=True, width=4), KERNEL_REPS)
        print(f"  {label} {name:12s} width-4 stats counts equal on "
              f"{counts.shape[0]} rays; per live ray: inner visits mean "
              f"{c[:, 0].mean().item():.3f} max {int(c[:, 0].max())}, leaf "
              f"visits mean {c[:, 1].mean().item():.3f} max "
              f"{int(c[:, 1].max())} | stats kernel {stats_ms[name]:.4f} ms "
              f"per launch", flush=True)
    stats_launches = tt.launches["trace_bvh4_stats"]
    check(stats_launches == 2 * (1 + 1 + KERNEL_REPS),
          f"{label}: the width-4 stats instance launched {stats_launches} "
          "times")
    primary = fronts["primary"]
    _, work = tt.trace_plain(scene, *primary, census=True, width=4)
    work = [int(v) for v in work.sum(dim=0)]
    n = primary[0].shape[0]
    print(f"  {label} primary census at width 4 (plain version): "
          f"{work[0] / n:.3f} inner and {work[1] / n:.3f} leaf visits per "
          f"ray, {work[2] / work[0]:.3f} child boxes per inner visit, "
          f"{work[3] / work[1]:.3f} triangles per leaf visit; "
          f"{tt.launch_blocks('trace_bvh4', n)} persistent blocks per "
          f"{n}-ray launch, {tt.launch_blocks('trace_bvh4', CHUNK)} per "
          "chunk, 4 lanes to a ray", flush=True)
    t = ms["primary/closest"]
    n_chunks, rest = divmod(n, CHUNK)
    check(rest == 0, f"the frame is not whole chunks of {CHUNK}")
    tbytes = table_bytes(scene, tt.wide_tables(4))
    out = {"max_abs_err": worst, "ms": t["full"], "plain_ms": t["plain_full"],
           "ms_chunk": t["chunk"], "plain_ms_chunk": t["plain_chunk"],
           "width8_ms": t["w8_full"], "stats_ms": stats_ms["primary"]}
    out.update(bound(n, tbytes, work[2], work[3], t["full"]))
    chunk = bound(CHUNK, tbytes, work[2] // n_chunks, work[3] // n_chunks,
                  t["chunk"])
    out.update(bound_ms_chunk=chunk["bound_ms"],
               roofline_share_chunk=chunk["roofline_share"])
    return out


def studio_launches_per_chunk(depth):
    """Trace launches the path tracer makes for one chunk of the studio
    scene: the primary rays, then for each of depth - 1 bounces MAX_PUNCH
    closest-hit rounds of the shadow rays (the scene has a mask material)
    and one continuation; no light is a delta-only table, so the last
    bounce is not peeled."""
    return 1 + (depth - 1) * (MAX_PUNCH + 1)


def studio_main_path():
    """Phase 11: the studio scene's path tracing through render_context at
    trace widths 8 and 4, in turns. Returns {width: launches}."""
    import numpy as np
    import torch

    from goblin_tpu_torch.ops import trace as tt
    from goblin_tpu_torch.render import render_context

    images, counts, steady = {}, {}, {4: [], 8: []}
    for turn, wide in enumerate((8, 4, 4, 8)):
        marks = []

        def report(done, total):
            torch.cuda.synchronize()
            marks.append(time.perf_counter())

        torch.cuda.synchronize()
        tt.reset_launches()
        t0 = time.perf_counter()
        img, meta = render_context(STUDIO, SETTINGS, device="cuda",
                                   chunk_size=CHUNK, report=report,
                                   trace_wide=wide)
        torch.cuda.synchronize()
        launches = dict(tt.launches)
        img = img.cpu().numpy()
        spec = meta.camera.film
        n_pix = spec.x_res * spec.y_res
        spp = meta.settings["sample_per_pixel"]
        depth = meta.settings["max_ray_depth"]
        check(meta.has_null and not meta.all_delta_lights
              and not meta.camera.is_delta and meta.n_spheres == 2
              and meta.n_disks == 2, "the studio scene lost a feature")
        per_chunk = studio_launches_per_chunk(depth)
        want = per_chunk * -(-n_pix // CHUNK) * spp
        passes = np.diff([t0] + marks)
        steady[wide].append(float(np.mean(passes[1:])))
        print(f"  turn {turn + 1}, width {wide}: {spec.x_res}x{spec.y_res} "
              f"{spp} spp depth {depth}, {meta.n_tris} triangle rows: seconds "
              f"per pass {' '.join(f'{p:.4f}' for p in passes)} (the first "
              f"with the load); passes 2-{spp}: {steady[wide][-1]:.4f} "
              f"s/pass; launches {launches} (expected {want}: {per_chunk} a "
              f"chunk); image mean {img.mean():.6f} max {img.max():.4f}",
              flush=True)
        check(img.shape == (384, 512, 3), f"image shape {img.shape}")
        check(np.isfinite(img).all(), f"width {wide}: non-finite pixels")
        check(img.mean() > 0, f"width {wide}: image is black")
        check(launches == no_launches(**{f"trace_bvh{wide}": want}),
              f"width {wide}: launches {launches}, expected {want} of "
              f"trace_bvh{wide} and no other")
        images[wide], counts[wide] = img, launches
    print(f"  steady seconds per pass by turn: width 8 "
          f"{' '.join(f'{v:.4f}' for v in steady[8])} (turns 1 and 4), width "
          f"4 {' '.join(f'{v:.4f}' for v in steady[4])} (turns 2 and 3)",
          flush=True)
    a, b = images[4], images[8]
    close = (np.abs(a - b) <= 1e-4 + 1e-3 * np.abs(b)).all(axis=-1)
    rel_mean = abs(a.mean() - b.mean()) / b.mean()
    print(f"  width 4 vs width 8: pixels within 1e-4 + 1e-3 rel "
          f"{close.mean():.6f}, means {a.mean():.6f} / {b.mean():.6f} (rel "
          f"diff {rel_mean:.2e})", flush=True)
    check(close.mean() >= 0.99, "width-4 and width-8 studio images disagree")
    check(rel_mean <= 1e-3, "width-4 and width-8 studio image means disagree")
    return counts


def studio_sppm_path(wide=4):
    """Phase 12: the studio scene under SPPM at full size. Returns the
    launches."""
    import numpy as np
    import torch

    from goblin_tpu_torch.integrators import sppm
    from goblin_tpu_torch.ops import trace as tt
    from goblin_tpu_torch.render import render_context

    ovr = {"render_method": "sppm",
           "sample_per_pixel": STUDIO_SPPM_ITERATIONS}
    marks = []

    def report(done, total):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    torch.cuda.synchronize()
    tt.reset_launches()
    t0 = time.perf_counter()
    img, meta = render_context(STUDIO, ovr, device="cuda", report=report,
                               trace_wide=wide)
    torch.cuda.synchronize()
    launches = dict(tt.launches)
    img = img.cpu().numpy()
    max_len = meta.settings["max_ray_depth"]
    spec = meta.camera.film
    n_chunks = -(-spec.x_res * spec.y_res // sppm.PHOTON_CHUNK)
    # ray pass: the primary rays, then a bounce's any-hit shadow query (SPPM
    # does not punch through masks) and its continuation; photon pass: a
    # trace a bounce of each chunk
    per_it = 1 + 2 * max_len + n_chunks * max_len
    its = np.diff([t0] + marks)
    print(f"  width {wide}: {spec.x_res}x{spec.y_res} depth {max_len}, "
          f"initial radius {meta.settings['initial_radius']}; seconds per "
          f"iteration "
          f"{' '.join(f'{s:.3f}' for s in its)} (the first with the load); "
          f"launches {launches} (expected {per_it} per iteration: 1 + 2 x "
          f"{max_len} ray pass + {n_chunks} chunks x {max_len} photon "
          f"bounces); image mean {img.mean():.6f} max "
          f"{img.max():.4f}", flush=True)
    check(img.shape == (384, 512, 3), f"image shape {img.shape}")
    check(np.isfinite(img).all(), "studio SPPM image has non-finite pixels")
    check(img.mean() > 0, "studio SPPM image is black")
    check(launches == no_launches(
        **{f"trace_bvh{wide}": per_it * STUDIO_SPPM_ITERATIONS}),
        f"studio SPPM launches {launches}, expected {per_it} per iteration "
        f"of trace_bvh{wide} and no other")
    return launches, float(its[-1])


def run():
    import torch

    check(torch.cuda.is_available(), "CUDA is not available")
    sys.path.insert(0, REPO)
    try:
        from goblin_tpu_torch.ops import trace as tt
        from goblin_tpu_torch.scene.loader import load_scene
    except ImportError as e:
        raise SmokeFailure(f"goblin_tpu_torch is not beside this script: {e}")
    smi = nvidia_smi("name,power.limit")
    print(f"[1] card: {smi}; torch {torch.__version__} CUDA "
          f"{torch.version.cuda}; device {torch.cuda.get_device_name(0)}",
          flush=True)

    t = time.perf_counter()
    builds = tt.build_kernels()
    print(f"[2] build: {time.perf_counter() - t:.2f} s for "
          f"{', '.join(builds)}", flush=True)
    ptxas = {name: ptxas_numbers(log) for name, (_, log) in builds.items()}
    for name, (_, log) in builds.items():
        for line in log.splitlines():
            if ("registers" in line or "spill" in line
                    or "stack frame" in line or "Compiling" in line):
                print(f"  {name}: {line.strip()}")

    cfg = tt.bin_kernel_config(torch.cuda.current_device())
    print(f"  trace_bvh8: {tt.wide_levels(8)} stack levels a ray, "
          f"trace_bvh4: {tt.wide_levels(4)}, no nodes staged; trace_bvh2: blocks of {cfg.threads} threads, {cfg.stack} "
          f"stack entries a ray, {cfg.fixed_bytes} B of shared memory a "
          f"block beside {cfg.node_bytes} B a staged node, budget "
          f"{cfg.budget} B a block", flush=True)

    print("[3] kernel vs plain, bunny pass-0 wavefronts:", flush=True)
    scene, meta = load_scene(BUNNY, SETTINGS, device="cuda")
    row = compare_kernel(scene, meta)
    del scene

    print("[4] card vs CPU reference render:", flush=True)
    reference_check()

    print("[5] main path (path tracing):", flush=True)
    pt_launches = main_path()

    print("[6] binary-BVH kernel (width 1) vs plain and vs K1:", flush=True)
    scene8, meta8 = load_scene(BUNNY, SETTINGS, device="cuda")
    scene1, _ = load_scene(BUNNY, SETTINGS, device="cuda", trace_wide=1)
    check(torch.equal(scene1["tri_rows"], scene8["tri_rows"]),
          "width-1 and width-8 bakes hold different triangles")
    k2_row, k1_full_ms = compare_bin_kernel(scene8, meta8, scene1)
    k1_table_bytes = table_bytes(scene8, tt.wide_tables(8))
    n_frame = meta8.camera.film.x_res * meta8.camera.film.y_res

    print("[7] BVH8 stats instance vs plain counts:", flush=True)
    stats_row, stats_launches, k1_census = compare_stats(scene8, meta8)
    del scene8, scene1

    print("[8] SPPM, bunny.json as shipped, through render_context:",
          flush=True)
    sppm_counts = sppm_main_path()

    print("[9] SPPM card vs CPU reference render (width 1):", flush=True)
    sppm_reference_check()

    print("[10] the width-4 instance vs plain and vs width 8:", flush=True)
    w4 = {label: compare_width4(label, path)
          for label, path in (("bunny", BUNNY), ("studio", STUDIO))}

    print("[11] studio scene, path tracing through render_context:",
          flush=True)
    studio_counts = studio_main_path()
    reference_check(STUDIO, wide=4)

    print("[12] studio scene, SPPM through render_context:", flush=True)
    studio_sppm_launches, studio_sppm_s = studio_sppm_path()
    sppm_reference_check(STUDIO, wide=4)

    print(f"  clocks.sm, power.draw, temperature: "
          f"{nvidia_smi('clocks.sm,power.draw,temperature.gpu')}")
    # every row's ms / plain_ms: the full-frame primary closest-hit launch
    # (SPPM's shape); the K1 row keeps phase 3's 65,536-ray chunk beside it
    row.update(ms_chunk=row["ms"], plain_ms_chunk=row["plain_ms"],
               ms=k1_full_ms["primary/closest"]["full"],
               plain_ms=k1_full_ms["primary/closest"]["plain_full"])
    # K1's work on the primary frame, from phase 7's census. A chunk's bound
    # is that of the frame's chunks on average, as its time is.
    n_chunks, rest = divmod(n_frame, CHUNK)
    check(rest == 0, f"the frame is not whole chunks of {CHUNK}")
    row.update(bound(n_frame, k1_table_bytes, k1_census[2], k1_census[3],
                     row["ms"]))
    chunk = bound(CHUNK, k1_table_bytes, k1_census[2] // n_chunks,
                  k1_census[3] // n_chunks, row["ms_chunk"])
    row.update(bound_ms_chunk=chunk["bound_ms"],
               roofline_share_chunk=chunk["roofline_share"])
    # the stats instance also writes 12 bytes a ray
    stats_row.update(bound(n_frame, k1_table_bytes, k1_census[2],
                           k1_census[3], stats_row["ms"], out_bytes=17 + 12))
    # launches: the SPPM render's at the kernel's own width; path tracing is
    # driven at width 8
    spp = SETTINGS["sample_per_pixel"]
    for r, width in ((row, 8), (k2_row, 1), (stats_row, 8)):
        name = r["name"]
        r["launches"] = sppm_counts[width][name]
        r["launches_per_pt_pass"] = pt_launches[name] // spp
        r["launches_per_sppm_iteration"] = (sppm_counts[width][name]
                                            // SPPM_ITERATIONS)
    row["launches_path_tracing"] = pt_launches["trace_bvh8"]
    row["launches_studio_path_tracing"] = studio_counts[8]["trace_bvh8"]
    # the width-4 row: bunny's primary frame like the rows above, the studio
    # scene's beside it; its launches are the studio renders' at width 4
    w4_row = {"name": "trace_bvh4", "route": "cuda",
              "source": "goblin_tpu_torch/csrc/trace_bvh8.cu",
              "replaces": "goblin_tpu/ops/pallas_trace.py:522",
              "instance": "-DGOBLIN_TRACE_WIDTH=4", **w4["bunny"],
              "studio": w4["studio"],
              "launches": studio_counts[4]["trace_bvh4"],
              "launches_per_pt_pass": studio_counts[4]["trace_bvh4"] // spp,
              "launches_per_sppm_iteration":
                  studio_sppm_launches["trace_bvh4"] // STUDIO_SPPM_ITERATIONS,
              "launches_counted_in": "the studio scene's renders at width 4",
              "studio_sppm_s_per_iteration": studio_sppm_s}
    # no render path runs the stats instance: its row counts phase 7's census
    stats_row["launches"] = stats_launches
    stats_row["launches_counted_in"] = "phase 7's visit census"
    row["ptxas"] = ptxas["trace_bvh8"].get("production")
    stats_row["ptxas"] = ptxas["trace_bvh8"].get("stats")
    k2_row["ptxas"] = ptxas["trace_bvh2"].get("production")
    w4_row["ptxas"] = ptxas["trace_bvh4"].get("production")
    w4_row["ptxas_stats"] = ptxas["trace_bvh4"].get("stats")
    for r in (row, k2_row, stats_row, w4_row):
        check(r["ptxas"] and "registers" in r["ptxas"],
              f"{r['name']}: no ptxas numbers in the build's output")
    print(smi)
    print(json.dumps({"kernels": [row, k2_row, stats_row, w4_row]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    try:
        run()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
