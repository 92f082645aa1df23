#!/usr/bin/env python3
"""Smoke run of goblin_tpu_torch's paths on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed on its own lines, and any failure exits non-zero:
  1. card: nvidia-smi's name and power limit, torch's device name;
  2. build: csrc/trace_bvh8.cu at widths 8 and 4, csrc/trace_bvh2.cu,
     csrc/rng_hash.cu and csrc/sppm_drain.cu, one nvcc each, started
     together (seconds; ptxas's registers, shared memory and stack frame;
     each trace kernel's block size, stack levels and shared-memory
     budget);
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
     that agree, and exactly 1 + 2 x 20 + 20 = 61 launches per
     iteration of the width's kernel (one light walk of the 6 photon
     chunks) and none of the other; the widths
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
     width 4: a finite non-black image and 1 + 2 x 5 + 5 = 16 launches
     an iteration (SPPM's shadow rays take the any-hit query, masks or
     not; one light walk of the 6 photon chunks); a 48 x 36 render on the
     card against the CPU's.
 13. examples/bunny_gallery.json (the studio scene under the texture chain:
     a filtered checkerboard over a scale node, an EWA image under the
     spherical mapping, a trilinear alpha image, a bump map and a normal
     map) with path_tracing at 512 x 384, 4 spp, depth 5 through
     render_context at trace width 8 and 4 in turns: 21 launches a chunk,
     252 a render, as the studio scene; the widths' images agree; a 48 x 36
     render on the card against the CPU's;
 14. the gallery scene under ao, 1 spp, 25 directions: 2 launches a chunk
     (65,536 closest-hit rays, then one any-hit launch of 1,638,400), 6 a
     render; that any-hit launch against its plain version, in chunks and
     whole, with times; 48 x 36 card against CPU;
 15. the gallery scene under whitted, 1 spp, max_ray_depth 3 (15 nodes;
     depth 5's 63 nodes take a minute a pass): a node's 3 lights x (4
     punch-through rounds + 1 BSDF-side intersect) and the trace that made
     it, 240 launches a chunk, 720 a render; 48 x 36 card against CPU;
 16. the gallery scene under light_tracing (t1), 1 spp: 12 chunks of 16,384
     paths x (4 walk traces + 5 camera connections) = 108 launches; 48 x 36
     card against CPU (the film scatter adds in another order on the card,
     within the image bar), and the t0 and s1 estimators against t1 there
     (image means within 30% / 10%);
 17. the studio scene under bdpt, 512 x 384, 1 spp, depth 5, through
     render_context at width 8: 3 chunks of 65,536 camera samples x (2 x 5
     walk intersects + 1 + 2 + 3 + 4 + 5 connections) = 75 launches; 48 x
     36 card against CPU; BDPT against PT at 48 x 36 on the card on
     tests/test_bdpt.py's scene (image means within its 15%), and on the
     studio scene, where goblin_tpu's two estimators disagree (ROADMAP
     Queue 3), BDPT's mean held 8-30% above PT's;
 18. examples/bunny_sky.json (the studio scene under an image-based light)
     with path_tracing at 512 x 384, 4 spp, depth 5 at widths 8 and 4: 21
     launches a chunk, 252 a render, as the studio scene; the map's
     light-pick probability; 48 x 36 card against CPU under path_tracing,
     light_tracing, bdpt, sppm (1 iteration) and whitted (depth 2);
 19. examples/bunny_fog.json (the studio scene in a homogeneous fog, the
     glass bunny a jade subsurface material) with path_tracing at 512 x
     384, 4 of 16 spp, depth 5 at widths 8 and 4: the studio scene's 21
     launches a chunk + 4 BSSRDF trace calls x 4 samples at the camera hit +
     2 in-scatter shadow rays x 5 volume samples = 47, 564 a render; the
     widths' images agree; whitted at depth 3 (no glass, so a reflection
     child alone: 4 nodes x (1 + 16 + 3 lights x 5) = 128 launches a chunk);
     48 x 36 card against CPU under all six methods; the CLI on the scene
     as shipped, which writes bunny_fog.ppm after bloom and tone mapping;
 20. examples/bunny_smoke.json (the studio scene with a heterogeneous smoke
     grid around the bunnies and a marble subsurface bunny) with
     path_tracing at 512 x 384, 4 spp, depth 5: 21 + 16 + one shadow ray a
     march step (march_steps of the grid) a chunk; 48 x 36 card against
     CPU;
 21. bunny.json's gradients: mean(L * [1, 2, 3]) over one sample of each
     pixel at 512 x 384, depth 5, and its gradients with respect to the
     light colour, tex_const and tri_rows, backward chunk by chunk (65,536
     pixels), at trace widths 8, 4 and 1: finite gradients that agree
     between widths, 8 launches a chunk in the forward and none in the
     backward (24 a pass), the light colour's gradient against a central
     finite difference at full size (within 1e-3 rel), and at 48 x 36 the
     card's gradients against the CPU's; forward and forward + backward
     seconds, peak memory a chunk;
 22. the train step on the gallery scene at 512 x 384, depth 5: 3 steps of
     plain SGD on (light colours, tex_atlas) through make_train_step in
     chunks of 65,536 pixel ids, each step's loss change against its
     first-order prediction -eta |g|^2 (eta moving the loss by about 1%)
     within 5%, 21 launches a chunk; then mesh_boundary_grad on the card
     over tests/test_edge_grad.py's tetrahedron sweep against the CPU's
     within 1e-5 rel;
 23. the regenerative driver (pool 65,536) on bunny.json at 512 x 384, 4
     spp, depth 5, at trace widths 8, 4 and 1, against the chunked driver
     in turns on one loaded scene: 2 launches an iteration, the images
     within the bar of each other, seconds a pass of both; through
     render_context(regen=True) at each width, and one render under the
     profiler: one device-to-host read an iteration; 48 x 36 card against
     CPU; the studio, sky and fog-without-BSSRDF scenes (1 + 4 punch-through
     launches an iteration, and the volume's 2 a sample), against the
     chunked driver; the fog scene as shipped through
     render_context(regen=True) takes the chunked driver (its BSSRDF), with
     its launches; iterations, useful segments and each iteration's share
     of live lanes;
 24. an NCCL process group joined as parallel/multihost.init_from_env
     joins it, one rank a card, world min(2, cards): on one card the group
     of world 1 in this process, on more two ranks in child processes (this
     script with --sharded-rank, started by multihost.launch_local) whose
     results must agree: render_sharded_dense and render_sharded of bunny
     at 1 spp against common.render (8 launches a chunk of a rank's share),
     make_sharded_train_step on the gallery scene against make_train_step
     at the gradient bars (21 launches a chunk); every group is destroyed;
 25. the measuring programs of bench_torch.py at 512 x 384, each
     subcommand's function once, their JSON lines printed: pt (bench.py's
     line: 24 launches a pass, 8 dispatched lane-rays a lane-sample, and
     its census on a 48 x 36 film on the card equal to the CPU's), methods
     (SPPM, BDPT, light tracing at 2 spp with bench_methods.py's lane-ray
     counts), scaling (the prebuilt pass against render_sharded_dense on a
     one-rank NCCL group, images within 1e-5) and trace (the 8 wavefront
     classes of pass 0 over the whole frame at widths 8, 4 and 1, hit
     masks equal to width 8's, t within 1e-4 rel).
 26. the entry points of goblin_tpu_torch/entry.py (__graft_entry__.py's
     counterpart): entry()'s fn on its 1,024 example pixel ids and on
     65,536, each call 38 launches of the width-8 kernel (bunny.json's own
     depth 20: 1 + 2 x 18 + 1), seconds a call, against entry(device=
     "cpu")'s fn on the example ids and on 1,024 ids strided over the film
     at the image bar; dryrun_multichip(min(2, cards)) on the cards (its
     line, each rank's backend and launches; world 1 on a machine of one
     card); the fog scene's gradient pass (phase 21's loss and bars) at 48
     x 36, card against CPU, its forward launches a chunk those of phase
     19 and none in the backward.
 27. the sample hash's kernel (csrc/rng_hash.cu) against its int64 form on
     the main path's call (an int sample index, int32 pixel ids) at 16,384,
     65,536 and 196,608 lanes, bit for bit, each timed beside the int64
     form; its launches in phase 5 (one a hash call, 92 a pass) and over
     the whole run, beside the hash's calls (the CPU's calls launch none).
 28. SPPM's drain kernels (csrc/sppm_drain.cu: the match's count and fill
     passes, the ordered sum) against their plain forms on bunny.json as
     shipped at full size, iteration 5's first photon chunk, bit for bit,
     each timed from its entry beside its plain form and its bound in
     bytes; the whole drain in pair form against the loop on the same
     tensors, bit for bit, with the wall time of each; phase 8's drains
     all through the kernels (one count pass a drain).
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

try:
    # the timing and bound of a kernel launch, shared with bench_torch.py
    from goblin_tpu_torch.bench import (KERNEL_REPS, PEAK_BYTES_S, bound,
                                        nvidia_smi, table_bytes, time_ms)
except ImportError as e:
    sys.exit(f"chip_smoke: FAILED: goblin_tpu_torch is not beside this "
             f"script: {e}")

REPO = os.path.dirname(os.path.abspath(__file__))
BUNNY = os.path.join(REPO, "examples", "bunny.json")
STUDIO = os.path.join(REPO, "examples", "bunny_studio.json")
GALLERY = os.path.join(REPO, "examples", "bunny_gallery.json")
SKY = os.path.join(REPO, "examples", "bunny_sky.json")
FOG = os.path.join(REPO, "examples", "bunny_fog.json")
SMOKE = os.path.join(REPO, "examples", "bunny_smoke.json")
SETTINGS = {"render_method": "path_tracing", "max_ray_depth": 5,
            "sample_per_pixel": 4}
CHUNK = 1 << 16
EXPECTED_LAUNCHES = 8 * 3 * 4
# phase 8: bunny.json's own settings but 4 of its 100 iterations
SPPM_ITERATIONS = 4
# phase 12: the studio scene's SPPM iterations
STUDIO_SPPM_ITERATIONS = 2
# closest-hit rounds of a shadow ray where the scene has a mask material
# (scene/intersect.py occluded_attenuated's max_punch)
MAX_PUNCH = 4
# phases 14-16 on the gallery scene
AO_DIRECTIONS = 25
WHITTED_DEPTH = 3
LT_CHUNK = 1 << 14
# phase 16's estimator cross-check at 48 x 36: paths of each estimator (few
# light paths find the 2 cm lens, so t0 takes the most) in chunks of
LT_CHECK_SPP = {"t1": 64, "s1": 64, "t0": 2400}
LT_CHECK_CHUNK = 1 << 18
LT_CHECK_RTOL = {"s1": 0.10, "t0": 0.30}
# phase 17: BDPT on the studio scene, and its cross-check against PT at
# 48 x 36 on tests/test_bdpt.py's scene, at that test's spp and tolerance;
# on the studio scene, (BDPT - PT) / PT within a band around the 0.157 and
# 0.184 of two runs on the card, so that a drift of either estimator shows
BDPT_SETTINGS = {"render_method": "bdpt", "sample_per_pixel": 1,
                 "max_ray_depth": 5}
BDPT_CHECK_SPP = {"bdpt": 16, "path_tracing": 32}
BDPT_CHECK_RTOL = 0.15
BDPT_STUDIO_GAP = (0.08, 0.30)
# phase 18: the sky scene's 48 x 36 checks, one per method
SKY_CHECKS = ({"render_method": "path_tracing", "sample_per_pixel": 1,
               "max_ray_depth": 5},
              {"render_method": "light_tracing", "sample_per_pixel": 1},
              dict(BDPT_SETTINGS),
              {"render_method": "sppm", "sample_per_pixel": 1,
               "max_ray_depth": 5},
              {"render_method": "whitted", "sample_per_pixel": 1,
               "max_ray_depth": 2})
# phase 19: the fog scene's Whitted depth, and its 48 x 36 checks under the
# six methods
FOG_WHITTED_DEPTH = 3
FOG_CHECKS = SKY_CHECKS + ({"render_method": "ao", "sample_per_pixel": 1},)


# phase 21: bunny.json's gradient pass, at every trace width
GRAD_SETTINGS = {"render_method": "path_tracing", "max_ray_depth": 5,
                 "sample_per_pixel": 1}
GRAD_WEIGHTS = (1.0, 2.0, 3.0)
GRAD_WIDTHS = (8, 4, 1)
# a light colour channel's central difference: its value times
FD_STEP = 0.25
FD_RTOL = 1e-3
# phase 22: SGD steps on the gallery scene, each step's eta chosen to move
# the loss by TRAIN_MOVE, the move held to its first-order prediction
TRAIN_STEPS = 3
TRAIN_MOVE = 0.01
TRAIN_RTOL = 5e-2
# and tests/test_edge_grad.py's tetrahedron sweep, card against CPU
EDGE_SWEEP = (-0.05, 0.0, 0.12, 0.3)
# phase 23: the regenerative driver's trace widths on bunny.json
REGEN_WIDTHS = (8, 4, 1)
EDGE_RTOL = 1e-5
# phase 25: bench_methods.py's lane-rays at 2 spp, 512 x 384, depth 5, and
# the images of bench_scaling.py's check
BENCH_LANE_RAYS = {"sppm": 5_505_024, "bdpt": 13_762_560,
                   "light_tracing": 3_932_160}
BENCH_MAXDIFF = 1e-5
# phase 26: entry()'s batches (its example ids, and a chunk), its launches a
# call at bunny.json's depth 20, the calls timed a batch
ENTRY_BATCHES = (1024, CHUNK)
ENTRY_LAUNCHES = 1 + 2 * 18 + 1
ENTRY_REPS = 3
# the strided ids of the card-vs-CPU check (the example ids, the film's top
# two rows, see almost only black) and their sample
ENTRY_STRIDE = 192
ENTRY_CHECK_SAMPLE = 3


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


def ptxas_numbers(log):
    """What ptxas -v said of each entry function in a build's output ->
    {"production" | "stats": {registers, shared_bytes, stack_frame_bytes,
    spill_bytes}}; the stats instance is the template's <true>."""
    out = {}
    for name, numbers in ptxas_by_entry(log).items():
        out.setdefault("stats" if "ILb1E" in name else "production",
                       {}).update(numbers)
    return out


def ptxas_by_entry(log):
    """What ptxas -v said of each entry function in a build's output ->
    {mangled name: {registers, shared_bytes, stack_frame_bytes,
    spill_bytes}}."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = out.setdefault(m.group(1), {})
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


def wavefronts(scene, meta):
    """Full-frame primary, bounce-1 continuation and bounce-1 shadow rays
    of pass 0, made by the port's raygen, intersect, BSDF and light code
    with the path tracer's sample dimensions (lens samples for a thin lens,
    light samples where a light reads them, the mask pick where the scene
    has a mask)."""
    import torch

    from goblin_tpu_torch.core.rng import hash_uniform
    from goblin_tpu_torch.integrators import common, direct, path
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
    ls = lt.sample_li(scene["lights"], direct.em_tri_data(scene), lid, p, eps,
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
    from goblin_tpu_torch.integrators import direct
    from goblin_tpu_torch.lights import lights as lt

    dev = scene["tri_rows"].device
    ids = torch.arange(sppm.PHOTON_CHUNK, dtype=torch.int32, device=dev)

    def u(dim):
        return hash_uniform(seed + 77, ids, 0, 0, dim)

    lid, _ = lt.pick_light(scene["lights"], u(sp.DIM_PICK))
    em = lt.sample_emission(scene["lights"], direct.em_tri_data(scene), lid,
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
    row.update(bound(n, table_bytes(scene1, tt.BIN_TABLES), 2 * census[0],
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
    trace width 1 and 8, in turns (1, 8, 8, 1): render_sppm steps
    sppm.make_sppm's iteration, 61 trace launches (one light walk of all
    6 photon chunks) and one device read a photon chunk's drain (6) an
    iteration. Returns {width: launches}."""
    import numpy as np
    import torch

    from goblin_tpu_torch import telemetry
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
            reads0 = telemetry.counters.get("sppm.drain_reads", 0)
            turns0 = telemetry.counters.get("sppm.drain_turns", 0)
            walks0 = telemetry.counters.get("sppm.photon_walks", 0)
            t0 = time.perf_counter()
            img, meta = render_context(BUNNY, ovr, device="cuda",
                                       report=report, trace_wide=wide)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            launches = dict(tt.launches)
            reads = telemetry.counters["sppm.drain_reads"] - reads0
            walks = telemetry.counters["sppm.photon_walks"] - walks0
            turns = telemetry.counters["sppm.drain_turns"] - turns0
            img = img.cpu().numpy()
            max_len = meta.settings["max_ray_depth"]
            spec = meta.camera.film
            n_pix = spec.x_res * spec.y_res
            n_chunks = -(-n_pix // sppm.PHOTON_CHUNK)
            # one light walk of all the chunks an iteration: the card's
            # free memory holds it
            per_it = 1 + 2 * max_len + max_len
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
                  f"pass + 1 walk of {n_chunks} chunks x {max_len} photon "
                  f"bounces); walks {walks}, device reads {reads} "
                  f"({n_chunks} an iteration expected), "
                  f"drain turns {turns}; "
                  f"image mean {img.mean():.6f} max {img.max():.4f}",
                  flush=True)
            check(img.shape == (384, 512, 3), f"image shape {img.shape}")
            check(np.isfinite(img).all(), f"width {wide}: non-finite pixels")
            check(img.mean() > 0, f"width {wide}: image is black")
            check(launches == want, f"width {wide}: launches {launches}, "
                                    f"expected {want}")
            check(walks == SPPM_ITERATIONS,
                  f"width {wide}: {walks} photon walks, expected "
                  f"{SPPM_ITERATIONS}")
            check(reads == n_chunks * SPPM_ITERATIONS,
                  f"width {wide}: {reads} drain reads, expected "
                  f"{n_chunks * SPPM_ITERATIONS}")
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
    # trace a bounce of the one light walk of all the chunks
    per_it = 1 + 2 * max_len + max_len
    its = np.diff([t0] + marks)
    print(f"  width {wide}: {spec.x_res}x{spec.y_res} depth {max_len}, "
          f"initial radius {meta.settings['initial_radius']}; seconds per "
          f"iteration "
          f"{' '.join(f'{s:.3f}' for s in its)} (the first with the load); "
          f"launches {launches} (expected {per_it} per iteration: 1 + 2 x "
          f"{max_len} ray pass + 1 walk of {n_chunks} chunks x {max_len} "
          f"photon bounces); image mean {img.mean():.6f} max "
          f"{img.max():.4f}", flush=True)
    check(img.shape == (384, 512, 3), f"image shape {img.shape}")
    check(np.isfinite(img).all(), "studio SPPM image has non-finite pixels")
    check(img.mean() > 0, "studio SPPM image is black")
    check(launches == no_launches(
        **{f"trace_bvh{wide}": per_it * STUDIO_SPPM_ITERATIONS}),
        f"studio SPPM launches {launches}, expected {per_it} per iteration "
        f"of trace_bvh{wide} and no other")
    return launches, float(its[-1])


def small_film(meta, x_res=48, y_res=36):
    meta.camera = dataclasses.replace(
        meta.camera,
        film=dataclasses.replace(meta.camera.film, x_res=x_res, y_res=y_res))


def render_loaded(scene, meta, **kw):
    """What render_context does with a loaded scene: the splatting methods
    through splatting.render_dispatch, the others through common.render."""
    from goblin_tpu_torch import render, splatting
    from goblin_tpu_torch.integrators import common

    method = meta.settings["render_method"]
    if method in render.SPLAT_METHODS:
        return splatting.render_dispatch(scene, meta, method)
    return common.render(scene, meta, render.make_li(meta), **kw)


PT_CHECK = dict(SETTINGS, sample_per_pixel=1)
SPPM_CHECK = {"render_method": "sppm", "sample_per_pixel": 2,
              "max_ray_depth": 5}


def reference_check(overrides, path=GALLERY, wide=8, regen=False):
    """Phases 4, 9, 11-16 and 23: a 48 x 36 render of overrides' method (by
    the regenerative driver with regen) on the card against the plain CPU
    path, within the image bar."""
    import numpy as np

    from goblin_tpu_torch.integrators.wavefront import render_wavefront
    from goblin_tpu_torch.scene.loader import load_scene

    images = []
    for device in ("cpu", "cuda"):
        scene, meta = load_scene(path, overrides, device=device,
                                 trace_wide=wide)
        small_film(meta)
        img = (render_wavefront(scene, meta, pool=CHUNK) if regen
               else render_loaded(scene, meta))
        images.append(img.cpu().numpy())
    cpu, gpu = images
    close = (np.abs(gpu - cpu) <= 1e-4 + 1e-3 * np.abs(cpu)).all(axis=-1)
    rel_mean = abs(gpu.mean() - cpu.mean()) / cpu.mean()
    print(f"  48x36 {overrides}, width {wide}"
          f"{', regenerative' if regen else ''}: pixels within 1e-4 + 1e-3 rel "
          f"{close.mean():.4f}, mean card {gpu.mean():.6f} cpu "
          f"{cpu.mean():.6f} (rel diff {rel_mean:.2e})", flush=True)
    check(np.isfinite(gpu).all(), "card image has non-finite pixels")
    check(cpu.mean() > 0, "CPU image is black")
    check(close.mean() >= 0.99, f"{overrides}: card and CPU images disagree")
    check(rel_mean <= 1e-3, f"{overrides}: card and CPU image means disagree")


def counted_render(path, overrides, wide=8, **kw):
    """One render through render_context with the launch counters read
    around it -> (image, meta, launches, seconds of each report)."""
    import numpy as np
    import torch

    from goblin_tpu_torch.ops import trace as tt
    from goblin_tpu_torch.render import render_context

    marks = []

    def report(done, total):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    torch.cuda.synchronize()
    tt.reset_launches()
    t0 = time.perf_counter()
    img, meta = render_context(path, overrides, device="cuda", report=report,
                               trace_wide=wide, **kw)
    torch.cuda.synchronize()
    launches = dict(tt.launches)
    img = img.cpu().numpy()
    spec = meta.camera.film
    check(img.shape == (spec.y_res, spec.x_res, 3), f"image shape {img.shape}")
    check(np.isfinite(img).all(), f"{overrides}: non-finite pixels")
    check(img.mean() > 0, f"{overrides}: image is black")
    return img, meta, launches, np.diff([t0] + marks)


def check_gallery(meta):
    check(meta.has_perturb and meta.has_null and not meta.all_delta_lights
          and not meta.camera.is_delta and meta.n_lights == 3
          and meta.light_sample_nums == (1, 1, 1)
          and meta.material_kinds == (0, 1, 2, 3, 5),
          "the gallery scene lost a feature")


def gallery_main_path():
    """Phase 13: the gallery scene's path tracing through render_context at
    trace widths 8 and 4, in turns. Returns {width: launches}."""
    import numpy as np

    images, counts, steady = {}, {}, {4: [], 8: []}
    for turn, wide in enumerate((8, 4, 4, 8)):
        img, meta, launches, passes = counted_render(
            GALLERY, SETTINGS, wide, chunk_size=CHUNK)
        check_gallery(meta)
        spec = meta.camera.film
        spp = meta.settings["sample_per_pixel"]
        depth = meta.settings["max_ray_depth"]
        per_chunk = studio_launches_per_chunk(depth)
        want = per_chunk * -(-spec.x_res * spec.y_res // CHUNK) * spp
        steady[wide].append(float(np.mean(passes[1:])))
        print(f"  turn {turn + 1}, width {wide}: {spec.x_res}x{spec.y_res} "
              f"{spp} spp depth {depth}: seconds per pass "
              f"{' '.join(f'{p:.4f}' for p in passes)} (the first with the "
              f"load); passes 2-{spp}: {steady[wide][-1]:.4f} s/pass; "
              f"launches {launches} (expected {want}: {per_chunk} a chunk); "
              f"image mean {img.mean():.6f} max {img.max():.4f}", flush=True)
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
    check(close.mean() >= 0.99, "width-4 and width-8 gallery images disagree")
    check(rel_mean <= 1e-3, "width-4 and width-8 gallery image means disagree")
    return counts


def ao_path():
    """Phase 14: the gallery scene under ao, and K1's any-hit on the launch
    its first chunk makes. Returns (launches, the launch's numbers)."""
    import torch

    from goblin_tpu_torch.ops import trace as tt
    from goblin_tpu_torch.scene import intersect as scn

    ovr = {"render_method": "ao", "sample_per_pixel": 1}
    caught = []
    trace_rays = scn.trace_rays

    def catching(scene, meta, o, d, mint, maxt, any_hit=False):
        if any_hit and not caught:
            caught.append((scene, [o, d, mint, maxt]))
        return trace_rays(scene, meta, o, d, mint, maxt, any_hit=any_hit)

    scn.trace_rays = catching
    try:
        img, meta, launches, passes = counted_render(GALLERY, ovr,
                                                     chunk_size=CHUNK)
    finally:
        scn.trace_rays = trace_rays
    check_gallery(meta)
    spec = meta.camera.film
    n_dir = meta.settings["ao_sample_num"]
    want = 2 * -(-spec.x_res * spec.y_res // CHUNK)
    print(f"  {spec.x_res}x{spec.y_res} 1 spp, {n_dir} directions: "
          f"{passes[0]:.4f} s with the load; launches {launches} (expected "
          f"{want}: a closest-hit and an any-hit launch a chunk); image mean "
          f"{img.mean():.6f}", flush=True)
    check(n_dir == AO_DIRECTIONS, f"ao_sample_num {n_dir}")
    check(launches == no_launches(trace_bvh8=want),
          f"ao launches {launches}, expected {want} of trace_bvh8")
    # the first chunk's any-hit launch, as the path made it
    scene, rays = caught[0]
    rays = [r.contiguous() for r in rays]
    n = rays[0].shape[0]
    check(n == CHUNK * AO_DIRECTIONS, f"the any-hit launch has {n} rays")
    full = tt.trace(scene, *rays, any_hit=True)
    chunks = chunked(tt.trace, scene, rays, True)
    plain = tt.trace_plain(scene, *rays, any_hit=True)
    torch.cuda.synchronize()
    check(torch.equal(full[0], chunks[0]),
          "ao: chunked and whole any-hit launches differ")
    check(torch.equal(full[0], plain[0]),
          f"ao: any-hit differs from the plain version on "
          f"{int((full[0] != plain[0]).sum())} of {n} rays")
    live = (rays[2] < rays[3]).float().mean().item()
    out = {"rays": n, "live_share": live, "hits": int(full[0].sum()),
           "ms": time_ms(lambda: tt.trace(scene, *rays, any_hit=True),
                         KERNEL_REPS),
           "ms_in_chunks": time_ms(lambda: chunked(tt.trace, scene, rays,
                                                   True), KERNEL_REPS),
           "plain_ms": time_ms(lambda: tt.trace_plain(scene, *rays,
                                                      any_hit=True), 1)}
    # its bound, from the plain version's census of the walk these rays need
    _, work = tt.trace_plain(scene, *rays, any_hit=True, census=True)
    work = [int(v) for v in work.sum(dim=0)]
    out.update(bound(n, table_bytes(scene, tt.wide_tables(8)), work[2],
                     work[3], out["ms"]))
    print(f"  any-hit launch of chunk 0: census {work[0]} inner and {work[1]} "
          f"leaf visits, {work[2]} box and {work[3]} triangle tests; bound "
          f"{out['bound_ms']:.5f} ms ({out['bound_by']}), "
          f"{out['roofline_share']:.4f} of it reached", flush=True)
    print(f"  any-hit launch of chunk 0: rays {n} live {live:.4f} hits "
          f"{out['hits']}, bit-equal to the plain version and to "
          f"{n // CHUNK} launches of {CHUNK}; K1 {out['ms']:.4f} ms "
          f"({out['ms_in_chunks']:.4f} ms in chunks), plain "
          f"{out['plain_ms']:.2f} ms; "
          f"{tt.launch_blocks('trace_bvh8', n)} persistent blocks",
          flush=True)
    return launches, out, float(passes[0])


def whitted_launches_per_chunk(depth, sample_nums):
    """Trace launches Whitted makes for one chunk of the gallery scene: a
    full binary tree of 2^(depth + 1) - 1 nodes (the scene has glass), each
    made by one trace, and at each node for every light sample MAX_PUNCH
    punch-through rounds of the shadow ray and one BSDF-side intersect."""
    nodes = 2 ** (depth + 1) - 1
    return nodes * (1 + sum(sample_nums) * (MAX_PUNCH + 1))


def whitted_path():
    """Phase 15: the gallery scene under whitted. Returns (launches, s)."""
    ovr = {"render_method": "whitted", "sample_per_pixel": 1,
           "max_ray_depth": WHITTED_DEPTH}
    img, meta, launches, passes = counted_render(GALLERY, ovr,
                                                 chunk_size=CHUNK)
    check_gallery(meta)
    spec = meta.camera.film
    depth = meta.settings["max_ray_depth"]
    per_chunk = whitted_launches_per_chunk(depth, meta.light_sample_nums)
    want = per_chunk * -(-spec.x_res * spec.y_res // CHUNK)
    print(f"  {spec.x_res}x{spec.y_res} 1 spp, max_ray_depth {depth} (the "
          f"scene asks for 5, whose {2 ** 6 - 1} nodes take "
          f"{whitted_launches_per_chunk(5, meta.light_sample_nums)} launches "
          f"a chunk): {2 ** (depth + 1) - 1} nodes, {passes[0]:.3f} s with the "
          f"load; launches {launches} (expected {want}: {per_chunk} a "
          f"chunk); image mean {img.mean():.6f} max {img.max():.4f}",
          flush=True)
    check(launches == no_launches(trace_bvh8=want),
          f"whitted launches {launches}, expected {want} of trace_bvh8")
    return launches, float(passes[0])


def light_tracing_path():
    """Phase 16: the gallery scene under light_tracing. Returns (launches,
    s)."""
    ovr = {"render_method": "light_tracing", "sample_per_pixel": 1}
    img, meta, launches, chunks_s = counted_render(GALLERY, ovr)
    check_gallery(meta)
    spec = meta.camera.film
    depth = meta.settings["max_ray_depth"]
    n_chunks = -(-spec.x_res * spec.y_res // LT_CHUNK)
    # a chunk: the walk's depth - 1 closest-hit traces, then a connection
    # of the light vertex and of each surface vertex
    per_chunk = (depth - 1) + depth
    check(len(chunks_s) == n_chunks, f"{len(chunks_s)} chunks reported")
    print(f"  {spec.x_res}x{spec.y_res} 1 spp depth {depth}, strategy "
          f"{meta.settings['lt_strategy']}: {n_chunks} chunks of {LT_CHUNK} "
          f"paths, {chunks_s[0]:.3f} s the first with the load, "
          f"{chunks_s[1:].mean():.4f} s a chunk after, {chunks_s.sum():.3f} s "
          f"the render; launches {launches} (expected "
          f"{per_chunk * n_chunks}: {per_chunk} a chunk); image mean "
          f"{img.mean():.6f} max {img.max():.4f}", flush=True)
    check(launches == no_launches(trace_bvh8=per_chunk * n_chunks),
          f"light tracing launches {launches}, expected "
          f"{per_chunk * n_chunks} of trace_bvh8")
    return launches, float(chunks_s[1:].sum())


def light_tracing_estimators():
    """Phase 16: the t0 and s1 estimators against t1 at 48 x 36 on the
    card, as goblin_tpu's tests hold them to one another: image means."""
    from goblin_tpu_torch import splatting
    from goblin_tpu_torch.scene.loader import load_scene

    scene, meta = load_scene(GALLERY, {"render_method": "light_tracing"},
                             device="cuda")
    small_film(meta)
    means = {}
    for strategy, spp in LT_CHECK_SPP.items():
        t = time.perf_counter()
        img = splatting.render_light_tracer(
            scene, meta, chunk_size=LT_CHECK_CHUNK, spp=spp,
            strategy=strategy)
        means[strategy] = img.mean().item()
        print(f"  48x36 {strategy}: {spp * 48 * 36} paths in chunks of "
              f"{LT_CHECK_CHUNK}, {time.perf_counter() - t:.2f} s, image "
              f"mean {means[strategy]:.6f}", flush=True)
    for strategy, rtol in LT_CHECK_RTOL.items():
        rel = abs(means[strategy] - means["t1"]) / means["t1"]
        print(f"  {strategy} vs t1: means differ by {rel:.4f} (allowed "
              f"{rtol})", flush=True)
        check(rel <= rtol, f"light tracing {strategy} and t1 disagree: "
                           f"{means[strategy]} vs {means['t1']}")


def bdpt_launches_per_chunk(depth):
    """Trace launches BDPT makes for one chunk: depth closest-hit intersects
    of each walk, then one any-hit connection for every strategy with s >=
    1 and t >= 1, path length L having L of them."""
    return 2 * depth + depth * (depth + 1) // 2


def bdpt_path():
    """Phase 17: the studio scene under bdpt through render_context.
    Returns (launches, seconds of the chunks)."""
    from goblin_tpu_torch.integrators import bdpt

    img, meta, launches, chunks_s = counted_render(STUDIO, BDPT_SETTINGS)
    spec = meta.camera.film
    depth = meta.settings["max_ray_depth"]
    n_chunks = -(-spec.x_res * spec.y_res // CHUNK)
    per_chunk = bdpt_launches_per_chunk(depth)
    check(len(chunks_s) == n_chunks, f"{len(chunks_s)} chunks reported")
    check(meta.has_lens and not meta.camera.is_delta,
          "the studio scene lost its lens")
    print(f"  {spec.x_res}x{spec.y_res} 1 spp depth {depth}, {n_chunks} "
          f"chunks of {CHUNK} camera samples: seconds a chunk "
          f"{' '.join(f'{c:.3f}' for c in chunks_s)} (the first with the "
          f"load), {chunks_s.sum():.3f} s the pass; launches {launches} "
          f"(expected {per_chunk * n_chunks}: {per_chunk} a chunk); image "
          f"mean {img.mean():.6f} max {img.max():.4f}; default chunk "
          f"{bdpt.render_bdpt.__defaults__[0]}", flush=True)
    check(launches == no_launches(trace_bvh8=per_chunk * n_chunks),
          f"bdpt launches {launches}, expected {per_chunk * n_chunks} of "
          "trace_bvh8")
    return launches, chunks_s


def bdpt_plane_scene(out_dir):
    """tests/test_bdpt.py's scene (a floor under a small area light, depth
    3, 48 x 36) written into out_dir -> its path."""
    doc = {
        "render_setting": {"render_method": "bdpt", "sample_per_pixel": 1,
                           "max_ray_depth": 3},
        "camera": {"position": [0, 1.4, -2.4], "euler": [20, 0, 0],
                   "rotation_order": "xyz", "fov": 48.0,
                   "film": {"resolution": [48, 36]},
                   "filter": {"type": "box", "width": [0.5, 0.5]}},
        "geometries": [{"name": "floor", "type": "mesh",
                        "file": "plane.obj"}],
        "textures": [{"format": "color", "name": "grey", "type": "constant",
                      "color": [0.65, 0.65, 0.65]}],
        "materials": [{"name": "diffuse", "type": "lambert", "Kd": "grey"}],
        "primitives": [{"type": "model", "name": "fm", "geometry": "floor",
                        "material": "diffuse"},
                       {"type": "instance", "name": "fi", "model": "fm",
                        "scale": [30, 30, 30]}],
        "lights": [{"name": "panel", "type": "area",
                    "radiance": [25, 25, 25], "geometry": "floor",
                    "position": [0.0, 2.2, 0.2], "euler": [180.0, 0.0, 0.0],
                    "scale": [0.35, 0.35, 0.35]}],
    }
    with open(os.path.join(out_dir, "plane.obj"), "w") as f:
        f.write("v -1 0 1\nv 1 0 1\nv -1 0 -1\nv 1 0 -1\n"
                "vn 0 1 0\nf 1//1 2//1 3//1\nf 3//1 2//1 4//1\n")
    path = os.path.join(out_dir, "plane.json")
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


def bdpt_against_pt(path, band):
    """Phase 17: BDPT and PT on the card at 48 x 36 -> (BDPT - PT) / PT of
    the image means, held within band."""
    from goblin_tpu_torch.integrators import bdpt, common
    from goblin_tpu_torch.render import make_li
    from goblin_tpu_torch.scene.loader import load_scene

    means = {}
    for method, spp in BDPT_CHECK_SPP.items():
        scene, meta = load_scene(path, {"render_method": method},
                                 device="cuda")
        small_film(meta)
        t = time.perf_counter()
        if method == "bdpt":
            img = bdpt.render_bdpt(scene, meta, spp=spp)
        else:
            img = common.render(scene, meta, make_li(meta), spp=spp)
        means[method] = img.mean().item()
        print(f"  48x36 {os.path.basename(path)} depth "
              f"{meta.settings['max_ray_depth']}, {method} {spp} spp: "
              f"{time.perf_counter() - t:.2f} s, image mean "
              f"{means[method]:.6f}", flush=True)
    gap = (means["bdpt"] - means["path_tracing"]) / means["path_tracing"]
    print(f"  bdpt vs path_tracing: (bdpt - pt) / pt = {gap:.4f} "
          f"(allowed {band[0]} to {band[1]})", flush=True)
    check(band[0] <= gap <= band[1],
          f"bdpt and path tracing out of their band: {means}")
    return gap


def sky_path():
    """Phase 18: the sky scene's path tracing at widths 8 and 4. Returns
    {width: launches}."""
    counts = {}
    for wide in (8, 4):
        img, meta, launches, passes = counted_render(SKY, SETTINGS, wide,
                                                     chunk_size=CHUNK)
        check(meta.has_env and meta.has_null and not meta.all_delta_lights,
              "the sky scene lost a feature")
        spec = meta.camera.film
        spp = meta.settings["sample_per_pixel"]
        per_chunk = studio_launches_per_chunk(meta.settings["max_ray_depth"])
        want = per_chunk * -(-spec.x_res * spec.y_res // CHUNK) * spp
        print(f"  width {wide}: {spec.x_res}x{spec.y_res} {spp} spp: seconds "
              f"per pass {' '.join(f'{p:.4f}' for p in passes)} (the first "
              f"with the load); launches {launches} (expected {want}: "
              f"{per_chunk} a chunk); image mean {img.mean():.6f} max "
              f"{img.max():.4f}", flush=True)
        check(launches == no_launches(**{f"trace_bvh{wide}": want}),
              f"sky width {wide}: launches {launches}, expected {want} of "
              f"trace_bvh{wide} and no other")
        counts[wide] = launches
    return counts


def env_pick_probability(path=SKY):
    """The image-based light's share of the light-pick CDF."""
    from goblin_tpu_torch.scene.loader import load_scene

    scene, meta = load_scene(path, device="cuda")
    power = scene["lights"]["power"]
    share = float(power[meta.env_light_id] / power.sum())
    print(f"  the map's light-pick probability {share:.4f} (powers "
          f"{[round(float(v), 4) for v in power]})", flush=True)
    check(0.2 <= share <= 0.8, f"env pick probability {share}")


def medium_launches_per_chunk(meta):
    """Trace launches the path tracer adds to a chunk for subsurface
    materials and a volume: the BSSRDF's 4 trace calls (exit, its shadow
    ray, probe, its shadow ray) for each of bssrdf_sample_num samples at the
    camera hit, and the volume's any-hit shadow rays: 2 for each
    homogeneous sample (equi-angular and distance), or one a march step."""
    from goblin_tpu_torch.integrators.volume import march_steps

    n = 4 * meta.settings["bssrdf_sample_num"] if meta.has_bssrdf else 0
    vol = meta.volume
    if vol is not None:
        n += (2 * max(1, vol.sample_num) if vol.kind == "homogeneous"
              else march_steps(vol))
    return n


def medium_path(path, widths, kind):
    """Phases 19 and 20: a scene with subsurface materials and a volume of
    the kind, path-traced at 512 x 384, 4 spp, depth 5 through
    render_context at each width. Returns ({width: launches}, {width:
    steady seconds a pass})."""
    import numpy as np

    images, counts, steady = {}, {}, {}
    for wide in widths:
        img, meta, launches, passes = counted_render(path, SETTINGS, wide,
                                                     chunk_size=CHUNK)
        check(meta.has_bssrdf and meta.volume is not None
              and meta.volume.kind == kind and meta.has_null
              and not meta.all_delta_lights, f"{path}: a feature is lost")
        spec = meta.camera.film
        spp = meta.settings["sample_per_pixel"]
        depth = meta.settings["max_ray_depth"]
        per_chunk = (studio_launches_per_chunk(depth)
                     + medium_launches_per_chunk(meta))
        want = per_chunk * -(-spec.x_res * spec.y_res // CHUNK) * spp
        steady[wide] = float(np.mean(passes[1:]))
        print(f"  width {wide}: {spec.x_res}x{spec.y_res} {spp} spp depth "
              f"{depth}: seconds per pass "
              f"{' '.join(f'{p:.4f}' for p in passes)} (the first with the "
              f"load); launches {launches} (expected {want}: {per_chunk} a "
              f"chunk, {medium_launches_per_chunk(meta)} of them the "
              f"BSSRDF's and the volume's); image mean {img.mean():.6f} max "
              f"{img.max():.4f}", flush=True)
        check(launches == no_launches(**{f"trace_bvh{wide}": want}),
              f"{path} width {wide}: launches {launches}, expected {want} of "
              f"trace_bvh{wide} and no other")
        images[wide], counts[wide] = img, launches
    if len(widths) > 1:
        a, b = images[widths[1]], images[widths[0]]
        close = (np.abs(a - b) <= 1e-4 + 1e-3 * np.abs(b)).all(axis=-1)
        rel_mean = abs(a.mean() - b.mean()) / b.mean()
        print(f"  width {widths[1]} vs width {widths[0]}: pixels within 1e-4 "
              f"+ 1e-3 rel {close.mean():.6f}, means rel diff "
              f"{rel_mean:.2e}", flush=True)
        check(close.mean() >= 0.99 and rel_mean <= 1e-3,
              f"{path}: the widths' images disagree")
    return counts, steady


def fog_whitted_path():
    """Phase 19: the fog scene under whitted at FOG_WHITTED_DEPTH. Returns
    (launches, seconds of the pass with the load)."""
    from goblin_tpu_torch.integrators.whitted import _specular_caps

    ovr = {"render_method": "whitted", "sample_per_pixel": 1,
           "max_ray_depth": FOG_WHITTED_DEPTH}
    img, meta, launches, passes = counted_render(FOG, ovr, chunk_size=CHUNK)
    spec = meta.camera.film
    depth = meta.settings["max_ray_depth"]
    can_reflect, can_transmit = _specular_caps(meta)
    check(can_reflect and not can_transmit, "the fog scene's tree changed")
    nodes = depth + 1  # a reflection child under each node
    per_node = (1 + 4 * meta.settings["bssrdf_sample_num"]
                + sum(meta.light_sample_nums) * (MAX_PUNCH + 1))
    want = nodes * per_node * -(-spec.x_res * spec.y_res // CHUNK)
    print(f"  {spec.x_res}x{spec.y_res} 1 spp, max_ray_depth {depth}: "
          f"{nodes} nodes x {per_node} launches a chunk; {passes[0]:.3f} s "
          f"with the load; launches {launches} (expected {want}); image mean "
          f"{img.mean():.6f} max {img.max():.4f}", flush=True)
    check(launches == no_launches(trace_bvh8=want),
          f"fog whitted launches {launches}, expected {want} of trace_bvh8")
    return launches, float(passes[0])


def fog_cli():
    """Phase 19: python -m goblin_tpu_torch examples/bunny_fog.json, in this
    process from a scratch working directory (the film's relative file name
    is taken from there): the PPM's header and size, bloom and tone mapping
    each applied once. Returns the seconds."""
    import numpy as np

    from goblin_tpu_torch import render
    from goblin_tpu_torch.camera import film

    calls = {"bloom": 0, "tone_map": 0}
    real = {name: getattr(film, name) for name in calls}

    def counting(name):
        def fn(*args, **kw):
            calls[name] += 1
            return real[name](*args, **kw)
        return fn

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        try:
            os.chdir(tmp)
            for name in calls:
                setattr(film, name, counting(name))
            t = time.perf_counter()
            check(render.main([FOG]) == 0, "the CLI failed")
            seconds = time.perf_counter() - t
        finally:
            for name, fn in real.items():
                setattr(film, name, fn)
            os.chdir(cwd)
        out = os.path.join(tmp, "bunny_fog.ppm")
        check(os.path.exists(out), "the CLI wrote no bunny_fog.ppm")
        with open(out, "rb") as f:
            data = f.read()
    header = b"P6\n512 384\n255\n"
    pixels = np.frombuffer(data[len(header):], np.uint8)
    print(f"  CLI: {seconds:.2f} s (16 spp, load included); bunny_fog.ppm "
          f"{len(data)} bytes, header {data[:len(header)]!r}, mean 8-bit "
          f"value {pixels.mean():.2f}; bloom {calls['bloom']}x, tone map "
          f"{calls['tone_map']}x", flush=True)
    check(data.startswith(header) and len(data) == len(header) + 512 * 384 * 3,
          "bunny_fog.ppm has the wrong header or size")
    check(calls == {"bloom": 1, "tone_map": 1},
          f"bloom and tone mapping not each applied once: {calls}")
    check(5 < pixels.mean() < 250, "bunny_fog.ppm is black or white")
    return seconds


def kernel_name(wide):
    return {8: "trace_bvh8", 4: "trace_bvh4", 1: "trace_bvh2"}[wide]


def grad_pass(scene, meta, chunk=CHUNK):
    """Phase 21: mean(L * GRAD_WEIGHTS) over one sample of every pixel of
    meta's film (the camera a pinhole, as goblin_tpu's train step takes it)
    and its gradients with respect to the light colours, tex_const and
    tri_rows, chunk by chunk: each chunk's backward runs before the next
    chunk's forward and the gradients add up. Returns (loss, {leaf: numpy
    gradient, tri_rows' as its first 9 columns}, {"forward_launches",
    "backward_launches", "peak_bytes": per chunk; "seconds"})."""
    import torch

    from goblin_tpu_torch.integrators import common
    from goblin_tpu_torch.ops import trace as tt
    from goblin_tpu_torch.render import make_li
    from goblin_tpu_torch.scene import bake

    sc = bake.set_trainable_params(scene, bake.trainable_params(scene))
    leaves = {"lights.color": sc["lights"]["color"],
              "tex_const": sc["tex_const"], "tri_soup": sc["tri_rows"]}
    for x in leaves.values():
        x.requires_grad_()
    li = make_li(meta)
    spec = meta.camera.film
    dev = scene["tri_rows"].device
    cuda = dev.type == "cuda"
    seed = int(meta.settings.get("seed", 0))
    ids = torch.arange(spec.x_res * spec.y_res, dtype=torch.int32, device=dev)
    w = torch.tensor(GRAD_WEIGHTS, device=dev)
    stats = {"forward_launches": [], "backward_launches": [],
             "peak_bytes": []}
    loss = torch.zeros((), device=dev)
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for c0 in range(0, ids.numel(), chunk):
        pix = ids[c0:c0 + chunk]
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        n0 = sum(tt.launches.values())
        x, y = common.pixel_samples(seed, pix, spec.x_res, 0, 1)
        L = li(sc, meta, meta.camera.generate_ray(x, y), pix, 0, seed)
        part = (L * w).sum() / (3 * ids.numel())
        n1 = sum(tt.launches.values())
        part.backward()
        stats["forward_launches"].append(n1 - n0)
        stats["backward_launches"].append(sum(tt.launches.values()) - n1)
        if cuda:
            stats["peak_bytes"].append(torch.cuda.max_memory_allocated())
        loss = loss + part.detach()
    if cuda:
        torch.cuda.synchronize()
    stats["seconds"] = time.perf_counter() - t0
    grads = {}
    for name, x in leaves.items():
        g = torch.zeros_like(x) if x.grad is None else x.grad
        grads[name] = (g[:, :9] if name == "tri_soup" else g).cpu().numpy()
    return float(loss), grads, stats


def forward_loss(scene, meta, chunk=CHUNK):
    """grad_pass's loss without autograd -> (loss, seconds)."""
    import torch

    from goblin_tpu_torch.integrators import common
    from goblin_tpu_torch.render import make_li

    li = make_li(meta)
    spec = meta.camera.film
    dev = scene["tri_rows"].device
    seed = int(meta.settings.get("seed", 0))
    ids = torch.arange(spec.x_res * spec.y_res, dtype=torch.int32, device=dev)
    w = torch.tensor(GRAD_WEIGHTS, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        total = torch.zeros((), device=dev)
        for c0 in range(0, ids.numel(), chunk):
            pix = ids[c0:c0 + chunk]
            x, y = common.pixel_samples(seed, pix, spec.x_res, 0, 1)
            L = li(scene, meta, meta.camera.generate_ray(x, y), pix, 0, seed)
            total = total + (L * w).sum() / (3 * ids.numel())
        loss = float(total)
    return loss, time.perf_counter() - t0


def grads_agree(got, ref, what):
    """The gradient bar: light colour and tex_const within 1e-4 rel,
    tri_rows' columns with >= 99% of entries within 1e-6 + 1e-3 rel."""
    import numpy as np

    for name in ref:
        g, r = got[name], ref[name]
        check(np.isfinite(g).all(), f"{what}: {name} has non-finite entries")
        if name == "tri_soup":
            close = float((np.abs(g - r) <= 1e-6 + 1e-3 * np.abs(r)).mean())
            worst = f"{close:.6f} of entries within 1e-6 + 1e-3 rel"
            ok = close >= 0.99
        else:
            rel = float(np.abs(g - r).max() / max(np.abs(r).max(), 1e-30))
            worst = f"largest difference {rel:.2e} of the largest entry"
            ok = np.allclose(g, r, rtol=1e-4, atol=1e-4 * np.abs(r).max())
        print(f"    {what}, {name}: {worst}", flush=True)
        check(ok, f"{what}: {name} gradients disagree ({worst})")


def gradient_path():
    """Phase 21: bunny.json's gradient pass at 512 x 384, depth 5, 1 spp, in
    chunks of CHUNK, at trace widths 8, 4 and 1: finite gradients that
    agree between widths, the forward's exact launches (8 a chunk) and none
    in the backward; the light colour's gradient against a central finite
    difference of the loss at full size (the loss is linear in a light's
    colour: the light-pick table is baked from luminance on the host); at
    48 x 36 the card's gradients against the CPU's. Returns ({width:
    launches}, {width: numbers})."""
    import numpy as np

    from goblin_tpu_torch.ops import trace as tt
    from goblin_tpu_torch.scene import bake
    from goblin_tpu_torch.scene.loader import load_scene

    counts, numbers, grads = {}, {}, {}
    for wide in GRAD_WIDTHS:
        scene, meta = load_scene(BUNNY, GRAD_SETTINGS, device="cuda",
                                 trace_wide=wide)
        check(meta.all_delta_lights and meta.n_lights == 1,
              "bunny.json's light changed")
        spec = meta.camera.film
        n_chunks = -(-spec.x_res * spec.y_res // CHUNK)
        fwd_loss, fwd_s = forward_loss(scene, meta)
        tt.reset_launches()
        loss, g, st = grad_pass(scene, meta)
        counts[wide] = dict(tt.launches)
        want = 8 * n_chunks
        peak_gb = [b / 2 ** 30 for b in st["peak_bytes"]]
        print(f"  width {wide}: {spec.x_res}x{spec.y_res} depth 5, 1 spp, "
              f"{n_chunks} chunks of {CHUNK}: forward {fwd_s:.4f} s, forward "
              f"+ backward {st['seconds']:.4f} s (backward : forward "
              f"{(st['seconds'] - fwd_s) / fwd_s:.2f}); peak memory a chunk "
              f"{' '.join(f'{v:.2f}' for v in peak_gb)} GiB; launches a "
              f"chunk forward {st['forward_launches']} backward "
              f"{st['backward_launches']}; loss {loss:.8f} (no-grad "
              f"{fwd_loss:.8f})", flush=True)
        check(counts[wide] == no_launches(**{kernel_name(wide): want}),
              f"width {wide}: gradient pass launches {counts[wide]}, expected "
              f"{want} of {kernel_name(wide)} and no other")
        check(st["forward_launches"] == [8] * n_chunks
              and st["backward_launches"] == [0] * n_chunks,
              f"width {wide}: launches a chunk {st}")
        check(abs(loss - fwd_loss) <= 1e-6 * abs(fwd_loss),
              f"width {wide}: the gradient pass's loss {loss} is not the "
              f"forward's {fwd_loss}")
        for name, v in g.items():
            check(np.isfinite(v).all() and np.abs(v).max() > 0,
                  f"width {wide}: {name} gradient not finite or all zero")
        grads[wide] = g
        numbers[wide] = {"forward_s": fwd_s, "forward_backward_s":
                         st["seconds"], "peak_gib_per_chunk": peak_gb}
        if wide == 8:
            color = bake.trainable_params(scene)["lights.color"]
            fd = []
            for j in range(3):
                h = FD_STEP * float(color[0, j])
                losses = []
                for sgn in (1.0, -1.0):
                    c = color.copy()
                    c[0, j] += sgn * h
                    losses.append(forward_loss(bake.set_trainable_params(
                        scene, {"lights.color": c}), meta)[0])
                fd.append((losses[0] - losses[1]) / (2 * h))
            ad = g["lights.color"][0]
            rel = np.abs(ad - fd) / np.abs(fd)
            print(f"    light colour: AD {ad.tolist()} central difference "
                  f"{fd} (step {FD_STEP} of the value; rel diff "
                  f"{rel.max():.2e})", flush=True)
            check(rel.max() <= FD_RTOL, "light-colour gradient against the "
                                        "finite difference")
        del scene
    for wide in GRAD_WIDTHS[1:]:
        grads_agree(grads[wide], grads[8], f"width {wide} vs width 8")
    small = {}
    for device in ("cpu", "cuda"):
        scene, meta = load_scene(BUNNY, GRAD_SETTINGS, device=device)
        small_film(meta)
        small[device] = grad_pass(scene, meta)[1]
    grads_agree(small["cuda"], small["cpu"], "48x36 card vs CPU")
    return counts, numbers


def train_path():
    """Phase 22: the gallery scene at 512 x 384, depth 5: TRAIN_STEPS steps
    of plain SGD on (light colours, tex_atlas) through make_train_step, the
    frame in chunks of CHUNK pixel ids. Each step's eta moves the loss by
    about TRAIN_MOVE; the move it made must match its first-order
    prediction -eta |g|^2 within TRAIN_RTOL. Returns (launches, numbers)."""
    import torch

    from goblin_tpu_torch.ops import trace as tt
    from goblin_tpu_torch.parallel.mesh import make_train_step
    from goblin_tpu_torch.render import make_li
    from goblin_tpu_torch.scene.loader import load_scene

    scene, meta = load_scene(GALLERY, GRAD_SETTINGS, device="cuda")
    check_gallery(meta)
    step = make_train_step(scene, meta, make_li(meta))
    spec = meta.camera.film
    ids = torch.arange(spec.x_res * spec.y_res, dtype=torch.int32,
                       device="cuda")
    n_chunks = -(-ids.numel() // CHUNK)
    per_chunk = studio_launches_per_chunk(meta.settings["max_ray_depth"])

    def full_step(params):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, grads, peaks = 0.0, [0.0, 0.0], []
        for c0 in range(0, ids.numel(), CHUNK):
            pix = ids[c0:c0 + CHUNK]
            torch.cuda.reset_peak_memory_stats()
            c_loss, c_grads = step(params, pix, 0)
            peaks.append(torch.cuda.max_memory_allocated() / 2 ** 30)
            share = pix.numel() / ids.numel()
            loss = loss + share * c_loss
            grads = [g + share * c for g, c in zip(grads, c_grads)]
        loss = float(loss)
        torch.cuda.synchronize()
        return loss, grads, time.perf_counter() - t0, peaks

    params = (scene["lights"]["color"].clone(), scene["tex_atlas"].clone())
    tt.reset_launches()
    loss, grads, secs, peaks = full_step(params)
    seconds, moves = [secs], []
    for k in range(TRAIN_STEPS):
        for name, g in zip(("light colour", "tex_atlas"), grads):
            n_bad, n_set = int((~torch.isfinite(g)).sum()), int((g != 0).sum())
            check(n_bad == 0 and n_set > 0,
                  f"step {k + 1}: {name} gradient has {n_bad} non-finite "
                  f"and {n_set} nonzero entries")
        g2 = float(sum((g * g).sum() for g in grads))
        eta = TRAIN_MOVE * loss / g2
        params = tuple(p - eta * g for p, g in zip(params, grads))
        new_loss, grads, secs, step_peaks = full_step(params)
        seconds.append(secs)
        peaks = [max(a, b) for a, b in zip(peaks, step_peaks)]
        predicted, moved = -eta * g2, new_loss - loss
        rel = abs(moved - predicted) / abs(predicted)
        moves.append({"loss": loss, "eta": eta, "predicted": predicted,
                      "moved": moved, "rel": rel})
        print(f"  step {k + 1}: loss {loss:.8f} -> {new_loss:.8f}, eta "
              f"{eta:.4e}, |g|^2 {g2:.4e}: moved {moved:.6e}, predicted "
              f"{predicted:.6e} (rel diff {rel:.2e}); atlas entries with a "
              f"gradient {int((grads[1] != 0).sum())} of "
              f"{grads[1].numel()}", flush=True)
        check(rel <= TRAIN_RTOL, f"step {k + 1}: the loss moved {moved}, its "
                                 f"first-order prediction {predicted}")
        loss = new_loss
    launches = dict(tt.launches)
    want = per_chunk * n_chunks * (TRAIN_STEPS + 1)
    print(f"  {spec.x_res}x{spec.y_res} depth 5, {n_chunks} chunks of {CHUNK} "
          f"pixel ids: seconds a step (forward + backward of the frame) "
          f"{' '.join(f'{v:.4f}' for v in seconds)}; peak memory a chunk "
          f"{' '.join(f'{v:.2f}' for v in peaks)} GiB; launches {launches} "
          f"(expected {want}: {per_chunk} a chunk, {TRAIN_STEPS + 1} "
          "evaluations)", flush=True)
    check(launches == no_launches(trace_bvh8=want),
          f"train step launches {launches}, expected {want} of trace_bvh8")
    return launches, {"seconds_per_step": seconds, "chunk": CHUNK,
                      "peak_gib_per_chunk": peaks, "moves": moves}


def edge_path():
    """Phase 22: mesh_boundary_grad on the card over tests/test_edge_grad.py's
    tetrahedron sweep, against the CPU's, within EDGE_RTOL."""
    import numpy as np
    import torch

    from goblin_tpu_torch.integrators import edge_grad as eg

    faces = np.int32([[0, 2, 1], [0, 1, 3], [1, 2, 3], [2, 0, 3]])
    light = np.float32([[-1.0, 2.0, -1.0], [1.0, 2.0, -1.0],
                        [1.0, 2.0, 1.0], [-1.0, 2.0, 1.0]])
    adj = eg.build_edge_adjacency(faces)
    worst = 0.0
    for theta in EDGE_SWEEP:
        verts = np.float32([[0.15, 1.0, 0.0], [0.55, 1.0, 0.25],
                            [0.40, 1.0, -0.30], [0.35, 1.25, 0.0]])
        verts[:, 0] += theta
        vel = np.tile(np.float32([1.0, 0.0, 0.0]), (4, 1))
        out = {}
        for device in ("cpu", "cuda"):
            out[device] = eg.mesh_boundary_grad(
                torch.zeros(3, device=device), [0.0, 1.0, 0.0],
                [0.8, 0.6, 0.4], light, [0.0, -1.0, 0.0], [5.0, 5.0, 5.0],
                verts, faces, adj, vel, n_samples=128)
        check(out["cuda"].device.type == "cuda", "edge gradient left the card")
        gpu, cpu = out["cuda"].cpu().numpy(), out["cpu"].numpy()
        rel = float(np.abs(gpu - cpu).max() / np.abs(cpu).max())
        worst = max(worst, rel)
        print(f"  edge gradient, theta {theta:+.2f}: card {gpu.tolist()} cpu "
              f"{cpu.tolist()} (rel diff {rel:.2e})", flush=True)
        check(np.isfinite(gpu).all() and np.abs(cpu).max() > 0,
              f"theta {theta}: edge gradient not finite or zero")
        check(rel <= EDGE_RTOL, f"theta {theta}: card and CPU edge gradients "
                                "disagree")
    return worst


def images_agree(a, b, what):
    """The image bar between two renders of one scene on the card."""
    import numpy as np

    close = (np.abs(a - b) <= 1e-4 + 1e-3 * np.abs(b)).all(axis=-1)
    rel_mean = abs(a.mean() - b.mean()) / b.mean()
    print(f"  {what}: pixels within 1e-4 + 1e-3 rel {close.mean():.6f}, means "
          f"{a.mean():.6f} / {b.mean():.6f} (rel diff {rel_mean:.2e})",
          flush=True)
    check(np.isfinite(a).all() and b.mean() > 0, f"{what}: a bad image")
    check(close.mean() >= 0.99 and rel_mean <= 1e-3,
          f"{what}: the images disagree")


def driver_turn(scene, meta, regen, spp=None):
    """One render of a loaded scene (at spp, default the scene's) by the
    chunked driver or the regenerative one (pool CHUNK), with the launch
    counters set to 0 just before it -> (image, stats or None, launches,
    seconds)."""
    import torch

    from goblin_tpu_torch.integrators import common
    from goblin_tpu_torch.integrators.wavefront import render_wavefront
    from goblin_tpu_torch.ops import trace as tt
    from goblin_tpu_torch.render import make_li

    torch.cuda.synchronize()
    tt.reset_launches()
    t0 = time.perf_counter()
    if regen:
        img, stats = render_wavefront(scene, meta, spp=spp, pool=CHUNK,
                                      with_stats=True)
    else:
        img, stats = common.render(scene, meta, make_li(meta), spp=spp,
                                   chunk_size=CHUNK), None
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return img.cpu().numpy(), stats, dict(tt.launches), secs


def regen_numbers(stats):
    """What phase 23 prints and keeps of a regenerative render's stats."""
    live = [n / stats["pool"] for n in stats["live_lanes"]]
    print(f"    iterations {stats['iterations']}, pool {stats['pool']}, "
          f"useful_segments {stats['useful_segments']} of "
          f"{stats['lane_rays']} lane-rays; live lanes a iteration "
          f"{' '.join(f'{v:.3f}' for v in live)}", flush=True)
    return {"iterations": stats["iterations"],
            "useful_segments": stats["useful_segments"],
            "lane_rays": stats["lane_rays"], "live_share": live}


def regen_bunny():
    """Phase 23, bunny.json (4 spp, depth 5): at each of REGEN_WIDTHS, the
    chunked and the regenerative driver in turns (chunked, regenerative,
    regenerative, chunked) on one loaded scene: 2 trace launches an
    iteration (the scene has no mask), the chunked driver's 96, the images
    within the bar of each other. Then the regenerative render through
    render_context at width 8 (the main path's launches), and once more
    under the profiler, which counts its device-to-host reads: one an
    iteration. Returns ({width: launches of render_context's run}, numbers)."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from goblin_tpu_torch.integrators.wavefront import render_wavefront
    from goblin_tpu_torch.ops import trace as tt
    from goblin_tpu_torch.render import render_context
    from goblin_tpu_torch.scene.loader import load_scene

    numbers, iterations = {}, {}
    for wide in REGEN_WIDTHS:
        scene, meta = load_scene(BUNNY, SETTINGS, device="cuda",
                                 trace_wide=wide)
        check(not meta.has_null and meta.all_delta_lights,
              "bunny.json lost a feature")
        spp = meta.settings["sample_per_pixel"]
        name = kernel_name(wide)
        secs = {False: [], True: []}
        images = {}
        for regen in (False, True, True, False):
            img, turn_stats, launches, t = driver_turn(scene, meta, regen)
            secs[regen].append(t / spp)
            if regen:
                stats = turn_stats
            want = 2 * stats["iterations"] if regen else EXPECTED_LAUNCHES
            check(launches == no_launches(**{name: want}),
                  f"bunny width {wide} {'regenerative' if regen else 'chunked'}"
                  f": launches {launches}, expected {want} of {name}")
            images[regen] = img
        print(f"  bunny width {wide}, {spp} spp: seconds a pass, chunked "
              f"{' '.join(f'{v:.4f}' for v in secs[False])} (turns 1 and 4), "
              f"regenerative {' '.join(f'{v:.4f}' for v in secs[True])} "
              f"(turns 2 and 3); launches a render, chunked "
              f"{EXPECTED_LAUNCHES}, regenerative {2 * stats['iterations']}",
              flush=True)
        numbers[wide] = dict(regen_numbers(stats),
                             seconds_per_pass={"chunked": secs[False],
                                               "regenerative": secs[True]})
        iterations[wide] = stats["iterations"]
        images_agree(images[True], images[False],
                     f"bunny width {wide}, regenerative vs chunked")
        if wide == 8:  # and at 1 spp, in turns
            one, one_stats = {False: [], True: []}, None
            for regen in (False, True, True, False):
                _, turn_stats, _, t = driver_turn(scene, meta, regen, spp=1)
                one[regen].append(t)
                one_stats = turn_stats or one_stats
            print(f"  bunny width 8, 1 spp: seconds a pass, chunked "
                  f"{' '.join(f'{v:.4f}' for v in one[False])}, regenerative "
                  f"{' '.join(f'{v:.4f}' for v in one[True])}", flush=True)
            numbers["1 spp, width 8"] = dict(
                regen_numbers(one_stats), seconds_per_pass={
                    "chunked": one[False], "regenerative": one[True]})
        del scene
    counts = {}
    for wide in REGEN_WIDTHS:
        tt.reset_launches()
        img, meta = render_context(BUNNY, SETTINGS, device="cuda",
                                   chunk_size=CHUNK, trace_wide=wide,
                                   regen=True, pool=CHUNK)
        counts[wide] = dict(tt.launches)
        want = 2 * iterations[wide]
        check(counts[wide] == no_launches(**{kernel_name(wide): want}),
              f"render_context(regen=True) width {wide}: launches "
              f"{counts[wide]}, expected {want}")
        check(np.isfinite(img.cpu().numpy()).all(), "non-finite pixels")
    scene, meta = load_scene(BUNNY, SETTINGS, device="cuda")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        render_wavefront(scene, meta, pool=CHUNK)
    ops = [e.name for e in prof.events()]
    reads = ops.count("aten::_local_scalar_dense")
    print(f"  render_context(regen=True) launches by width {counts}; "
          f"device-to-host reads of a width-8 render {reads} for "
          f"{iterations[8]} iterations, aten::nonzero {ops.count('aten::nonzero')}",
          flush=True)
    check(reads == iterations[8] and "aten::nonzero" not in ops,
          f"{reads} reads for {iterations[8]} iterations")
    numbers["reads_width_8"] = reads
    return counts, numbers


def fog_without_bssrdf(out_dir):
    """The fog scene with its subsurface bunny given a Lambert material,
    written into out_dir with its models' absolute paths -> its path."""
    with open(FOG) as f:
        doc = json.load(f)
    for g in doc["geometries"]:
        if "file" in g:
            g["file"] = os.path.join(os.path.dirname(FOG), g["file"])
    doc["materials"] = [
        {"name": m["name"], "type": "lambert", "Kd": "purple"}
        if m["type"] == "subsurface" else m for m in doc["materials"]]
    path = os.path.join(out_dir, "fog_lambert.json")
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


def regen_scenes():
    """Phase 23: the studio scene (area and sphere lights, spheres, disks,
    a mask), the sky scene (the map's arm) and the fog scene without its
    BSSRDF (the volume's (tr, Lv) arm) at 512 x 384, 4 spp, depth 5, width
    8, regenerative against chunked: 1 + MAX_PUNCH launches an iteration
    (the shadow ray's punch-through rounds and the combined closest-hit),
    and the volume's 2 a homogeneous sample; then the fog scene as shipped
    through render_context(regen=True), which supports() sends to the
    chunked driver: its launches are the chunked render's. Returns
    ({scene: launches}, numbers)."""
    from goblin_tpu_torch.integrators import wavefront
    from goblin_tpu_torch.ops import trace as tt
    from goblin_tpu_torch.render import render_context
    from goblin_tpu_torch.scene.loader import load_scene

    counts, numbers = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        scenes = (("studio", STUDIO), ("sky", SKY),
                  ("fog without BSSRDF", fog_without_bssrdf(tmp)))
        for label, path in scenes:
            scene, meta = load_scene(path, SETTINGS, device="cuda")
            check(meta.has_null and wavefront.supports(meta),
                  f"{label}: a feature is lost")
            per_iter = 1 + MAX_PUNCH
            if meta.volume is not None:
                per_iter += 2 * meta.volume.sample_num
            spp = meta.settings["sample_per_pixel"]
            turns = {}
            for regen in (True, False):
                turns[regen] = driver_turn(scene, meta, regen)
            img, stats, launches, t = turns[True]
            want = per_iter * stats["iterations"]
            print(f"  {label}: regenerative {t / spp:.4f} s a pass, chunked "
                  f"{turns[False][3] / spp:.4f}; launches {launches} "
                  f"(expected {want}: {per_iter} an iteration)", flush=True)
            check(launches == no_launches(trace_bvh8=want),
                  f"{label}: launches {launches}, expected {want}")
            numbers[label] = dict(regen_numbers(stats), seconds_per_pass={
                "regenerative": t / spp, "chunked": turns[False][3] / spp})
            counts[label] = launches
            images_agree(img, turns[False][0],
                         f"{label}, regenerative vs chunked")
            del scene
    tt.reset_launches()
    img, meta = render_context(FOG, SETTINGS, device="cuda", chunk_size=CHUNK,
                               regen=True, pool=CHUNK)
    launches = dict(tt.launches)
    spec = meta.camera.film
    want = ((studio_launches_per_chunk(meta.settings["max_ray_depth"])
             + medium_launches_per_chunk(meta))
            * -(-spec.x_res * spec.y_res // CHUNK)
            * meta.settings["sample_per_pixel"])
    print(f"  fog scene (a BSSRDF) through render_context(regen=True): "
          f"launches {launches}, the chunked driver's {want}", flush=True)
    check(not wavefront.supports(meta) and
          launches == no_launches(trace_bvh8=want),
          f"the fog scene did not take the chunked driver: {launches}")
    counts["fog, chunked by supports()"] = launches
    return counts, numbers


SHARDED_CHILD_FLAG = "--sharded-rank"
SHARDED_TIMEOUT = 600


def sharded_work(mesh):
    """Phase 24 on one rank of the mesh: bunny PT at 1 spp by
    render_sharded_dense and render_sharded (chunks of CHUNK), and one step
    of make_sharded_train_step over the gallery scene's frame, chunk by
    chunk of CHUNK pixel ids, each weighted by its share -> ({what: numpy
    result}, {what: launches of this rank}, {what: seconds})."""
    import torch

    from goblin_tpu_torch.ops import trace as tt
    from goblin_tpu_torch.parallel import mesh as pmesh
    from goblin_tpu_torch.render import make_li
    from goblin_tpu_torch.scene.loader import load_scene

    out, counts, secs = {}, {}, {}

    def timed(what, fn):
        torch.cuda.synchronize()
        tt.reset_launches()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        secs[what] = time.perf_counter() - t0
        counts[what] = dict(tt.launches)
        return res

    scene, meta = load_scene(BUNNY, PT_CHECK, device=mesh.device)
    li = make_li(meta)
    for fn in (pmesh.render_sharded_dense, pmesh.render_sharded):
        img = timed(f"bunny {fn.__name__}",
                    lambda: fn(scene, meta, li, mesh, chunk_size=CHUNK))
        out[fn.__name__] = img.cpu().numpy()
    del scene
    scene, meta = load_scene(GALLERY, GRAD_SETTINGS, device=mesh.device)
    spec = meta.camera.film
    ids = torch.arange(spec.x_res * spec.y_res, dtype=torch.int32,
                       device=mesh.device)
    step, _ = pmesh.make_sharded_train_step(scene, meta, make_li(meta), mesh)
    out["loss"], grads = timed("gallery make_sharded_train_step", lambda:
                               chunked_step(step, scene, ids))
    out["g_light"], out["g_atlas"] = grads
    return out, counts, secs


def chunked_step(step, scene, ids):
    """A train step over the frame's pixel ids, chunk by chunk of CHUNK,
    each chunk's loss and gradients weighted by its share -> (loss, numpy
    gradients)."""
    params = (scene["lights"]["color"], scene["tex_atlas"])
    loss, grads = 0.0, [0.0, 0.0]
    for c0 in range(0, ids.numel(), CHUNK):
        pix = ids[c0:c0 + CHUNK]
        c_loss, c_grads = step(params, pix, 0)
        share = pix.numel() / ids.numel()
        loss = loss + share * c_loss
        grads = [g + share * c for g, c in zip(grads, c_grads)]
    return float(loss), [g.cpu().numpy() for g in grads]


def sharded_child(out_dir):
    """One rank of phase 24 on a machine with several cards, started by
    sharded_path through multihost.launch_local: join the NCCL group from
    the GOBLIN_* variables, do sharded_work, write its results."""
    import numpy as np
    import torch.distributed as dist

    from goblin_tpu_torch.parallel import mesh as pmesh
    from goblin_tpu_torch.parallel import multihost

    check(multihost.init_from_env(device="cuda"), "no process group")
    try:
        mesh = pmesh.make_mesh(device="cuda")
        out, counts, secs = sharded_work(mesh)
        np.savez(os.path.join(out_dir, f"rank{mesh.rank}.npz"),
                 meta=json.dumps({"counts": counts, "seconds": secs,
                                  "backend": dist.get_backend(),
                                  "device": str(mesh.device)}), **out)
    finally:
        dist.destroy_process_group()


def sharded_path():
    """Phase 24: the sharded steps over an NCCL process group joined as
    multihost.init_from_env joins it, one rank a card: world = min(2,
    cards). One card: the group of world 1 in this process. Two or more:
    two ranks, each a child process (launch_local, this script with
    SHARDED_CHILD_FLAG), whose results must agree. Against this process's
    one-process references: bunny PT at 1 spp by common.render (the image
    bar, 8 launches a chunk of a rank's share), and make_train_step over
    the gallery scene's frame (the gradient bars: loss within 1e-5 rel, gradients
    within rtol 1e-4). Returns (launches by path of rank 0, numbers)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from goblin_tpu_torch.integrators import common
    from goblin_tpu_torch.parallel import mesh as pmesh
    from goblin_tpu_torch.parallel import multihost
    from goblin_tpu_torch.render import make_li
    from goblin_tpu_torch.scene.loader import load_scene

    world = min(2, torch.cuda.device_count())
    port = multihost.free_port()
    if world == 1:
        env = {"GOBLIN_COORDINATOR": f"localhost:{port}",
               "GOBLIN_NUM_PROCS": "1", "GOBLIN_PROC_ID": "0"}
        os.environ.update(env)
        try:
            check(multihost.init_from_env(device="cuda"), "no process group")
        finally:
            for key in env:
                del os.environ[key]
        try:
            mesh = pmesh.make_mesh(device="cuda")
            info = [{"backend": dist.get_backend(),
                     "device": str(mesh.device)}]
            out, counts, secs = sharded_work(mesh)
            ranks = [out]
            info[0].update(counts=counts, seconds=secs)
        finally:
            dist.destroy_process_group()
    else:
        with tempfile.TemporaryDirectory() as tmp:
            results = multihost.launch_local(
                world, [os.path.abspath(__file__), SHARDED_CHILD_FLAG, tmp],
                port=port, timeout=SHARDED_TIMEOUT)
            for rank, (rc, log) in enumerate(results):
                print("\n".join(f"    rank {rank}: {line}"
                                for line in log.splitlines()[-5:]))
                check(rc == 0, f"rank {rank} exited with {rc}")
            ranks, info = [], []
            for rank in range(world):
                with np.load(os.path.join(tmp, f"rank{rank}.npz")) as f:
                    ranks.append({k: f[k] for k in f.files if k != "meta"})
                    info.append(json.loads(str(f["meta"])))
    for rank, i in enumerate(info):
        print(f"  rank {rank} of world {world}: backend {i['backend']}, "
              f"device {i['device']}; seconds "
              f"{ {k: round(v, 4) for k, v in i['seconds'].items()} }",
              flush=True)
        check(i["backend"] == "nccl", f"backend {i['backend']}")
    for rank in range(1, world):
        for key, v in ranks[rank].items():
            check(np.allclose(v, ranks[0][key], rtol=0, atol=1e-6),
                  f"ranks 0 and {rank} disagree on {key}")
    got, counts = ranks[0], info[0]["counts"]

    # the one-process references, in this process without a group
    scene, meta = load_scene(BUNNY, PT_CHECK, device="cuda")
    ref = common.render(scene, meta, make_li(meta),
                        chunk_size=CHUNK).cpu().numpy()
    n_pix = meta.camera.film.x_res * meta.camera.film.y_res
    del scene
    sizes = {"render_sharded_dense": pmesh.dense_chunk_size(n_pix, world,
                                                            CHUNK),
             "render_sharded": pmesh.sharded_chunk_size(world, CHUNK)}
    for name, chunk in sizes.items():
        want = 8 * -(-n_pix // chunk)
        launches = counts[f"bunny {name}"]
        print(f"  {name}: bunny 1 spp depth 5, chunks of {chunk}; rank 0's "
              f"launches {launches} (expected {want}: 8 a chunk)", flush=True)
        check(launches == no_launches(trace_bvh8=want),
              f"{name}: launches {launches}, expected {want}")
        images_agree(got[name], ref, f"{name} (world {world}) vs common.render")
    scene, meta = load_scene(GALLERY, GRAD_SETTINGS, device="cuda")
    spec = meta.camera.film
    ids = torch.arange(spec.x_res * spec.y_res, dtype=torch.int32,
                       device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    b_loss, b_g = chunked_step(pmesh.make_train_step(scene, meta,
                                                     make_li(meta)),
                               scene, ids)
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    a_loss = float(got["loss"])
    print(f"  make_sharded_train_step (world {world}) loss {a_loss:.8f}, "
          f"make_train_step {b_loss:.8f} ({one_s:.4f} s a step); rank 0's "
          f"launches {counts['gallery make_sharded_train_step']}", flush=True)
    check(abs(a_loss - b_loss) <= 1e-5 * abs(b_loss),
          f"sharded loss {a_loss}, make_train_step's {b_loss}")
    for what, g, r in zip(("light colour", "tex_atlas"),
                          (got["g_light"], got["g_atlas"]), b_g):
        rel = float(np.abs(g - r).max() / max(np.abs(r).max(), 1e-30))
        print(f"    {what}: largest difference {rel:.2e} of the largest "
              f"entry", flush=True)
        check(np.isfinite(g).all() and np.allclose(g, r, rtol=1e-4,
                                                   atol=1e-9),
              f"sharded {what} gradient disagrees ({rel:.2e})")
    want = (studio_launches_per_chunk(meta.settings["max_ray_depth"])
            * -(-ids.numel() // CHUNK))
    check(counts["gallery make_sharded_train_step"]
          == no_launches(trace_bvh8=want), "sharded train step launches")
    numbers = {"world": world, "backend": info[0]["backend"],
               "seconds_rank_0": info[0]["seconds"],
               "make_train_step_s": one_s}
    return counts, numbers


def bench_path():
    """Phase 25: bench_torch.py's four subcommands once each at full size,
    their lines printed. Returns the launches by path of each kernel."""
    import bench_torch as bt
    from goblin_tpu_torch import bench

    t0 = time.perf_counter()
    try:
        pt = bt.pt()
        methods = bt.methods()
        scaling = bt.scaling()
        trace = bt.trace()
    except bt.BenchError as e:
        raise SmokeFailure(f"bench_torch: {e}") from e
    for line in [pt, *methods, scaling, *trace]:
        print(f"  {json.dumps(line)}", flush=True)
    check(pt["trace_launches_per_pass"] == 24,
          f"pt: {pt['trace_launches_per_pass']} launches a pass, expected 24")
    check(pt["dispatched_rays_per_lane_sample"] == 8,
          f"pt: {pt['dispatched_rays_per_lane_sample']} dispatched lane-rays")
    counts = [bench.pt_census(*bench.load_bunny(
        bench.PT_SETTINGS, device, film=(48, 36))) for device in ("cpu", "cuda")]
    print(f"  pt census at 48 x 36 (shadow rays considered, continuation rays "
          f"traced a bounce): CPU {counts[0]}, card {counts[1]}", flush=True)
    check(counts[0] == counts[1], "pt: the card's census differs from the "
                                  "CPU's")
    for method, line in zip(bench.METHODS, methods):
        check(line["lane_rays"] == BENCH_LANE_RAYS[method],
              f"{method}: {line['lane_rays']} lane-rays, expected "
              f"{BENCH_LANE_RAYS[method]}")
    check(scaling["unsharded_vs_mesh_maxdiff"] <= BENCH_MAXDIFF,
          f"scaling: images differ by {scaling['unsharded_vs_mesh_maxdiff']}")
    classes = [line for line in trace if line["metric"] == "bunny_trace_class"]
    check(len(classes) == 8 * len(bench.WIDTHS),
          f"trace: {len(classes)} lines, expected 8 classes x "
          f"{len(bench.WIDTHS)} widths")
    for line in classes:
        check(line["hits_equal_width8"] and line["t_within_rtol_width8"],
              f"trace {line['class']} width {line['trace_wide']}: the results "
              "differ from width 8's")
    secs = time.perf_counter() - t0
    print(f"  phase 25: {secs:.1f} s", flush=True)
    trace_counts = {}
    for line in classes:
        trace_counts[line["kernel"]] = (trace_counts.get(line["kernel"], 0)
                                        + line["trace_launches"])
    by_path = {"bench pt": {"trace_bvh8": int(pt["trace_launches_per_pass"]
                                              * pt["spp"])},
               "bench scaling (a render_sharded_dense pass)": {
                   "trace_bvh8": int(scaling[
                       "trace_launches_per_sharded_pass"])},
               "bench trace (8 classes x 21 launches)": trace_counts}
    for method, line in zip(bench.METHODS, methods):
        by_path[f"bench {method}"] = {"trace_bvh8": line["trace_launches"]}
    return by_path, secs


def entry_path():
    """Phase 26, entry(): 38 launches a call of fn on its example ids and on
    a chunk of ids, seconds a call, and the card against entry(device=
    "cpu") on the example ids and on strided ids at the image bar.
    Returns (launches of the last timed call, numbers)."""
    import torch

    from goblin_tpu_torch import entry as te
    from goblin_tpu_torch.ops import trace as tt

    t0 = time.perf_counter()
    fn, (ids, s_idx) = te.entry()
    numbers = {"load_s": time.perf_counter() - t0}
    check(ids.device.type == "cuda" and ids.dtype == torch.int32
          and ids.numel() == ENTRY_BATCHES[0] and s_idx == 0,
          f"entry()'s example args {ids.shape} {ids.dtype} {s_idx}")
    counts = {}
    for n in ENTRY_BATCHES:
        pix = ids if n == ids.numel() else torch.arange(
            n, dtype=torch.int32, device="cuda")
        fn(pix, s_idx)  # a warm-up call
        secs = []
        for _ in range(ENTRY_REPS):
            torch.cuda.synchronize()
            tt.reset_launches()
            t0 = time.perf_counter()
            L = fn(pix, s_idx)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            counts = dict(tt.launches)
            check(counts == no_launches(trace_bvh8=ENTRY_LAUNCHES),
                  f"entry() on {n} ids: launches {counts}, expected "
                  f"{ENTRY_LAUNCHES} of trace_bvh8")
        check(tuple(L.shape) == (n, 3) and bool(L.isfinite().all()),
              f"entry() on {n} ids: {tuple(L.shape)} or not finite")
        numbers[f"seconds_a_call_{n}_ids"] = secs
        print(f"  entry() fn on {n} ids: {ENTRY_LAUNCHES} launches a call, "
              f"seconds a call {' '.join(f'{v:.4f}' for v in secs)} "
              f"({n / min(secs) / 1e6:.3f} M samples/s at best)", flush=True)
    cpu_fn, _ = te.entry(device="cpu")
    strided = torch.arange(ENTRY_BATCHES[0], dtype=torch.int32,
                           device="cuda") * ENTRY_STRIDE
    for what, pix, s in (("example ids", ids, s_idx),
                         ("strided ids", strided, ENTRY_CHECK_SAMPLE)):
        images_agree(fn(pix, s).cpu().numpy(),
                     cpu_fn(pix.cpu(), s).numpy(),
                     f"entry() {what}, card vs CPU")
    return counts, numbers


def dryrun_path():
    """Phase 26, dryrun_multichip(min(2, cards)) on the cards: its line,
    each rank's backend, device and trace launches. Returns (launches of
    rank 0, numbers)."""
    import torch

    from goblin_tpu_torch import entry as te

    world = min(2, torch.cuda.device_count())
    if world == 1:
        print("  one card: the dryrun runs at world 1 (one NCCL rank)",
              flush=True)
    ranks = []
    t0 = time.perf_counter()
    loss, grad_l1 = te.dryrun_multichip(world, device="cuda", ranks=ranks)
    secs = time.perf_counter() - t0
    for rank, r in enumerate(ranks):
        print(f"  rank {rank} of world {world}: backend {r['backend']}, "
              f"device {r['device']}, image mean {r['image_mean']:.6f}, "
              f"launches {r['trace_launches']}", flush=True)
        check(r["backend"] == "nccl", f"rank {rank}: backend {r['backend']}")
        check(r["trace_launches"].get("trace_bvh8", 0) > 0,
              f"rank {rank}: no trace launch")
    check(loss > 0 and grad_l1 > 0, f"dryrun loss {loss}, grad L1 {grad_l1}")
    return ranks[0]["trace_launches"], {"world": world, "loss": loss,
                                         "grad_l1": grad_l1, "seconds": secs}


def fog_gradient_path():
    """Phase 26, the fog scene's gradient pass: phase 21's loss and leaves
    at 48 x 36, depth 5, card against CPU within phase 21's bars; the
    forward's launches a chunk those of phase 19's path, none in the
    backward. Returns (launches, seconds of the card's pass)."""
    from goblin_tpu_torch.ops import trace as tt
    from goblin_tpu_torch.scene.loader import load_scene

    got = {}
    for device in ("cpu", "cuda"):
        scene, meta = load_scene(FOG, GRAD_SETTINGS, device=device)
        small_film(meta)
        tt.reset_launches()
        _, got[device], stats = grad_pass(scene, meta)
        counts = dict(tt.launches)
    want = (studio_launches_per_chunk(meta.settings["max_ray_depth"])
            + medium_launches_per_chunk(meta))
    print(f"  fog gradient pass 48x36 depth 5 on the card: "
          f"{stats['seconds']:.4f} s, launches a chunk forward "
          f"{stats['forward_launches']} (expected {want}) backward "
          f"{stats['backward_launches']}", flush=True)
    check(stats["forward_launches"] == [want]
          and stats["backward_launches"] == [0]
          and counts == no_launches(trace_bvh8=want),
          f"fog gradient pass launches {counts} {stats}")
    grads_agree(got["cuda"], got["cpu"], "fog 48x36 card vs CPU")
    return counts, stats["seconds"]


# phase 27: timed launches of the hash kernel straight from its entry, a
# few microseconds of the host each, so all queue behind the spinning kernel
HASH_REPS = 200
HASH_LANES = (16_384, 65_536, 196_608)


def hash_counts():
    from goblin_tpu_torch import telemetry

    return {name: telemetry.counters.get(name, 0)
            for name in ("rng.hash_calls", "rng.hash_launches")}


def hash_kernel_path(pt_hash, start_hash):
    """Phase 27: the hash kernel on the main path's call form at each of
    HASH_LANES, bit-equal to the int64 form and timed beside it; its bound
    is the 8 B a lane it must move (a pixel id in, a float out). The
    kernel's time is its launches' from the library's entry; the host's
    microseconds a hash_uniform call are beside it. pt_hash is phase 5's
    (calls, launches), start_hash the counts before phase 3. Returns the
    kernel table's row."""
    import torch

    from goblin_tpu_torch.core import rng
    from goblin_tpu_torch.integrators.common import BOUNCE_CAMERA
    from goblin_tpu_torch.ops import trace as tt

    entry = tt._kernel_lib("rng_hash").goblin_rng_hash
    stream = torch.cuda.current_stream().cuda_stream

    row = {"name": "rng_hash", "route": "cuda",
           "source": "goblin_tpu_torch/csrc/rng_hash.cu",
           "replaces": "none: goblin_tpu/core/rng.py is jnp arithmetic that "
                       "XLA fuses", "library_ms": None, "by_lanes": {}}
    for n in HASH_LANES:
        pix = torch.arange(n, dtype=torch.int32, device="cuda") * 3 + 11
        args = (3100001701, pix, 5, BOUNCE_CAMERA, 0)
        ref = rng.hash_uniform_plain(*args)
        check(torch.equal(rng.hash_uniform(*args), ref),
              f"rng_hash: {n} lanes differ from the int64 form")
        cargs = rng.coord_args(rng.plan_hash(*args))
        out = torch.empty(n, dtype=torch.float32, device="cuda")
        ms = time_ms(lambda: entry(n, *cargs, out.data_ptr(), stream),
                     HASH_REPS)
        check(torch.equal(out, ref), f"rng_hash: {n} lanes differ from the "
                                     "int64 form (the entry's launches)")
        plain_ms = time_ms(lambda: rng.hash_uniform_plain(*args),
                           KERNEL_REPS)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(HASH_REPS):
            rng.hash_uniform(*args)
        host_us = (time.perf_counter() - t) / HASH_REPS * 1e6
        torch.cuda.synchronize()
        bound_ms = n * 8 / PEAK_BYTES_S * 1e3
        row["by_lanes"][n] = {"ms": ms, "plain_ms": plain_ms,
                              "bound_ms": bound_ms, "bound_by": "bytes",
                              "roofline_share": bound_ms / ms,
                              "host_us_a_call": host_us}
        print(f"  {n} lanes: kernel {ms * 1e3:.2f} us, int64 form "
              f"{plain_ms * 1e3:.1f} us, bound {bound_ms * 1e3:.3f} us "
              f"(bytes); hash_uniform {host_us:.1f} us of the host a call",
              flush=True)
    end = hash_counts()
    calls, launches = pt_hash
    check(calls == launches == 92 * SETTINGS["sample_per_pixel"],
          f"rng_hash: phase 5 made {launches} launches of {calls} calls")
    row["launches_by_path"] = {"bunny path_tracing (phase 5)": launches}
    row["launches"] = end["rng.hash_launches"] - start_hash[
        "rng.hash_launches"]
    row["calls_in_the_run"] = end["rng.hash_calls"] - start_hash[
        "rng.hash_calls"]
    print(f"  phase 5: {launches} launches of {calls} calls; the run: "
          f"{row['launches']} launches of {row['calls_in_the_run']} calls "
          f"(the CPU's launch none)", flush=True)
    return row


# phase 28: timed launches of the drain's kernels from their entries at the
# full-size cell's shapes (a few microseconds of the host each), and the
# whole drain in both forms
DRAIN_REPS = 100
DRAIN_WALL_REPS = 5
DRAIN_IT = 5


def drain_kernel_path(sppm_launches):
    """Phase 28: the drain's three kernels (csrc/sppm_drain.cu) against
    their plain forms on bunny.json as shipped at full size, iteration
    DRAIN_IT's first photon chunk, bit for bit, each timed beside its plain
    form and its bound (the bytes it must move: each input byte once, the
    rows and entries that the visible points' cells hold); the whole drain
    in pair form against the loop on the same tensors, bit for bit, and the
    wall time of each. sppm_launches is phase 8's (kernel drains, drains).
    Returns the kernel table's row."""
    import torch

    from goblin_tpu_torch import telemetry
    from goblin_tpu_torch.integrators import sppm
    from goblin_tpu_torch.ops import trace as tt
    from goblin_tpu_torch.scene.loader import load_scene

    lib = tt._kernel_lib("sppm_drain")
    stream = torch.cuda.current_stream().cuda_stream
    row = {"name": "sppm_drain", "route": "cuda",
           "source": "goblin_tpu_torch/csrc/sppm_drain.cu",
           "replaces": "none: goblin_tpu/integrators/sppm.py::vp_drain is a "
                       "jax.lax.while_loop of jnp turns", "library_ms": None,
           "by_kernel": {}}
    with torch.inference_mode():
        scene, meta = load_scene(BUNNY, device="cuda")
        spec = meta.camera.film
        n_pix = spec.x_res * spec.y_res
        max_len = int(meta.settings["max_ray_depth"])
        ids = torch.arange(n_pix, dtype=torch.int32, device="cuda")
        _, vp = sppm.make_ray_pass(scene, meta, 0, max_len, 10)(ids, DRAIN_IT)
        radius = torch.full((n_pix,), float(meta.settings["initial_radius"]),
                            device="cuda")
        bbox_min, inv_len, max_r = sppm.vp_cell_meta(vp, radius)
        deposit, _ = sppm.make_photon_passes(scene, meta, 77, max_len, n_pix)
        rows, e_hash, e_idx = deposit(ids[:sppm.PHOTON_CHUNK], DRAIN_IT,
                                      bbox_min, inv_len, max_r)
        start, end = sppm._drain_cells(vp, e_hash, bbox_min, inv_len, n_pix)
        r2 = radius * radius
        budget = float(max_len) - vp["len"].to(torch.float32)
        test = (start, end, e_idx, rows, vp["p"], r2, budget)
        counts = sppm.drain_match(*test)
        check(torch.equal(counts, sppm.drain_match_plain(*test)),
              "sppm_drain: the count pass differs from its plain form")
        ends = torch.cumsum(counts, 0, dtype=torch.int64)
        n_pairs = int(ends[-1])
        fill = (counts, ends, n_pairs)
        pair_row, point = sppm.drain_match(*test, fill=fill)
        ref_row, ref_point = sppm.drain_match_plain(*test, fill=fill)
        check(torch.equal(pair_row, ref_row) and torch.equal(point,
                                                             ref_point),
              "sppm_drain: the fill pass differs from its plain form")
        contrib = torch.rand((n_pairs, 3), device="cuda")
        Phi = torch.rand((n_pix, 3), device="cuda")
        Mi = torch.rand(n_pix, device="cuda")
        got = sppm.drain_sum(Phi, Mi, contrib, counts, ends)
        ref = sppm.drain_sum_plain(Phi, Mi, contrib, counts, ends)
        check(torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]),
              "sppm_drain: the sum differs from its plain form")
        # the bytes each must move: the entries in the points' cells and
        # their rows' p and path length, once each
        n = (end - start).clamp(min=0)
        cover = torch.zeros(e_idx.shape[0] + 1, dtype=torch.int64,
                            device="cuda")
        cover.index_add_(0, start, torch.ones_like(start))
        cover.index_add_(0, end, -torch.ones_like(end))
        live = torch.cumsum(cover, 0)[:-1] > 0
        n_entries = int(live.sum())
        n_rows = int(torch.unique(e_idx[live]).shape[0])
        match_in = n_pix * 36 + n_entries * 4 + n_rows * 16
        byte_counts = {"count": match_in + n_pix * 4,
                       "fill": match_in + n_pix * 12 + n_pairs * 16,
                       "sum": n_pix * 28 + n_pairs * 12 + n_pix * 16}
        arrays = [a.contiguous() for a in test]
        ptrs = [a.data_ptr() for a in arrays]
        out_c = torch.empty_like(counts)
        pairs = torch.empty((2, n_pairs), dtype=torch.int64, device="cuda")
        phi_o, mi_o = torch.empty_like(Phi), torch.empty_like(Mi)
        entries = {
            "count": (lambda: lib.goblin_sppm_drain_count(
                n_pix, *ptrs, out_c.data_ptr(), stream),
                lambda: sppm.drain_match_plain(*test)),
            "fill": (lambda: lib.goblin_sppm_drain_fill(
                n_pix, *ptrs, counts.data_ptr(), ends.data_ptr(),
                pairs[0].data_ptr(), pairs[1].data_ptr(), stream),
                lambda: sppm.drain_match_plain(*test, fill=fill)),
            "sum": (lambda: lib.goblin_sppm_drain_sum(
                n_pix, counts.data_ptr(), ends.data_ptr(),
                contrib.data_ptr(), Phi.data_ptr(), Mi.data_ptr(),
                phi_o.data_ptr(), mi_o.data_ptr(), stream),
                lambda: sppm.drain_sum_plain(Phi, Mi, contrib, counts,
                                             ends))}
        for name, (launch, plain) in entries.items():
            ms = time_ms(launch, DRAIN_REPS)
            plain_ms = time_ms(plain, KERNEL_REPS)
            bound_ms = byte_counts[name] / PEAK_BYTES_S * 1e3
            row["by_kernel"][name] = {
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": "bytes", "bytes": byte_counts[name],
                "roofline_share": bound_ms / ms}
            print(f"  {name}: kernel {ms * 1e3:.2f} us, plain form "
                  f"{plain_ms * 1e3:.1f} us, bound {bound_ms * 1e3:.3f} us "
                  f"({byte_counts[name]:,} B)", flush=True)
        check(torch.equal(out_c, counts) and torch.equal(pairs[0], pair_row)
              and torch.equal(phi_o, got[0]) and torch.equal(mi_o, got[1]),
              "sppm_drain: the entries' timed launches differ")
        # the whole drain, both forms, onto the same sums
        drains = {}
        for form in (sppm.drain_pairs, sppm.drain_loop):
            def call():
                return form(scene, meta, max_len, n_pix, vp, radius, rows,
                            e_hash, e_idx, bbox_min, inv_len, Phi, Mi)
            out = call()
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(DRAIN_WALL_REPS):
                call()
            torch.cuda.synchronize()
            drains[form.__name__] = (out, (time.perf_counter() - t)
                                     / DRAIN_WALL_REPS * 1e3)
        (a, pair_ms), (b, loop_ms) = drains["drain_pairs"], drains["drain_loop"]
        check(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]),
              "sppm_drain: the pair form differs from the loop")
    turns = int((end - start).max())
    row.update(points=n_pix, candidates=int(n.sum()), pairs=n_pairs,
               turns=turns, entries_in_cells=n_entries, rows_read=n_rows,
               drain_wall_ms={"pairs": pair_ms, "loop": loop_ms})
    print(f"  iteration {DRAIN_IT}, first chunk: {n_pix} points, "
          f"{int(n.sum())} candidates, {n_pairs} pairs, {turns} turns; the "
          f"whole drain {pair_ms:.2f} ms in pair form, {loop_ms:.2f} ms as "
          "the loop (wall, synchronized), bit-equal", flush=True)
    kernel_drains, drains_run = sppm_launches
    check(kernel_drains == drains_run > 0,
          f"sppm_drain: phase 8 ran {kernel_drains} of {drains_run} drains "
          "through the kernels")
    row["launches_by_path"] = {"bunny sppm (phase 8), count passes":
                               kernel_drains}
    row["launches"] = telemetry.counters.get("sppm.drain_launches", 0)
    return row


def run():
    import torch

    check(torch.cuda.is_available(), "CUDA is not available")
    from goblin_tpu_torch import telemetry
    from goblin_tpu_torch.ops import trace as tt
    from goblin_tpu_torch.scene.loader import load_scene

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

    start_hash = hash_counts()
    print("[3] kernel vs plain, bunny pass-0 wavefronts:", flush=True)
    scene, meta = load_scene(BUNNY, SETTINGS, device="cuda")
    row = compare_kernel(scene, meta)
    del scene

    print("[4] card vs CPU reference render:", flush=True)
    reference_check(PT_CHECK, BUNNY)

    print("[5] main path (path tracing):", flush=True)
    before = hash_counts()
    pt_launches = main_path()
    after = hash_counts()
    pt_hash = tuple(after[k] - before[k]
                    for k in ("rng.hash_calls", "rng.hash_launches"))

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
    drains0 = [telemetry.counters.get(k, 0)
               for k in ("sppm.drain_launches", "sppm.drain_reads")]
    sppm_counts = sppm_main_path()
    sppm_drains = tuple(telemetry.counters.get(k, 0) - c for k, c in zip(
        ("sppm.drain_launches", "sppm.drain_reads"), drains0))
    print(f"  drains through the kernels: {sppm_drains[0]} of "
          f"{sppm_drains[1]}", flush=True)

    print("[9] SPPM card vs CPU reference render (width 1):", flush=True)
    reference_check(SPPM_CHECK, BUNNY, wide=1)

    print("[10] the width-4 instance vs plain and vs width 8:", flush=True)
    w4 = {label: compare_width4(label, path)
          for label, path in (("bunny", BUNNY), ("studio", STUDIO))}

    print("[11] studio scene, path tracing through render_context:",
          flush=True)
    studio_counts = studio_main_path()
    reference_check(PT_CHECK, STUDIO, wide=4)

    print("[12] studio scene, SPPM through render_context:", flush=True)
    studio_sppm_launches, studio_sppm_s = studio_sppm_path()
    reference_check(SPPM_CHECK, STUDIO, wide=4)

    print("[13] gallery scene (the texture chain), path tracing through "
          "render_context:", flush=True)
    gallery_counts = gallery_main_path()
    reference_check(PT_CHECK)

    print("[14] gallery scene, ambient occlusion:", flush=True)
    ao_launches, ao_anyhit, ao_s = ao_path()
    reference_check({"render_method": "ao", "sample_per_pixel": 1})

    print("[15] gallery scene, Whitted:", flush=True)
    whitted_launches, whitted_s = whitted_path()
    reference_check({"render_method": "whitted", "sample_per_pixel": 1,
                            "max_ray_depth": WHITTED_DEPTH})

    print("[16] gallery scene, light tracing:", flush=True)
    lt_launches, lt_s = light_tracing_path()
    reference_check({"render_method": "light_tracing",
                            "sample_per_pixel": 1})
    light_tracing_estimators()

    print("[17] studio scene, BDPT through render_context:", flush=True)
    bdpt_launches, bdpt_s = bdpt_path()
    reference_check(BDPT_SETTINGS, STUDIO)
    with tempfile.TemporaryDirectory() as tmp:
        bdpt_against_pt(bdpt_plane_scene(tmp),
                        (-BDPT_CHECK_RTOL, BDPT_CHECK_RTOL))
    bdpt_against_pt(STUDIO, BDPT_STUDIO_GAP)

    print("[18] sky scene (an image-based light), path tracing through "
          "render_context, and every method at 48 x 36:", flush=True)
    env_pick_probability()
    sky_counts = sky_path()
    for ovr in SKY_CHECKS:
        reference_check(ovr, SKY)

    print("[19] fog scene (a homogeneous volume, a subsurface bunny, tone "
          "mapping, bloom, PPM), path tracing through render_context, "
          "whitted, every method at 48 x 36, the CLI:", flush=True)
    fog_counts, fog_s = medium_path(FOG, (8, 4), "homogeneous")
    fog_whitted_launches, fog_whitted_s = fog_whitted_path()
    for ovr in FOG_CHECKS:
        reference_check(ovr, FOG)
    fog_cli_s = fog_cli()

    print("[20] smoke scene (a heterogeneous volume, a marble subsurface "
          "bunny), path tracing through render_context:", flush=True)
    smoke_counts, smoke_s = medium_path(SMOKE, (8,), "heterogeneous")
    reference_check(PT_CHECK, SMOKE)

    print("[21] bunny.json gradients (light colour, tex_const, tri_rows) at "
          "widths 8, 4 and 1:", flush=True)
    grad_counts, grad_numbers = gradient_path()

    print("[22] gallery scene, the train step; edge-sampled boundary "
          "gradients on the card:", flush=True)
    train_launches, train_numbers = train_path()
    edge_rel = edge_path()

    print("[23] the regenerative driver: bunny.json at widths 8, 4 and 1 "
          "against the chunked driver, the studio, sky and fog scenes, "
          "48 x 36 card vs CPU:", flush=True)
    regen_counts, regen_bunny_numbers = regen_bunny()
    reference_check(PT_CHECK, BUNNY, regen=True)
    regen_scene_counts, regen_scene_numbers = regen_scenes()

    print("[24] the sharded steps over a process group:", flush=True)
    sharded_counts, sharded_numbers = sharded_path()

    print("[25] the measuring programs (bench_torch.py pt, methods, scaling, "
          "trace) at 512 x 384:", flush=True)
    bench_counts, bench_s = bench_path()

    print("[26] the entry points: entry() and dryrun_multichip on the "
          "card; the fog scene's gradients, card vs CPU:", flush=True)
    t26 = time.perf_counter()
    entry_counts, entry_numbers = entry_path()
    dryrun_counts, dryrun_numbers = dryrun_path()
    fog_grad_counts, fog_grad_s = fog_gradient_path()
    entry_numbers["phase_26_s"] = time.perf_counter() - t26
    print(f"  phase 26: {entry_numbers['phase_26_s']:.1f} s; {smi}",
          flush=True)

    print("[27] the sample hash's kernel vs its int64 form:", flush=True)
    hash_row = hash_kernel_path(pt_hash, start_hash)

    print("[28] SPPM's drain kernels vs their plain forms, the pair form vs "
          "the loop:", flush=True)
    drain_row = drain_kernel_path(sppm_drains)

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
    # launches: every render that went through render_context in this run,
    # read with the counters set to 0 just before it, by path; the row's
    # launches is their sum (a path driven in turns counts its last turn)
    spp = SETTINGS["sample_per_pixel"]
    by_path = {
        "trace_bvh8": {
            "bunny path_tracing": pt_launches,
            "bunny sppm": sppm_counts[8],
            "studio path_tracing": studio_counts[8],
            "gallery path_tracing": gallery_counts[8],
            "gallery ao": ao_launches,
            f"gallery whitted depth {WHITTED_DEPTH}": whitted_launches,
            "gallery light_tracing": lt_launches,
            "studio bdpt": bdpt_launches,
            "sky path_tracing": sky_counts[8],
            "fog path_tracing": fog_counts[8],
            f"fog whitted depth {FOG_WHITTED_DEPTH}": fog_whitted_launches,
            "smoke path_tracing": smoke_counts[8],
            "bunny gradient pass": grad_counts[8],
            "gallery train step": train_launches,
            "bunny path_tracing regenerative": regen_counts[8],
            **{f"{k} path_tracing regenerative": v
               for k, v in regen_scene_counts.items()},
            **sharded_counts,
            **{k: v for k, v in bench_counts.items() if "trace_bvh8" in v},
            f"entry() fn, a call of {ENTRY_BATCHES[-1]} ids": entry_counts,
            f"dryrun_multichip({dryrun_numbers['world']}), rank 0":
                dryrun_counts,
            "fog gradient pass 48x36": fog_grad_counts,
        },
        "trace_bvh2": {"bunny sppm": sppm_counts[1],
                       "bunny gradient pass": grad_counts[1],
                       "bunny path_tracing regenerative": regen_counts[1],
                       **{k: v for k, v in bench_counts.items()
                          if "trace_bvh2" in v}},
        "trace_bvh4": {
            "studio path_tracing": studio_counts[4],
            "studio sppm": studio_sppm_launches,
            "gallery path_tracing": gallery_counts[4],
            "sky path_tracing": sky_counts[4],
            "fog path_tracing": fog_counts[4],
            "bunny gradient pass": grad_counts[4],
            "bunny path_tracing regenerative": regen_counts[4],
            **{k: v for k, v in bench_counts.items()
               if "trace_bvh4" in v},
        },
    }
    for r, width in ((row, 8), (k2_row, 1), (stats_row, 8)):
        name = r["name"]
        r["launches_per_pt_pass"] = pt_launches[name] // spp
        r["launches_per_sppm_iteration"] = (sppm_counts[width][name]
                                            // SPPM_ITERATIONS)
    # the width-4 row: bunny's primary frame like the rows above, the studio
    # scene's beside it
    w4_row = {"name": "trace_bvh4", "route": "cuda",
              "source": "goblin_tpu_torch/csrc/trace_bvh8.cu",
              "replaces": "goblin_tpu/ops/pallas_trace.py:522",
              "instance": "-DGOBLIN_TRACE_WIDTH=4", **w4["bunny"],
              "studio": w4["studio"],
              "launches_per_pt_pass": studio_counts[4]["trace_bvh4"] // spp,
              "launches_per_sppm_iteration":
                  studio_sppm_launches["trace_bvh4"] // STUDIO_SPPM_ITERATIONS,
              "studio_sppm_s_per_iteration": studio_sppm_s}
    for r in (row, k2_row, w4_row):
        paths = {path: counts[r["name"]]
                 for path, counts in by_path[r["name"]].items()}
        check(all(paths.values()), f"{r['name']}: a path launched it no "
                                   f"time: {paths}")
        r["launches_by_path"] = paths
        r["launches"] = sum(paths.values())
    # the largest launch any path makes: AO's any-hit batch
    row["ao_anyhit"] = ao_anyhit
    row["seconds"] = {"gallery ao pass with the load": ao_s,
                      f"gallery whitted depth {WHITTED_DEPTH} pass with the "
                      "load": whitted_s,
                      "gallery light_tracing chunks 2-12": lt_s,
                      "studio bdpt chunks 1-3 with the load": [
                          float(c) for c in bdpt_s],
                      "fog path_tracing steady pass by width": fog_s,
                      f"fog whitted depth {FOG_WHITTED_DEPTH} pass with the "
                      "load": fog_whitted_s,
                      "fog CLI 16 spp": fog_cli_s,
                      "smoke path_tracing steady pass": smoke_s[8],
                      "bunny gradient pass by width": grad_numbers,
                      "gallery train step": train_numbers,
                      "regenerative driver, bunny by width":
                          regen_bunny_numbers,
                      "regenerative driver, other scenes at width 8":
                          regen_scene_numbers,
                      "sharded steps": sharded_numbers,
                      "phase 25 (the measuring programs)": bench_s,
                      "phase 26 entry()": entry_numbers,
                      "phase 26 dryrun_multichip": dryrun_numbers,
                      "phase 26 fog gradient pass 48x36 on the card":
                          fog_grad_s}
    row["edge_gradient_card_vs_cpu_rel"] = edge_rel
    # no render path runs the stats instance: its row counts phase 7's census
    stats_row["launches"] = stats_launches
    stats_row["launches_counted_in"] = "phase 7's visit census"
    row["ptxas"] = ptxas["trace_bvh8"].get("production")
    stats_row["ptxas"] = ptxas["trace_bvh8"].get("stats")
    k2_row["ptxas"] = ptxas["trace_bvh2"].get("production")
    w4_row["ptxas"] = ptxas["trace_bvh4"].get("production")
    w4_row["ptxas_stats"] = ptxas["trace_bvh4"].get("stats")
    hash_row["ptxas"] = ptxas["rng_hash"].get("production")
    for r in (row, k2_row, stats_row, w4_row, hash_row):
        check(r["ptxas"] and "registers" in r["ptxas"],
              f"{r['name']}: no ptxas numbers in the build's output")
    drain_row["ptxas"] = {
        ("fill" if "ILb1E" in name else "count") if "match" in name
        else "sum": numbers
        for name, numbers in ptxas_by_entry(builds["sppm_drain"][1]).items()}
    check(all("registers" in drain_row["ptxas"].get(k, {})
              for k in ("count", "fill", "sum")),
          "sppm_drain: no ptxas numbers in the build's output")
    print(smi)
    print(json.dumps({"kernels": [row, k2_row, stats_row, w4_row,
                                  hash_row, drain_row]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    try:
        if sys.argv[1:2] == [SHARDED_CHILD_FLAG]:
            sharded_child(sys.argv[2])
        else:
            run()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
