#!/usr/bin/env python3
"""Smoke run of goblin_tpu_torch's main path on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed on its own lines, and any failure exits non-zero:
  1. card: nvidia-smi's name and power limit, torch's device name;
  2. build: csrc/trace_bvh8.cu with nvcc (seconds, ptxas report);
  3. kernel vs plain: the BVH8 kernel against its plain PyTorch version on
     the full-frame bunny primary, bounce-1 continuation and bounce-1
     shadow wavefronts, traced in the main path's 65,536-ray chunks, in
     both hit modes, with times;
  4. reference: a 48 x 36 bunny render on the card against the CPU's;
  5. main path: bunny.json with path_tracing at 512 x 384, 4 spp, depth 5,
     chunk 65,536, through load_scene -> make_li -> render -> EXR; the
     image must be finite and non-black and the kernel must have launched
     8 times per chunk (1 primary, 4 shadow, 3 continuation) x 3 chunks
     x 4 passes = 96.
The last two lines are the kernel table and {"ok": true, "device": ...}.
"""

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
BUNNY = os.path.join(REPO, "examples", "bunny.json")
SETTINGS = {"render_method": "path_tracing", "max_ray_depth": 5,
            "sample_per_pixel": 4}
CHUNK = 1 << 16
EXPECTED_LAUNCHES = 8 * 3 * 4
KERNEL_REPS = 20


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi(query):
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def chunked(fn, scene, rays, any_hit):
    """fn over the main path's chunks, results concatenated."""
    import torch

    n = rays[0].shape[0]
    parts = [fn(scene, *(r[c:c + CHUNK] for r in rays), any_hit=any_hit)
             for c in range(0, n, CHUNK)]
    return [torch.cat(v) for v in zip(*parts)]


def time_ms(fn, reps):
    """Mean ms of fn() over reps calls, CUDA events around the batch."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def wavefronts(scene, meta):
    """Full-frame primary, bounce-1 continuation and bounce-1 shadow rays
    of pass 0, made by the port's raygen, intersect, BSDF and light code
    with the path tracer's sample dimensions."""
    import torch

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
    ray = meta.camera.generate_ray(x, y)
    primary = [ray["o"], ray["d"], ray["mint"], ray["maxt"]]
    frag = intersect(scene, meta, *primary, dxd=ray["dxd"], dyd=ray["dyd"])
    mat = gather_material(scene, meta, frag)
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
    ls = lt.sample_li(scene["lights"], lid, p, eps)
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


def reference_check():
    """Phase 4: a small render on the card against the plain CPU path."""
    import numpy as np

    from goblin_tpu_torch.integrators import common
    from goblin_tpu_torch.render import make_li
    from goblin_tpu_torch.scene.loader import load_scene

    ovr = dict(SETTINGS, sample_per_pixel=1)
    images = []
    for device in ("cpu", "cuda"):
        scene, meta = load_scene(BUNNY, ovr, device=device)
        meta.camera = dataclasses.replace(
            meta.camera,
            film=dataclasses.replace(meta.camera.film, x_res=48, y_res=36))
        images.append(common.render(scene, meta, make_li(meta)).cpu().numpy())
    cpu, gpu = images
    close = (np.abs(gpu - cpu) <= 1e-4 + 1e-3 * np.abs(cpu)).all(axis=-1)
    rel_mean = abs(gpu.mean() - cpu.mean()) / cpu.mean()
    print(f"  48x36 1 spp: pixels within 1e-4 + 1e-3 rel {close.mean():.4f}, "
          f"mean card {gpu.mean():.6f} cpu {cpu.mean():.6f} "
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
    launches = tt.launches
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
    check(launches == EXPECTED_LAUNCHES,
          f"kernel launches {launches}, expected {EXPECTED_LAUNCHES}")
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
    _, log = tt.build_kernel()
    print(f"[2] build: {time.perf_counter() - t:.2f} s", flush=True)
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "stack frame" in line:
            print(f"  {line.strip()}")

    print("[3] kernel vs plain, bunny pass-0 wavefronts:", flush=True)
    scene, meta = load_scene(BUNNY, SETTINGS, device="cuda")
    row = compare_kernel(scene, meta)
    del scene

    print("[4] card vs CPU reference render:", flush=True)
    reference_check()

    print("[5] main path:", flush=True)
    row["launches"] = main_path()
    print(f"  clocks.sm, power.draw, temperature: "
          f"{nvidia_smi('clocks.sm,power.draw,temperature.gpu')}")
    print(smi)
    print(json.dumps({"kernels": [row]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    try:
        run()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
