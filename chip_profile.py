#!/usr/bin/env python3
"""Where a pass's time goes on the card: torch.profiler over one steady
pass of goblin_tpu_torch's render of a scene.

    python3 chip_profile.py SCENE.json [render_method] [--wide 1|4|8]
                            [--depth N] [--grad | --regen]

The scene renders through render_context with 4 passes (path tracing, ao,
whitted) or 4 iterations (SPPM) at its own size, and at its own depth
unless --depth gives max_ray_depth: the first warms up, the second runs
under the profiler, the next two give the wall time without it. Light tracing and
BDPT report a chunk at a time (16,384 light paths; 65,536 camera samples):
their "passes" here are the first four chunks of a 4-spp render.
Printed: the card's name and power limit, the profiled pass's wall
seconds, the device kernels it launched and their summed device time (so
the device's busy share of the pass), the trace kernels' launches and
time, the device-to-host reads (each one stalls the host), the 12 kernels
with the most device time, and one JSON line with the same numbers. Needs
a CUDA device; exits non-zero without one.

With --grad it profiles chip_smoke.py's gradient pass instead (1 spp, the
loss mean(L * [1, 2, 3]) and its gradients with respect to the light
colours, tex_const and tri_rows, chunk by chunk): after one unprofiled
gradient pass, a forward pass without autograd and a gradient pass run
under the profiler, and the backward's device kernels and time are the
second's less the first's.

With --regen it profiles path tracing by both drivers (4 spp): after one
unprofiled render by each, a whole render by the chunked driver and one by
the regenerative driver (pool 65,536) run under the profiler, then one of
each without it; the numbers a pass are a render's over its 4 passes.
"""

import argparse
import collections
import json
import os
import sys
import time

import chip_smoke as cs

PASSES = 4
TOP = 12


def run(argv):
    import torch
    from torch.profiler import ProfilerActivity, profile

    ap = argparse.ArgumentParser(prog="chip_profile.py")
    ap.add_argument("scene")
    ap.add_argument("render_method", nargs="?")
    ap.add_argument("--wide", type=int, default=8)
    ap.add_argument("--depth", type=int)
    ap.add_argument("--grad", action="store_true")
    ap.add_argument("--regen", action="store_true")
    args = ap.parse_args(argv)
    cs.check(torch.cuda.is_available(), "CUDA is not available")
    sys.path.insert(0, cs.REPO)
    from goblin_tpu_torch.ops import trace as tt
    from goblin_tpu_torch.render import render_context

    smi = cs.nvidia_smi("name,power.limit")
    print(smi, flush=True)
    tt.build_kernels()
    if args.grad:
        return profile_grad(args, smi)
    if args.regen:
        return profile_regen(args, smi)
    ovr = {"sample_per_pixel": PASSES}
    if args.render_method:
        ovr["render_method"] = args.render_method
    if args.depth is not None:
        ovr["max_ray_depth"] = args.depth
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    marks, launches = [], {}

    def report(done, total):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        if done == 1:
            tt.reset_launches()
            prof.start()
            marks.append(time.perf_counter())
        elif done == 2:
            prof.stop()
            launches.update(tt.launches)
            marks.append(time.perf_counter())

    _, meta = render_context(args.scene, ovr, device="cuda", report=report,
                             trace_wide=args.wide)
    cs.check(len(marks) >= PASSES + 2, f"{len(marks)} marks: the render did "
                                       f"not report {PASSES} passes")
    # marks: end of 1, profiler on, end of 2, profiler off, end of 3, end of 4
    profiled_s = marks[2] - marks[1]
    plain_s = [marks[4] - marks[3], marks[5] - marks[4]]

    by_name, host_reads, n_kernels, device_s = device_events(prof)
    trace = {k: v for k, v in by_name.items() if "trace_" in k}
    trace_n = sum(v[0] for v in trace.values())
    trace_s = sum(v[1] for v in trace.values()) * 1e-6
    method = meta.settings["render_method"]
    spec = meta.camera.film
    print(f"{os.path.basename(args.scene)} {method} {spec.x_res}x{spec.y_res} "
          f"depth {meta.settings['max_ray_depth']} width {args.wide}: pass 2 "
          f"under the profiler {profiled_s:.4f} s, passes 3-4 without it "
          f"{plain_s[0]:.4f} {plain_s[1]:.4f} s", flush=True)
    print(f"  device kernels and copies {n_kernels}, device time "
          f"{device_s * 1e3:.2f} ms = {device_s / profiled_s:.4f} of the "
          f"profiled pass, {device_s / min(plain_s):.4f} of the fastest "
          f"pass without the profiler; trace kernels {trace_n} launches "
          f"(counters: {launches}), {trace_s * 1e3:.3f} ms; device-to-host "
          f"reads (aten::_local_scalar_dense) {host_reads}", flush=True)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:TOP]
    for name, (count, us) in top:
        print(f"  {us * 1e-3:9.3f} ms {count:7d} x {name[:110]}")
    print(json.dumps({
        "card": smi, "scene": os.path.basename(args.scene), "method": method,
        "trace_wide": args.wide, "profiled_pass_s": profiled_s,
        "unprofiled_pass_s": plain_s, "device_events": n_kernels,
        "device_s": device_s, "trace_launches": trace_n, "trace_s": trace_s,
        "trace_counters": launches, "host_reads": host_reads}))


def device_events(prof):
    """A profile's device kernels and copies by name ([count, device us]),
    its device-to-host reads, their count and their device seconds."""
    from torch.autograd import DeviceType

    by_name = collections.defaultdict(lambda: [0, 0.0])
    host_reads = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name][0] += 1
            by_name[e.name][1] += e.device_time_total
        elif e.name == "aten::_local_scalar_dense":
            host_reads += 1
    n_kernels = sum(v[0] for v in by_name.values())
    device_s = sum(v[1] for v in by_name.values()) * 1e-6
    cs.check(n_kernels > 0 and device_s > 0.0,
             "the profiler saw no device activity")
    return by_name, host_reads, n_kernels, device_s


def profile_grad(args, smi):
    """--grad: the forward pass and the gradient pass under the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from goblin_tpu_torch.ops import trace as tt
    from goblin_tpu_torch.scene.loader import load_scene

    ovr = dict(cs.GRAD_SETTINGS)
    if args.depth is not None:
        ovr["max_ray_depth"] = args.depth
    scene, meta = load_scene(args.scene, ovr, device="cuda",
                             trace_wide=args.wide)
    cs.grad_pass(scene, meta)  # warm-up
    out = {}
    for name, fn in (("forward", cs.forward_loss), ("gradient", cs.grad_pass)):
        tt.reset_launches()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn(scene, meta)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        by_name, reads, n, dev_s = device_events(prof)
        out[name] = {"profiled_s": secs, "device_events": n,
                     "device_s": dev_s, "host_reads": reads,
                     "trace_counters": dict(tt.launches), "top": sorted(
                         by_name.items(), key=lambda kv: -kv[1][1])[:TOP]}
    t0 = time.perf_counter()
    _, _, st = cs.grad_pass(scene, meta)
    unprofiled = time.perf_counter() - t0
    fwd, grad = out["forward"], out["gradient"]
    bwd_n = grad["device_events"] - fwd["device_events"]
    bwd_s = grad["device_s"] - fwd["device_s"]
    spec = meta.camera.film
    print(f"{os.path.basename(args.scene)} gradient pass {spec.x_res}x"
          f"{spec.y_res} depth {meta.settings['max_ray_depth']} width "
          f"{args.wide}: forward under the profiler {fwd['profiled_s']:.4f} "
          f"s, {fwd['device_events']} device kernels and copies, "
          f"{fwd['device_s'] * 1e3:.2f} ms device; forward + backward "
          f"{grad['profiled_s']:.4f} s, {grad['device_events']} device "
          f"kernels, {grad['device_s'] * 1e3:.2f} ms device; so the backward "
          f"{bwd_n} device kernels, {bwd_s * 1e3:.2f} ms; the gradient pass "
          f"without the profiler {unprofiled:.4f} s, peak memory a chunk "
          f"{' '.join(f'{b / 2 ** 30:.2f}' for b in st['peak_bytes'])} GiB; "
          f"reads {fwd['host_reads']} / {grad['host_reads']}; trace "
          f"launches {grad['trace_counters']}", flush=True)
    for name, (count, us) in grad["top"]:
        print(f"  {us * 1e-3:9.3f} ms {count:7d} x {name[:110]}")
    print(json.dumps({
        "card": smi, "scene": os.path.basename(args.scene), "mode": "grad",
        "trace_wide": args.wide, "forward": {k: v for k, v in fwd.items()
                                             if k != "top"},
        "gradient": {k: v for k, v in grad.items() if k != "top"},
        "backward_device_events": bwd_n, "backward_device_s": bwd_s,
        "gradient_pass_s": unprofiled,
        "peak_bytes_per_chunk": st["peak_bytes"]}))


def profile_regen(args, smi):
    """--regen: a whole 4-spp path-tracing render by the chunked driver and
    by the regenerative one, each under the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from goblin_tpu_torch.integrators import common, wavefront
    from goblin_tpu_torch.ops import trace as tt
    from goblin_tpu_torch.render import make_li
    from goblin_tpu_torch.scene.loader import load_scene

    ovr = {"render_method": "path_tracing", "sample_per_pixel": PASSES}
    if args.depth is not None:
        ovr["max_ray_depth"] = args.depth
    scene, meta = load_scene(args.scene, ovr, device="cuda",
                             trace_wide=args.wide)
    cs.check(wavefront.supports(meta), "the scene has a BSSRDF: the "
                                       "regenerative driver does not cover it")
    drivers = {
        "chunked": lambda: common.render(scene, meta, make_li(meta),
                                         chunk_size=cs.CHUNK),
        "regenerative": lambda: wavefront.render_wavefront(
            scene, meta, pool=cs.CHUNK, with_stats=True)[1],
    }
    out = {}
    for name, fn in drivers.items():
        fn()  # warm-up
    for name, fn in drivers.items():
        tt.reset_launches()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        launches = dict(tt.launches)
        by_name, reads, n, dev_s = device_events(prof)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        out[name] = {"profiled_pass_s": secs / PASSES,
                     "unprofiled_pass_s": plain_s / PASSES,
                     "device_events_per_pass": n / PASSES,
                     "device_s_per_pass": dev_s / PASSES,
                     "busy_share": dev_s / secs,
                     "host_reads_per_pass": reads / PASSES,
                     "trace_counters": launches}
        if name == "regenerative":
            out[name]["iterations"] = res["iterations"]
            out[name]["useful_segments"] = res["useful_segments"]
            out[name]["live_share"] = [v / res["pool"]
                                       for v in res["live_lanes"]]
        spec = meta.camera.film
        print(f"{os.path.basename(args.scene)} {name} {spec.x_res}x"
              f"{spec.y_res} {PASSES} spp depth "
              f"{meta.settings['max_ray_depth']} width {args.wide}, a pass: "
              f"{secs / PASSES:.4f} s under the profiler, {plain_s / PASSES:.4f}"
              f" s without; {n / PASSES:.1f} device kernels and copies, "
              f"{dev_s / PASSES * 1e3:.2f} ms device ({dev_s / secs:.4f} "
              f"busy); {reads / PASSES:.2f} device-to-host reads; trace "
              f"launches a render {launches}", flush=True)
        for kname, (count, us) in sorted(by_name.items(),
                                         key=lambda kv: -kv[1][1])[:TOP]:
            print(f"  {us * 1e-3:9.3f} ms {count:7d} x {kname[:110]}")
    print(json.dumps({"card": smi, "scene": os.path.basename(args.scene),
                      "mode": "regen", "trace_wide": args.wide,
                      "passes": PASSES, **out}))


if __name__ == "__main__":
    try:
        run(sys.argv[1:])
    except cs.SmokeFailure as e:
        print(f"chip_profile: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
