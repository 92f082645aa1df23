#!/usr/bin/env python3
"""Where a pass's time goes on the card: torch.profiler over one steady
pass of goblin_tpu_torch's render of a scene.

    python3 chip_profile.py SCENE.json [render_method] [--wide 1|4|8]

The scene renders through render_context with 4 passes (path tracing) or 4
iterations (SPPM) at its own size and depth: the first warms up, the
second runs under the profiler, the last two give the wall time without it.
Printed: the card's name and power limit, the profiled pass's wall
seconds, the device kernels it launched and their summed device time (so
the device's busy share of the pass), the trace kernels' launches and
time, the device-to-host reads (each one stalls the host), the 12 kernels
with the most device time, and one JSON line with the same numbers. Needs
a CUDA device; exits non-zero without one.
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
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    ap = argparse.ArgumentParser(prog="chip_profile.py")
    ap.add_argument("scene")
    ap.add_argument("render_method", nargs="?")
    ap.add_argument("--wide", type=int, default=8)
    args = ap.parse_args(argv)
    cs.check(torch.cuda.is_available(), "CUDA is not available")
    sys.path.insert(0, cs.REPO)
    from goblin_tpu_torch.ops import trace as tt
    from goblin_tpu_torch.render import render_context

    smi = cs.nvidia_smi("name,power.limit")
    print(smi, flush=True)
    tt.build_kernels()
    ovr = {"sample_per_pixel": PASSES}
    if args.render_method:
        ovr["render_method"] = args.render_method
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
    cs.check(len(marks) == PASSES + 2, f"{len(marks)} marks: the render did "
                                       f"not report {PASSES} passes")
    # marks: end of 1, profiler on, end of 2, profiler off, end of 3, end of 4
    profiled_s = marks[2] - marks[1]
    plain_s = [marks[4] - marks[3], marks[5] - marks[4]]

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


if __name__ == "__main__":
    try:
        run(sys.argv[1:])
    except cs.SmokeFailure as e:
        print(f"chip_profile: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
