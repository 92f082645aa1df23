#!/usr/bin/env python3
"""goblin_tpu_torch's measuring programs on one NVIDIA GPU: the
counterparts of bench.py, bench_methods.py, bench_scaling.py and
bench_trace.py, on bunny.json at 512 x 384.

    python3 bench_torch.py [pt [--wide 8|4|1] | methods | scaling | trace]
    torchrun --nproc_per_node N bench_torch.py scaling   # one rank a card

pt (the default) prints bench.py's throughput line, methods one line a
method, scaling the sharded pass's overhead, trace one line a captured
wavefront class and trace width and then the best width a class. The first
line is the card's name and power limit as nvidia-smi prints them; every
other line is one JSON object. --wide is pt's trace width (methods and
scaling trace at width 8, trace at every width). Every chunk is
goblin_tpu_torch.bench.CHUNK pixels; the workloads are that module's.

Runs on the card only. It exits non-zero and prints no JSON line where
torch sees no CUDA device, where a kernel does not build, or where a line's
trace kernels launched no time, so a line always means that the
hand-written kernels ran. It writes no file.
"""

import argparse
import json
import os
import subprocess
import sys

from goblin_tpu_torch import bench

COMMANDS = ("pt", "methods", "scaling", "trace")


class BenchError(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise BenchError(msg)


def card_fields():
    """The card's name and power limit and the versions, for every line."""
    import torch

    smi = bench.nvidia_smi("name,power.limit")
    return {"device": torch.cuda.get_device_name(0),
            "power_limit": smi.split(", ")[-1], "torch": torch.__version__,
            "cuda": torch.version.cuda}


def pt(wide=8):
    """bench.py's line (bench.py:32-121): bunny.json as path tracing at
    depth 5, 4 spp, seed 0, chunks of 65,536 pixels; one warm-up pass, 4
    timed passes, the census of pass 0 over every pixel. bench.py's fields
    but vs_baseline (its baseline is a TPU target) and trace_backend, whose
    place trace_wide takes."""
    scene, meta = bench.load_bunny(bench.PT_SETTINGS, "cuda", trace_wide=wide)
    line = bench.run_pt(scene, meta)
    check(line["trace_launches_per_pass"] > 0, "pt: no trace kernel launched")
    return dict(line, **card_fields())


def methods():
    """bench_methods.py's lines (bench_methods.py:37-86): SPPM, BDPT and
    light tracing on bunny.json at depth 5, 2 spp, initial radius 0.01,
    through render_dispatch at each renderer's own chunk; a warm-up render,
    then one timed render. No file is written (bench_methods.py writes
    bench_methods.json)."""
    lines = []
    for method in bench.METHODS:
        scene, meta = bench.load_bunny(bench.method_settings(method), "cuda")
        line = bench.run_method(method, scene, meta)
        check(line["trace_launches"] > 0, f"{method}: no trace kernel "
                                          "launched")
        lines.append(dict(line, **card_fields()))
        del scene
    return lines


def join_group():
    """Join an NCCL group: torchrun's (its variables in the environment),
    else one of world 1 in this process on a free local port; rank r on
    cuda:{r % cards}."""
    import torch
    import torch.distributed as dist

    from goblin_tpu_torch.parallel import multihost

    if "LOCAL_RANK" in os.environ:
        dist.init_process_group("nccl", init_method="env://")
    else:
        dist.init_process_group(
            "nccl", init_method=f"tcp://localhost:{multihost.free_port()}",
            world_size=1, rank=0)
    torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())


def scaling():
    """bench_scaling.py --tpu's line (bench_scaling.py:108-136): bunny at
    512 x 384, 1 spp, depth 5, one prebuilt pass of make_render_pass against
    render_sharded_dense on an NCCL group, each a second call's seconds.
    World 1 in this process ("mode" gpu-1card); under torchrun one rank a
    card, and rank 0's line has meshN_mrays and efficiency_N = t1 / (N tN).
    bench_scaling.py's default fake 8-device mesh on the CPU is not carried
    over (a CPU time is no device metric); its image check is a CPU test.
    Returns rank 0's line, None on the other ranks. No file is written
    (bench_scaling.py writes bench_scaling.json)."""
    import torch.distributed as dist

    from goblin_tpu_torch.parallel.mesh import make_mesh

    join_group()
    try:
        mesh = make_mesh(device="cuda")
        scene, meta = bench.load_bunny(bench.scaling_settings(), mesh.device)
        line, _ = bench.run_scaling(scene, meta, mesh)
        backend = dist.get_backend()
    finally:
        dist.destroy_process_group()
    check(line["trace_launches_per_sharded_pass"] > 0,
          "scaling: no trace kernel launched")
    if mesh.rank != 0:
        return None
    return dict(line, mode=f"gpu-{mesh.world}card", backend=backend,
                trace_wide=meta.trace_wide, **card_fields())


def trace():
    """bench_trace.py's measurement (bench_trace.py:51-221) with the port's
    one knob, the trace width: the wavefronts of pass 0 of bunny path
    tracing at depth 5 over the whole frame (primary, shadow b1-b4,
    continuation b1-b3; a class's calls of the frame's three chunks
    joined), each replayed in one launch through K1 at width 8, K1 at
    width 4 and K2 (width 1) on that width's own bake, timed over 20
    launches after a warm-up, beside its bound from the plain version's
    census and the class's live lanes; hit masks and t against width 8's
    (the render's own launches). Then the best width a class. goblin_tpu's
    rows / ways / bf16_box grid and its ray reorders are TPU artifacts and
    are not carried over. Returns the lines."""
    from goblin_tpu_torch.ops import trace as tt

    loaded = {w: bench.load_bunny(bench.PT_SETTINGS, "cuda", trace_wide=w)
              for w in bench.WIDTHS}
    scenes = {w: scene for w, (scene, _) in loaded.items()}
    meta = loaded[8][1]
    waves = bench.capture_wavefronts(scenes[8], meta)
    card = card_fields()
    lines, best = [], {}
    for wave in waves:
        lanes = wave["o"].shape[0]
        live = bench.live_lanes(wave)
        for w in bench.WIDTHS:
            scene = scenes[w]
            hits, t_ok = bench.results_agree(bench.replay(scene, wave, w),
                                             wave["result"], wave["any_hit"])
            tt.reset_launches()
            ms = bench.time_ms(lambda: bench.replay(scene, wave, w),
                               bench.KERNEL_REPS)
            launches = tt.launches[bench.KERNELS[w]]
            check(launches > 0, f"trace {wave['name']} width {w}: no "
                                "launch")
            box, tri = bench.replay_work(scene, wave, w)
            b = bench.bound(lanes, bench.table_bytes(
                scene, bench.table_names(w)), box, tri, ms, live=live)
            line = {"metric": "bunny_trace_class", "class": wave["name"],
                    "any_hit": wave["any_hit"], "trace_wide": w,
                    "kernel": bench.KERNELS[w], "lanes": lanes, "live": live,
                    "mrays": lanes / ms / 1e3, "live_mrays": live / ms / 1e3,
                    "ms": ms, "bound_ms": b["bound_ms"],
                    "bound_by": b["bound_by"],
                    "share_of_bound": b["roofline_share"],
                    "box_tests": box, "tri_tests": tri,
                    "hits_equal_width8": hits, "t_within_rtol_width8": t_ok,
                    "trace_launches": launches, **card}
            lines.append(line)
            if wave["name"] not in best or ms < best[wave["name"]]["ms"]:
                best[wave["name"]] = {"trace_wide": w, "ms": ms,
                                      "mrays": line["mrays"]}
    lines.append({"metric": "bunny_trace_best_width", "best": best,
                  "lanes": lanes, **card})
    return lines


def run(args):
    """The subcommand's lines, after the card's line and the builds."""
    import torch

    check(torch.cuda.is_available(), "CUDA is not available: bench_torch.py "
                                     "runs on the card only")
    from goblin_tpu_torch.ops import trace as tt

    print(bench.nvidia_smi("name,power.limit"), flush=True)
    try:
        tt.build_kernels()
    except (RuntimeError, OSError, subprocess.SubprocessError) as e:
        raise BenchError(f"a trace kernel did not build: {e}") from e
    if args.command == "pt":
        return [pt(args.wide or 8)]
    if args.command == "methods":
        return methods()
    if args.command == "scaling":
        line = scaling()
        return [] if line is None else [line]
    return trace()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="bench_torch.py")
    ap.add_argument("command", nargs="?", default="pt", choices=COMMANDS)
    ap.add_argument("--wide", type=int, choices=(8, 4, 1),
                    help="pt's trace width (default 8)")
    args = ap.parse_args(argv)
    if args.wide is not None and args.command != "pt":
        ap.error(f"--wide applies to pt only, not {args.command}")
    try:
        lines = run(args)
    except BenchError as e:
        print(f"bench_torch: FAILED: {e}", file=sys.stderr)
        return 1
    for line in lines:
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
