"""The control of a render cell's check: the plain reference in the
program's place, computed in bfloat16 (the precision below the
configuration's float32), judged by the same comparison as a run.

    python3 benchmarks/control.py --workload bunny.pt --passes 280 \
        --seeds 11,12,13

For each seed it renders the checked pixels' film over `passes` passes
(the number a run's window holds) in float32 and in bfloat16 and prints
one JSON line: the numbers the check compares, which are the limits'
upper readings. The benchmark's own runs never run it. It needs a CUDA
device unless --device cpu is given (the tests' small films).
"""

import argparse
import json
import os
import sys
import time

BENCH = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(BENCH), BENCH]

import torch  # noqa: E402

from benchlib import check, render, spec  # noqa: E402
from plainref import pathtrace, scene as rscene  # noqa: E402


def readings(cell_name, seed, passes, device, film=None, dtype=None):
    """The check's numbers for the reference in dtype against the
    reference in float32, over the passes a window of `passes` holds."""
    cell = spec.Cell(cell_name)
    tr = cell.traffic
    sc = rscene.load(cell.scene_path(), render.settings(cell, seed),
                     film=film)
    ids = check.pixels(seed, sc.camera.x_res, sc.camera.y_res,
                       int(tr["check"]["blocks"]), int(tr["check"]["block"]))
    spp = int(tr["spp"])
    depth = int(sc.settings.get("max_ray_depth", 5))
    s0 = int(tr["warmup"])
    films = []
    for dt in (torch.float32, dtype or torch.bfloat16):
        ren = pathtrace.Renderer(sc, device, dt)
        with torch.no_grad():
            films.append(pathtrace.film_at(ren, seed, ids, s0, passes, spp,
                                           pathtrace.grid(spp) ** 2, depth))
    (rc, rw), (cc, cw) = films
    numbers = check.compare(cc, cw, rc, rw)
    ok, rows = check.judge(numbers, tr["check"]["limits"])
    return ok, numbers


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--passes", type=int, required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        print("control: CUDA is not available", file=sys.stderr)
        return 1
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        ok, numbers = readings(args.workload, seed, args.passes, args.device)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "passes": args.passes, "control_correct": ok,
                          "numbers": numbers,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
