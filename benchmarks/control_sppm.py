"""The control of the SPPM cell's check: the SPPM reference computed in
bfloat16 (the precision below the configuration's float32) in the
program's place, judged by the same comparison as a run.

    python3 benchmarks/control_sppm.py --workload bunny_shipped.sppm \
        --iterations 40 --seeds 11,12,13

For each seed it computes the checked pixels' film, and the state at the
pixels their filter reads, over `iterations` iterations (the number a
run's window holds) in float32 and in bfloat16, and prints one JSON line:
the numbers the check compares, which are the limits' upper readings. The
benchmark's own runs never run it. It needs a CUDA device unless
--device cpu is given (the tests' small films).
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
from plainref_sppm import sppm as rsppm  # noqa: E402


def readings(cell_name, seed, iterations, device, film=None, dtype=None):
    """The check's numbers for the reference in dtype against the
    reference in float32, over the iterations a window of `iterations`
    holds -> (correct, numbers)."""
    cell = spec.Cell(cell_name)
    tr = cell.traffic
    sc = rsppm.load(cell.scene_path(), render.settings(cell, seed),
                    film=film)
    ids = check.pixels(seed, sc.camera.x_res, sc.camera.y_res,
                       int(tr["check"]["blocks"]), int(tr["check"]["block"]))
    s0 = int(tr["warmup"])
    films = []
    for dt in (torch.float32, dtype or torch.bfloat16):
        ren = rsppm.Renderer(sc, device, dt)
        with torch.no_grad():
            films.append(rsppm.film_at(ren, seed, ids, s0, iterations))
    (rc, rw, rst, _), (cc, cw, cst, _) = films
    numbers = check.compare(cc, cw, rc, rw)
    numbers.update(cell.entry().photon_numbers(cst, rst))
    ok, _ = check.judge(numbers, tr["check"]["limits"])
    return ok, numbers


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="bunny_shipped.sppm")
    ap.add_argument("--iterations", type=int, required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        print("control: CUDA is not available", file=sys.stderr)
        return 1
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        ok, numbers = readings(args.workload, seed, args.iterations,
                               args.device)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "iterations": args.iterations,
                          "control_correct": ok, "numbers": numbers,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
