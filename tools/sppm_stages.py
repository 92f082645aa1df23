#!/usr/bin/env python3
"""Device operations and device time of one SPPM iteration by stage, on
the card.

    python3 tools/sppm_stages.py [--iterations N] [--state OUT.npz]

Run from the root of a checkout: it imports that checkout's
goblin_tpu_torch. bunny.json as shipped (SPPM, 512 x 384, depth 20,
radius 0.01, the command line's seed 0) through integrators.sppm.make_sppm:
N iterations (default 3) on a fresh state, then iteration N once more on a
state of its own under torch.profiler, with each of the program's spans
opened as a profiler range too. Each device operation (kernel, copy, set)
goes to the stage of the innermost SPPM span open where its launch began
(the CUDA runtime call of the same correlation id): ray (sppm.ray,
render.camera), photon (sppm.photon), grid (sppm.grid), drain
(sppm.drain, less its grid lookup), update (sppm.update), pass (the rest
of render.pass).

Prints one JSON line: the card's name and power limit, per stage the
device operations and their summed device milliseconds, the totals, the
photon walks, drain turns, kernel drains and pairs of the profiled
iteration, the unprofiled iterations' wall seconds and the memory peak of
the last of them. With
--state, the state after the N iterations goes to an .npz file, so two
checkouts' states can be compared bit for bit. Needs a CUDA device.
"""

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.getcwd())

import numpy as np  # noqa: E402
import torch  # noqa: E402

SCENE = os.path.join("examples", "bunny.json")
STAGE = {"render.pass": "pass", "render.camera": "ray", "sppm.ray": "ray",
         "sppm.photon": "photon", "sppm.grid": "grid", "sppm.drain": "drain",
         "sppm.update": "update"}


def ranged_spans(telemetry):
    """Each program span also a profiler range of its name."""
    span = telemetry.span

    @contextlib.contextmanager
    def both(name):
        with span(name), torch.profiler.record_function(name):
            yield

    telemetry.span = both


def by_stage(prof, names):
    """{stage: [device operations, device ms]} of a profile, each device
    operation at the innermost stage range open where its launch began
    (the CUDA runtime call with the operation's correlation id)."""
    from torch.autograd import DeviceType

    events = prof.events()
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    runtime = {e.id: e for e in cpu if e.name.startswith("cu")}
    ranges = sorted((e.time_range.start, e.time_range.end, STAGE[e.name])
                    for e in cpu if e.name in STAGE)
    out = {s: [0, 0.0] for s in (*dict.fromkeys(STAGE.values()), "none",
                                 "unlinked")}
    for e in events:
        if e.device_type != DeviceType.CUDA or e.name in names:
            continue
        launch = runtime.get(e.id)
        stage = "unlinked"
        if launch is not None:
            t, stage, width = launch.time_range.start, "none", float("inf")
            for a, b, s in ranges:
                if a > t:
                    break
                if t <= b and b - a < width:
                    stage, width = s, b - a
        out[stage][0] += 1
        out[stage][1] += (e.time_range.end - e.time_range.start) * 1e-3
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iterations", type=int, default=3)
    ap.add_argument("--state", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("sppm_stages: needs a CUDA device")
    from goblin_tpu_torch import telemetry
    from goblin_tpu_torch.integrators import sppm
    from goblin_tpu_torch.scene.loader import load_scene

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    ranged_spans(telemetry)
    with torch.inference_mode():
        scene, meta = load_scene(SCENE, device="cuda")
        sp = sppm.make_sppm(scene, meta)
        st = sp.new_state()
        wall = []
        for it in range(args.iterations):
            if it == args.iterations - 1:
                torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t = time.perf_counter()
            sp.iterate(st, it)
            torch.cuda.synchronize()
            wall.append(time.perf_counter() - t)
        peak = torch.cuda.max_memory_allocated()
        if args.state:
            np.savez(args.state, **{
                k: v.cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
                for k, v in st.items()})
        c0 = dict(telemetry.counters)
        g = sp.new_state()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            sp.iterate(g, args.iterations)
            torch.cuda.synchronize()
        counted = {k: telemetry.counters.get(k, 0) - c0.get(k, 0)
                   for k in ("sppm.photon_walks", "sppm.drain_reads",
                             "sppm.drain_turns", "sppm.drain_launches",
                             "sppm.drain_pairs", "sppm.photons")}
    stages = by_stage(prof, set(STAGE) | set(telemetry.STAGES))
    print(json.dumps({
        "card": smi.strip(), "torch": torch.__version__,
        "stages": {k: {"device_ops": n, "device_ms": round(ms, 4)}
                   for k, (n, ms) in stages.items()},
        "device_ops": sum(n for n, _ in stages.values()),
        "device_ms": round(sum(ms for _, ms in stages.values()), 4),
        "counters": counted, "wall_s": [round(w, 4) for w in wall],
        "memory_peak_bytes": peak}))


if __name__ == "__main__":
    main()
