"""Progressive SPPM on one card: the program's integrators.sppm.make_sppm
over the scene, one iteration after another.

An iteration is a pass of the render cells: one camera path a pixel, then
the photons, the grid, the drain and the update; it ends in
torch.cuda.synchronize(). Warm-up iterations take indices 0 .. warmup - 1
on a state of their own; the window's iterations continue from there on a
fresh state, the state whose film the check reads; in a traced run the
traced iterations follow on fresh states.

The device-timed iterations are the same in every run: the first
device_passes iterations of the render with seed DEVICE_SEED (the scene
file's, as the command line renders it), on a fresh state. An
iteration's device time follows where its photons land (the fullest grid
cell sets the drain's turns): it varies by 2% from one iteration to the
next, so iterations drawn from each run's seed would need about a hundred
to hold six runs' spread under half the bound.

Traffic keys: spp (the iterations the scene asks for, which set the
camera's strata), trace_width (the trace kernel's tree), warmup,
device_passes (the device-timed iterations), profiled (iterations
profiled in a traced run), check (the checked pixels and the
limits). The check's reference is plainref_sppm over the window's
iterations: the film at the checked pixels (checked_pixels), and the
photon side of the state at the pixels their filter reads
(photon_numbers).
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from benchlib import check, render

# the seed of the device-timed iterations: the scene file sets none, so
# the command line renders with 0
DEVICE_SEED = 0


def photon_numbers(state, ref_state):
    """The photon side of the check, at the pixels the filter reads: of
    the pixels where either side gathered a photon, the share whose
    gathered count N, or whose photon radiance tau / (emitted pi r^2), is
    off by more than check.BAD_REL. state and ref_state: Ni, Tau, radius
    (K, ...) and emitted each."""
    def photon(st):
        r = st["radius"].double().cpu()
        return st["Tau"].double().cpu() / torch.clamp(
            st["emitted"] * math.pi * (r * r)[:, None], min=1e-20)

    def rel(a, b):
        fin = torch.isfinite(a).all(-1)
        return torch.where(fin, (a - b).abs().amax(-1) / torch.clamp(
            b.abs().amax(-1), min=1e-30), float("inf"))

    ni, ni_ref = state["Ni"].double().cpu(), ref_state["Ni"].double().cpu()
    err = torch.maximum(rel(ni[:, None], ni_ref[:, None]),
                        rel(photon(state), photon(ref_state)))
    gathered = (ni > 0) | (ni_ref > 0) | ~torch.isfinite(err)
    if not bool(gathered.any()):
        return {"photon_bad_share": 0.0}
    return {"photon_bad_share": float((err[gathered] > check.BAD_REL)
                                      .double().mean())}


def reference_check(cell, seed, film, ids, color, weight, state, s0, n_it,
                    device):
    """The SPPM reference over iterations s0 .. s0 + n_it - 1 of a fresh
    state, compared with the program's film at the checked pixels and its
    state at the pixels the filter reads -> (correct, rows, numbers,
    reference seconds, triangles)."""
    from plainref_sppm import sppm as rsppm

    t0 = time.perf_counter()
    sc = rsppm.load(cell.scene_path(), render.settings(cell, seed), film=film)
    ren = rsppm.Renderer(sc, device)
    with torch.no_grad():
        rc, rw, ref_state, _ = rsppm.film_at(ren, seed, ids, s0, n_it)
    render.sync(device)
    numbers = check.compare(color, weight, rc, rw)
    numbers.update(photon_numbers(state, ref_state))
    ok, rows = check.judge(numbers, cell.traffic["check"]["limits"])
    return ok, rows, numbers, time.perf_counter() - t0, sc.n_tris


def checked_pixels(seed, spec, chk, ni):
    """The checked pixels: check.pixels' blocks placed by the seed, and one
    block more centred on the pixel that gathered the most photons (the
    largest N of the window's state), where the grid's cells are fullest
    and the drain takes the most turns."""
    ids = check.pixels(seed, spec.x_res, spec.y_res, int(chk["blocks"]),
                       int(chk["block"]))
    b = int(chk["block"])
    hot = int(ni.argmax())
    x0 = min(max(hot % spec.x_res - b // 2, 0), spec.x_res - b)
    y0 = min(max(hot // spec.x_res - b // 2, 0), spec.y_res - b)
    block = [(y0 + y) * spec.x_res + x0 + x for y in range(b)
             for x in range(b)]
    return np.unique(np.concatenate([ids, np.asarray(block, np.int64)]))


def program_state(sp_state, spec, ids):
    """The program's state at the pixels the filter reads around the
    checked pixels, on the host."""
    from plainref_sppm import sppm as rsppm

    sources, _ = rsppm.reach(spec.x_res, spec.y_res,
                             (spec.filter.x_width, spec.filter.y_width), ids)
    at = torch.as_tensor(sources, device=sp_state["Ni"].device)
    out = {k: sp_state[k][at].cpu() for k in ("Ld_acc", "Ni", "Tau",
                                               "radius")}
    out["emitted"] = sp_state["emitted"]
    return out


def run(cell, args, device, t_start, film=None):
    from goblin_tpu_torch.integrators import sppm

    tr, seed = cell.traffic, args.seed
    rec = {"kind": "render"}
    with torch.inference_mode():
        scene, meta, rec["load_s"] = render.load(cell, seed, device, film)
        spec = meta.camera.film
        sp = sppm.make_sppm(scene, meta)

        def make_pass(spans):
            return sp.iterate

        warm = sp.new_state()
        for s in range(int(tr["warmup"])):
            sp.iterate(warm, s)
        render.sync(device)
        del warm
        rec["setup_s"] = time.perf_counter() - t_start

        st = sp.new_state()
        s0 = int(tr["warmup"])
        rec["pass_s"], rec["window_s"] = render.window(
            lambda s: sp.iterate(st, s), s0, args.seconds, device)
        n_it = len(rec["pass_s"])
        rec["samples_per_pass"] = spec.x_res * spec.y_res
        rec["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                                    if torch.device(device).type == "cuda"
                                    else 0)
        ids = checked_pixels(seed, spec, tr["check"], st["Ni"])
        idt = torch.as_tensor(ids, device=device)
        color, weight = sp.film(st, n_it)
        color = color.reshape(-1, 3)[idt].cpu()
        weight = weight.reshape(-1)[idt].cpu()
        state = program_state(st, spec, ids)
        del st
        dev_sp = sppm.make_sppm(scene, meta, seed=DEVICE_SEED)
        g = dev_sp.new_state()
        rec["device_passes"] = int(tr["device_passes"])
        t = time.perf_counter()
        rec["device_busy_s"] = render.device_busy_s(
            lambda s: dev_sp.iterate(g, s), 0, rec["device_passes"], device)
        del g, dev_sp
        phases = {"device_timed_s": time.perf_counter() - t}
        if args.trace:
            t = time.perf_counter()
            rec.update(render.traced_passes(make_pass, s0 + n_it,
                                            int(tr["profiled"]), device,
                                            sp.new_state))
            phases["traced_s"] = time.perf_counter() - t
        del scene, meta, sp
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    ok, rows, numbers, ref_s, n_tris = reference_check(
        cell, seed, film, ids, color, weight, state, s0, n_it, device)
    rec.update(correct=ok, check=rows, attempted=n_it, failed=0,
               reference_s=ref_s, n_triangles=n_tris,
               log={"iterations": n_it, "first_iteration": s0,
                    "window_s": rec["window_s"],
                    "device_busy_s": rec["device_busy_s"],
                    "memory_peak_bytes": rec["memory_peak_bytes"],
                    "checked_pixels": len(ids), "reference_s": ref_s,
                    **phases, "numbers": numbers})
    return rec
