"""Progressive path tracing on one card: the program's
integrators.common.make_render_pass over the scene, one pass after
another.

Traffic keys: spp (the stratification the passes walk), chunk (pixels a
call of the integrator), trace_width (the trace kernel's tree), warmup
(passes before the window), device_passes (passes after the window whose
device time every run takes), profiled (passes profiled in a traced run),
check (the checked pixels and the limits).
"""

from __future__ import annotations

import time

import torch

from benchlib import check, render


def run(cell, args, device, t_start, film=None):
    from goblin_tpu_torch.camera import film as film_mod
    from goblin_tpu_torch.integrators import common, path

    tr, seed = cell.traffic, args.seed
    rec = {"kind": "render"}
    with torch.inference_mode():
        scene, meta, rec["load_s"] = render.load(cell, seed, device, film)
        spec = meta.camera.film
        li = path.make_li(meta)

        def make_pass(spans):
            rp, _ = common.make_render_pass(
                scene, meta, render.spanned(li) if spans else li,
                int(tr["spp"]), int(seed), int(tr["chunk"]))
            return lambda f, s: rp(f[0], f[1], s)

        step = make_pass(False)

        def new_film():
            return film_mod.new_film(spec, device)

        warm = new_film()
        for s in range(int(tr["warmup"])):
            step(warm, s)
        render.sync(device)
        del warm
        rec["setup_s"] = time.perf_counter() - t_start

        f = new_film()
        s0 = int(tr["warmup"])
        rec["pass_s"], rec["window_s"] = render.window(
            lambda s: step(f, s), s0, args.seconds, device)
        n_pass = len(rec["pass_s"])
        rec["samples_per_pass"] = spec.x_res * spec.y_res
        rec["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                                    if torch.device(device).type == "cuda"
                                    else 0)
        ids = check.pixels(seed, spec.x_res, spec.y_res,
                           int(tr["check"]["blocks"]),
                           int(tr["check"]["block"]))
        idt = torch.as_tensor(ids, device=device)
        color = f[0].reshape(-1, 3)[idt].cpu()
        weight = f[1].reshape(-1)[idt].cpu()
        g = new_film()
        rec["device_passes"] = int(tr["device_passes"])
        rec["device_busy_s"] = render.device_busy_s(
            lambda s: step(g, s), s0 + n_pass, rec["device_passes"], device)
        del g
        if args.trace:
            rec.update(render.traced_passes(make_pass, s0 + n_pass,
                                            int(tr["profiled"]), device,
                                            new_film))
        del scene, meta, li, step, f
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    ok, rows, numbers, ref_s, n_tris = render.reference_check(
        cell, seed, film, ids, color, weight, s0, n_pass,
        device)
    rec.update(correct=ok, check=rows, attempted=n_pass, failed=0,
               reference_s=ref_s, n_triangles=n_tris,
               log={"passes": n_pass, "first_sample": s0,
                    "window_s": rec["window_s"],
                    "device_busy_s": rec["device_busy_s"],
                    "checked_pixels": len(ids), "reference_s": ref_s})
    return rec
