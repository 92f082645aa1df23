"""The ranks of a sharded render cell: one process a card, joined into
one process group by the program's parallel.multihost.init_from_env.

Rank 0 is the run's own process: it starts ranks 1 .. world - 1 (spawned
Python processes that run `rank_entry`), takes part like any rank,
checks the film and prints the result, then waits for every rank to end.
Every rank renders its share of each chunk and all of them the same
passes; rank 0 decides when the window ends and broadcasts it at each
pass's end, so all ranks stop at the same pass.
"""

from __future__ import annotations

import multiprocessing
import os
import time

import torch

from . import check, render


def start_ranks(cell, args, device, film):
    """Set the group's variables and start ranks 1 .. world - 1 -> the
    processes."""
    from goblin_tpu_torch.parallel.multihost import free_port

    os.environ.update(GOBLIN_COORDINATOR=f"localhost:{free_port()}",
                      GOBLIN_NUM_PROCS=str(cell.chips), GOBLIN_PROC_ID="0")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=rank_entry,
                         args=(cell.name, vars(args), device, film, r))
             for r in range(1, cell.chips)]
    for p in procs:
        p.start()
    return procs


def rank_entry(cell_name, args, device, film, rank):
    """A started rank's process."""
    import argparse

    from .spec import Cell

    os.environ["GOBLIN_PROC_ID"] = str(rank)
    run_rank(Cell(cell_name), argparse.Namespace(**args), device,
             time.perf_counter(), film, rank)


def _allgather_spans():
    """Put an `all_gather` range around the program's gather, for the
    traced passes."""
    from goblin_tpu_torch.parallel import mesh as pm

    orig = pm.Mesh.all_gather

    def spanned(self, t):
        with render.span("all_gather"):
            return orig(self, t)

    pm.Mesh.all_gather = spanned
    return lambda: setattr(pm.Mesh, "all_gather", orig)


def run_rank(cell, args, device, t_start, film, rank):
    """Every rank's part of a run -> the record on rank 0, None on the
    others."""
    import torch.distributed as dist

    from goblin_tpu_torch.camera import film as film_mod
    from goblin_tpu_torch.integrators import common, path
    from goblin_tpu_torch.parallel import mesh as pm
    from goblin_tpu_torch.parallel import multihost

    tr, seed = cell.traffic, args.seed
    multihost.init_from_env(device)
    mesh = pm.make_mesh(device="cuda" if device == "cuda" else "cpu")
    dev, world = mesh.device, mesh.world
    rec = {"kind": "render", "world": world}
    with torch.inference_mode():
        scene, meta, rec["load_s"] = render.load(cell, seed, dev, film)
        spec = meta.camera.film
        li = path.make_li(meta)

        def make_pass(spans):
            rp, _ = pm.make_sharded_render_pass(
                scene, meta, render.spanned(li) if spans else li, mesh,
                int(tr["spp"]), int(seed), int(tr["chunk"]))
            return lambda f, s: rp(f[0], f[1], s)

        def new_film():
            return film_mod.new_film(spec, dev)

        step = make_pass(False)
        warm = new_film()
        for s in range(int(tr["warmup"])):
            step(warm, s)
        render.sync(dev)
        del warm
        rec["setup_s"] = time.perf_counter() - t_start

        flag = torch.zeros(1, dtype=torch.int32, device=dev)

        def stop(done):
            flag.fill_(int(done))
            dist.broadcast(flag, 0)
            return bool(flag.item())

        f = new_film()
        s0 = int(tr["warmup"])
        rec["pass_s"], rec["window_s"] = render.window(
            lambda s: step(f, s), s0, args.seconds, dev, stop)
        n_pass = len(rec["pass_s"])
        rec["samples_per_pass"] = spec.x_res * spec.y_res
        peak = torch.tensor([torch.cuda.max_memory_allocated(dev)
                             if dev.type == "cuda" else 0],
                            dtype=torch.float64, device=dev)
        dist.all_reduce(peak, op=dist.ReduceOp.MAX)
        rec["memory_peak_bytes"] = int(peak.item())
        ids = check.pixels(seed, spec.x_res, spec.y_res,
                           int(tr["check"]["blocks"]),
                           int(tr["check"]["block"]))
        idt = torch.as_tensor(ids, device=dev)
        color = f[0].reshape(-1, 3)[idt].cpu()
        weight = f[1].reshape(-1)[idt].cpu()
        g = new_film()
        rec["device_passes"] = int(tr["device_passes"])
        busy = render.device_busy_s(lambda s: step(g, s), s0 + n_pass,
                                    rec["device_passes"], dev)
        if busy is not None:  # the cards' busy seconds, summed
            both = torch.tensor([busy], dtype=torch.float64, device=dev)
            dist.all_reduce(both)
            busy = float(both.item())
        rec["device_busy_s"] = busy
        del g
        if args.trace:
            undo = _allgather_spans()
            try:
                rec.update(render.traced_passes(
                    make_pass, s0 + n_pass, int(tr["profiled"]), dev,
                    new_film))
            finally:
                undo()
            t = rec["trace"]
            both = torch.tensor([t.busy_s(), t.window_s],
                                dtype=torch.float64, device=dev)
            dist.all_reduce(both)
            rec["busy_s"], rec["window_s_traced"] = (
                float(v) / world for v in both.tolist())
            # rank 0's own rate, unsharded, while the others wait
            dist.barrier()
            if rank == 0:
                rp, _ = common.make_render_pass(scene, meta, li,
                                                int(tr["spp"]), int(seed),
                                                int(tr["chunk"]))
                g = new_film()
                n1 = int(tr["unsharded_passes"])
                a = time.perf_counter()
                for s in range(n1):
                    rp(g[0], g[1], s)
                render.sync(dev)
                rec["unsharded_msamples_per_s"] = (
                    n1 * rec["samples_per_pass"]
                    / (time.perf_counter() - a) / 1e6)
            dist.barrier()
        del scene, meta, li, step, f
    dist.destroy_process_group()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if rank != 0:
        return None
    ok, rows, numbers, ref_s, n_tris = render.reference_check(
        cell, seed, film, ids, color, weight, s0, n_pass,
        dev)
    rec.update(correct=ok, check=rows, attempted=n_pass, failed=0,
               n_triangles=n_tris,
               log={"passes": n_pass, "first_sample": s0, "world": world,
                    "window_s": rec["window_s"],
                    "device_busy_s": rec["device_busy_s"],
                    "checked_pixels": len(ids), "reference_s": ref_s})
    return rec
