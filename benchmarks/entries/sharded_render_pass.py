"""Progressive path tracing sharded over the cell's cards: the program's
parallel.mesh.make_sharded_render_pass over an NCCL group of one process
a card, one pass after another; each rank renders its share of every
chunk and one all-gather a pass gives every rank the whole pass.

Traffic keys: those of render_pass, and unsharded_passes (the passes rank
0 renders alone in a traced run, for the scaling efficiency).
"""

from __future__ import annotations

from benchlib import sharded


def run(cell, args, device, t_start, film=None):
    procs = sharded.start_ranks(cell, args, device, film)
    try:
        rec = sharded.run_rank(cell, args, device, t_start, film, 0)
    finally:
        for p in procs:
            p.join(timeout=120)
            if p.is_alive():
                p.kill()
                p.join()
    bad = [p.exitcode for p in procs if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"ranks ended with exit codes {bad}")
    return rec
