"""Scene file -> image, and the command line (port of goblin_tpu/render.py
for the path_tracing and sppm methods).

    python -m goblin_tpu_torch scene.json [render_method] [--device cuda|cpu]

The method defaults to the scene's own render_setting (bunny.json: sppm).
The device defaults to cuda; asking for cuda without a card raises, and
the CPU (the kernels' plain versions) runs only when asked for.
"""

from __future__ import annotations

import argparse
import sys
import time

from .camera import film as film_mod
from .integrators import common
from .scene.loader import load_scene

PATH_METHODS = ("path_tracing", "path")
SPLAT_METHODS = ("light_tracing", "bdpt", "sppm")


def make_li(meta):
    """The integrator's batched Li for meta.settings["render_method"]."""
    method = meta.settings.get("render_method", "path_tracing")
    if method in PATH_METHODS:
        from .integrators.path import make_li as mk

        return mk(meta)
    raise NotImplementedError(
        f"render_method {method!r} is not in goblin_tpu_torch yet "
        "(ROADMAP Queue 1 items 9-10)"
    )


def render_context(path: str, overrides=None, device="cuda",
                   chunk_size=1 << 16, report=None, trace_wide=8):
    """Load and render a scene -> (image (H, W, 3) tensor, meta).

    chunk_size: pixels per path-tracing chunk; report(done, total) after
    each pass or iteration; trace_wide: the trace kernel's tree, 8 (BVH8),
    4 (BVH4) or 1 (binary). The splatting methods go to splatting.render_dispatch.
    """
    scene, meta = load_scene(path, overrides, device=device,
                             trace_wide=trace_wide)
    method = meta.settings.get("render_method", "path_tracing")
    if method in SPLAT_METHODS:
        from . import splatting

        return splatting.render_dispatch(scene, meta, method,
                                         report=report), meta
    img = common.render(scene, meta, make_li(meta), chunk_size=chunk_size,
                        report=report)
    return img, meta


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m goblin_tpu_torch")
    ap.add_argument("scene")
    ap.add_argument("render_method", nargs="?")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    overrides = {}
    if args.render_method:
        overrides["render_method"] = args.render_method

    def report(done, total):
        print(f"\rrender progress: {100.0 * done / total:.1f}%", end="",
              file=sys.stderr, flush=True)

    t0 = time.time()
    img, meta = render_context(args.scene, overrides, device=args.device,
                               report=report)
    print(file=sys.stderr)
    out = film_mod.write_image(meta.camera.film, img)
    print(f"render time: {time.time() - t0:.2f}s -> {out}")
    return 0
