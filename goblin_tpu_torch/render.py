"""Scene file -> image, and the command line (port of goblin_tpu/render.py
for its six methods: path_tracing, ao, whitted, light_tracing, bdpt and
sppm).

    python -m goblin_tpu_torch scene.json [render_method] [--device cuda|cpu]
                               [--regen]

The method defaults to the scene's own render_setting (bunny.json: sppm).
--regen path-traces with the regenerative wavefront driver
(integrators/wavefront.py) where it covers the scene (not with a BSSRDF),
goblin_tpu's GOBLIN_REGEN=1.
The device defaults to cuda; asking for cuda without a card raises, and
the CPU (the kernels' plain versions) runs only when asked for. The image
goes where the film's file says, as the film asks: bloomed, then tone
mapped, as EXR or as an 8-bit PPM (camera/film.py::write_image).
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
    """The integrator's batched Li for meta.settings["render_method"]; the
    splatting methods (light_tracing, bdpt, sppm) have none."""
    method = meta.settings.get("render_method", "path_tracing")
    if method == "ao":
        from .integrators.ao import make_li as mk

        return mk(int(meta.settings.get("ao_sample_num", 25)))
    if method == "whitted":
        from .integrators.whitted import make_li as mk

        return mk(meta)
    if method in PATH_METHODS:
        from .integrators.path import make_li as mk

        return mk(meta)
    raise ValueError(f"render_method {method!r} has no batched Li")


def render_context(path: str, overrides=None, device="cuda",
                   chunk_size=1 << 16, report=None, trace_wide=8,
                   regen=False, pool=None):
    """Load and render a scene -> (image (H, W, 3) tensor, meta).

    chunk_size: pixels per chunk of the camera-sampled integrators (path
    tracing, ao, whitted); report(done, total) after each pass or
    iteration; trace_wide: the trace kernel's tree, 8 (BVH8), 4 (BVH4) or 1
    (binary). The splatting methods go to splatting.render_dispatch, with
    their own chunk sizes. regen: path tracing by the regenerative driver
    with a pool of `pool` lanes (default max(chunk_size, 16,384)) where
    wavefront.supports(meta), else the chunked driver.
    """
    scene, meta = load_scene(path, overrides, device=device,
                             trace_wide=trace_wide)
    method = meta.settings.get("render_method", "path_tracing")
    if method in SPLAT_METHODS:
        from . import splatting

        return splatting.render_dispatch(scene, meta, method,
                                         report=report), meta
    if regen and method in PATH_METHODS:
        from .integrators import wavefront

        if wavefront.supports(meta):
            pool = max(chunk_size, 1 << 14) if pool is None else pool
            return wavefront.render_wavefront(scene, meta, pool=pool,
                                              report=report), meta
    img = common.render(scene, meta, make_li(meta), chunk_size=chunk_size,
                        report=report)
    return img, meta


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m goblin_tpu_torch")
    ap.add_argument("scene")
    ap.add_argument("render_method", nargs="?")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--regen", action="store_true",
                    help="path tracing by the regenerative wavefront driver")
    args = ap.parse_args(argv)
    overrides = {}
    if args.render_method:
        overrides["render_method"] = args.render_method

    def report(done, total):
        print(f"\rrender progress: {100.0 * done / total:.1f}%", end="",
              file=sys.stderr, flush=True)

    t0 = time.time()
    img, meta = render_context(args.scene, overrides, device=args.device,
                               report=report, regen=args.regen)
    print(file=sys.stderr)
    out = film_mod.write_image(meta.camera.film, img)
    print(f"render time: {time.time() - t0:.2f}s -> {out}")
    return 0
