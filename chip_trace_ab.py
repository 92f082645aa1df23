#!/usr/bin/env python3
"""Time the tree's trace kernels against the one-thread-per-ray kernels they
replaced, on one NVIDIA GPU.

    mkdir -p _chip_checkout/parent && git archive 06baf2c \\
        goblin_tpu_torch/csrc | tar -x -C _chip_checkout/parent
    python3 chip_trace_ab.py _chip_checkout/parent/goblin_tpu_torch/csrc

The argument is a directory with the older trace_bvh8.cu and trace_bvh2.cu,
whose entries take (tables, rays, n_rays, any_hit, outputs, overflow,
stream). Each is built with the tree's flags and launched through the same
wrapper code as the tree's kernel (ops/trace.py::_launch), so both sides
allocate and check alike. Every kernel is first held bit for bit against its
plain PyTorch version on the bunny wavefronts of chip_smoke.py (primary,
bounce-1 continuation, bounce-1 shadow rays, a 32,768-photon first bounce),
then timed at the shapes the renders launch: per 196,608-ray frame, per
65,536-ray chunk and per 32,768-photon launch. The two sides of a kernel are
timed in turns (old, new, new, old) with chip_smoke.py's time_ms. One JSON
line per kernel, wavefront and shape goes to stdout.
"""

import ctypes
import json
import os
import shutil
import subprocess
import sys

import chip_smoke as cs

REPS = 40
CASES = (("primary", False), ("continuation", False), ("shadow", True),
         ("photon", False), ("photon", True))


def old_entry(name, source, out_dir):
    """Build an older source and wrap its entry in the tree's signature: the
    ray counter (after overflow) is dropped."""
    from goblin_tpu_torch.ops import trace as tt

    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    lib_path = os.path.join(out_dir, f"old_{name}.so")
    proc = subprocess.run([nvcc, *tt.NVCC_FLAGS, "-o", lib_path, source],
                          capture_output=True, text=True, timeout=600)
    cs.check(proc.returncode == 0, f"{source}: nvcc failed\n{proc.stderr}")
    fn = getattr(ctypes.CDLL(lib_path), f"goblin_{name}")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes, fn.restype = [ptr] * 7 + [i32] * 2 + [ptr] * 7, i32
    return lambda *a: fn(*a[:15], a[16])


def run(old_dir):
    import torch

    cs.check(torch.cuda.is_available(), "CUDA is not available")
    from goblin_tpu_torch.ops import trace as tt
    from goblin_tpu_torch.scene.loader import load_scene

    print(cs.nvidia_smi("name,power.limit"), flush=True)
    tt.build_kernels()
    out_dir = os.path.join(cs.REPO, "goblin_tpu_torch", "_build")
    scene8, meta8 = load_scene(cs.BUNNY, cs.SETTINGS, device="cuda")
    scene1, _ = load_scene(cs.BUNNY, cs.SETTINGS, device="cuda", trace_wide=1)
    fronts = cs.wavefronts(scene8, meta8)
    fronts["photon"] = cs.photon_wavefront(scene8, meta8.settings["seed"])
    sides = {}
    for name, scene, names, new, plain in (
            ("trace_bvh8", scene8, tt._BVH8_TABLES, tt.trace, tt.trace_plain),
            ("trace_bvh2", scene1, tt._BIN_TABLES, tt.trace_bin,
             tt.trace_bin_plain)):
        entry = old_entry(name, os.path.join(old_dir, f"{name}.cu"), out_dir)
        tables = [scene[k] for k in names]

        def old(scene, *rays, any_hit, entry=entry, tables=tables, name=name):
            return tt._launch(entry, name, tables, *rays, any_hit)

        sides[name] = (scene, old, new, plain)

    for front, any_hit in CASES:
        rays = [r.contiguous() for r in fronts[front]]
        n = rays[0].shape[0]
        shapes = {"full": lambda fn, sc: fn(sc, *rays, any_hit=any_hit)}
        if n > cs.CHUNK:
            shapes["chunk"] = lambda fn, sc: cs.chunked(fn, sc, rays, any_hit)
        for name, (scene, old, new, plain) in sides.items():
            ref = plain(scene, *rays, any_hit=any_hit)
            for shape, call in shapes.items():
                for side, fn in (("old", old), ("new", new)):
                    got = call(fn, scene)
                    torch.cuda.synchronize()
                    fields = got[:1] if any_hit else got
                    cs.check(all(torch.equal(a, b)
                                 for a, b in zip(fields, ref)),
                             f"{side} {name} {front} {shape}: differs from "
                             "the plain version")
                n_parts = 1 if shape == "full" else -(-n // cs.CHUNK)
                turns = {"old": [], "new": []}
                for side in ("old", "new", "new", "old"):
                    fn = old if side == "old" else new
                    turns[side].append(
                        cs.time_ms(lambda: call(fn, scene), REPS) / n_parts)
                print(json.dumps({
                    "kernel": name, "front": front,
                    "mode": "any-hit" if any_hit else "closest",
                    "shape": shape, "rays": n // n_parts, "bit_equal": True,
                    "old_ms_turns": turns["old"], "new_ms_turns": turns["new"],
                    "old_ms": sum(turns["old"]) / 2,
                    "new_ms": sum(turns["new"]) / 2}), flush=True)


if __name__ == "__main__":
    try:
        cs.check(len(sys.argv) == 2, "usage: chip_trace_ab.py OLD_CSRC_DIR")
        run(os.path.abspath(sys.argv[1]))
    except cs.SmokeFailure as e:
        print(f"chip_trace_ab: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
