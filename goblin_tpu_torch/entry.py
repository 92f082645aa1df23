"""Entry points of the renderer (port of __graft_entry__.py).

    entry(device="cuda")          -> (fn, example_args): the forward
                                     radiance step of the path tracer on
                                     examples/bunny.json
    dryrun_multichip(n, "cuda")   -> (loss, grad_l1): the sharded render and
                                     the sharded train step on n ranks, one
                                     device a rank

    python -m goblin_tpu_torch.entry --dryrun N [--device cuda|cpu]

prints the dryrun's line, then each rank's record as a JSON line.

goblin_tpu's dryrun re-runs itself on fake CPU devices when it sees too
few chips. This one does not: with device="cuda" and fewer than n cards it
raises (NCCL puts one rank on a card), and the CPU, over gloo, runs only
when the caller asks for it.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import sys
import tempfile

import torch

from .integrators import common
from .integrators.path import make_li
from .ops import trace as tt
from .parallel import mesh as pmesh
from .parallel import multihost
from .scene.loader import load_scene

# the repository's root: the children import this tree's package from it
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUNNY = os.path.join(ROOT, "examples", "bunny.json")
SEED = 0
EXAMPLE_PIXELS = 1024
# the stratification grid of entry()'s samples (goblin_tpu's entry: 2)
ENTRY_GRID = 2
RANK_FLAG = "--dryrun-rank"
DRYRUN_TIMEOUT = 600
# modules a rank must not have imported
FOREIGN = ("jax", "goblin_tpu", "__graft_entry__")

# __graft_entry__.py's tiny scene: a floor, a glass sphere, a point light
# and an area light, 32 x 24, depth 3, a box filter
DRYRUN_SCENE = {
    "render_setting": {"render_method": "path_tracing",
                       "sample_per_pixel": 1, "max_ray_depth": 3},
    "camera": {
        "position": [0, 1.5, -3.0],
        "euler": [15, 0, 0],
        "rotation_order": "xyz",
        "fov": 45.0,
        "film": {"resolution": [32, 24]},
        "filter": {"type": "box", "width": [0.5, 0.5]},
    },
    "geometries": [
        {"name": "floor", "type": "mesh", "file": "plane.obj"},
        {"name": "ball", "type": "sphere", "radius": 0.5},
    ],
    "textures": [
        {"format": "color", "name": "white", "type": "constant",
         "color": [0.8, 0.8, 0.8]},
    ],
    "materials": [
        {"name": "diffuse", "type": "lambert", "Kd": "white"},
        {"name": "glass", "type": "transparent", "Kr": "white",
         "Kt": "white", "index": 1.5},
    ],
    "primitives": [
        {"type": "model", "name": "fm", "geometry": "floor",
         "material": "diffuse"},
        {"type": "model", "name": "bm", "geometry": "ball",
         "material": "glass"},
        {"type": "instance", "name": "fi", "model": "fm",
         "scale": [20, 20, 20]},
        {"type": "instance", "name": "bi", "model": "bm",
         "position": [0, 0.5, 0]},
    ],
    "lights": [
        {"name": "key", "type": "point", "intensity": [8, 8, 8],
         "position": [2, 4, -2]},
        {"name": "panel", "type": "area", "radiance": [5, 5, 5],
         "geometry": "floor", "position": [0, 3.0, 0],
         "euler": [180, 0, 0], "scale": [0.4, 0.4, 0.4]},
    ],
}
PLANE_OBJ = ("v -1 0 1\nv 1 0 1\nv -1 0 -1\nv 1 0 -1\n"
             "vn 0 1 0\nf 1//1 2//1 3//1\nf 3//1 2//1 4//1\n")


def entry(device="cuda"):
    """-> (fn, example_args). fn(pixel_ids, s_idx) is the (N, 3) radiance
    of sample s_idx of pixel_ids (int32, on the device) with seed 0:
    bunny.json path-traced at its own settings (512 x 384, max_ray_depth
    20, 100 samples a pixel to stratify over; trace width 8), the camera
    samples on a 2 x 2 grid, as goblin_tpu's entry() takes them. Its trace
    kernel runs 1 + 2 x 18 + 1 = 38 times a call (the last bounce traces
    no continuation: the spot light is a delta light). example_args are
    1,024 pixel ids and sample 0."""
    scene, meta = load_scene(BUNNY, {"render_method": "path_tracing"},
                             device=device)
    li = make_li(meta)
    cam = meta.camera

    def fn(pixel_ids, s_idx):
        ray = common.camera_rays(cam, SEED, pixel_ids, s_idx, ENTRY_GRID)
        return li(scene, meta, ray, pixel_ids, s_idx, SEED)

    dev = scene["tri_rows"].device
    return fn, (torch.arange(EXAMPLE_PIXELS, dtype=torch.int32, device=dev),
                0)


def write_dryrun_scene(out_dir) -> str:
    """DRYRUN_SCENE and its plane.obj written into out_dir -> the scene
    file's path."""
    with open(os.path.join(out_dir, "plane.obj"), "w") as f:
        f.write(PLANE_OBJ)
    path = os.path.join(out_dir, "scene.json")
    with open(path, "w") as f:
        json.dump(DRYRUN_SCENE, f)
    return path


def dryrun_batch(n_devices, device):
    """The train step's pixel ids: n_devices x 32 of them, strided over the
    32 x 24 film (wrapping when there are more). goblin_tpu's dryrun takes
    the first n_devices x 32, which for fewer than 7 devices lie in the
    film's top rows: they see only the black background, and its loss and
    gradients are 0."""
    n_pix = 32 * 24
    n = n_devices * 32
    return (torch.arange(n, dtype=torch.int32, device=device)
            * max(1, n_pix // n)) % n_pix


def _require(cond, msg):
    if not cond:
        raise RuntimeError(f"dryrun rank: {msg}")


def dryrun_rank(scene_path, out_dir, device):
    """One rank of dryrun_multichip: join the group the GOBLIN_* variables
    describe, render the tiny scene by render_sharded, take one sharded
    train step of (light colours, tex_atlas), and write this rank's loss
    and gradient L1 into out_dir."""
    import torch.distributed as dist

    _require(multihost.init_from_env(device), "no process group described")
    try:
        n = dist.get_world_size()
        if torch.device(device).type == "cpu":  # the ranks share the cores
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
        mesh = pmesh.make_mesh(n, device)
        scene, meta = load_scene(scene_path, device=mesh.device)
        li = make_li(meta)
        img = pmesh.render_sharded(scene, meta, li, mesh, spp=1,
                                   chunk_size=max(n * 32, 256))
        _require(bool(img.isfinite().all()), "sharded render is not finite")
        step, scene_sh = pmesh.make_sharded_train_step(scene, meta, li, mesh)
        params = (scene_sh["lights"]["color"], scene_sh["tex_atlas"])
        loss, grads = step(params, dryrun_batch(n, mesh.device), 0)
        loss = float(loss)
        _require(math.isfinite(loss), "sharded train step's loss is not "
                                      "finite")
        grad_l1 = sum(float(g.abs().sum()) for g in grads)
        _require(grad_l1 > 0.0, "the gradients are all zero")
        foreign = sorted(m for m in sys.modules
                         if m.split(".")[0] in FOREIGN)
        _require(not foreign, f"a rank imported {foreign}")
        with open(os.path.join(out_dir, f"rank{mesh.rank}.json"), "w") as f:
            json.dump({"loss": loss, "grad_l1": grad_l1,
                       "image_mean": float(img.mean()),
                       "backend": dist.get_backend(),
                       "device": str(mesh.device),
                       "trace_launches": dict(tt.launches)}, f)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, device="cuda", ranks=None):
    """Start n_devices ranks of this module (multihost.launch_local on a
    free port; NCCL with one card a rank, gloo for device="cpu"), each of
    which renders the tiny scene by render_sharded and takes one sharded
    train step (dryrun_rank). Prints "dryrun_multichip(n): loss=...
    grad_l1=... ok" -> (loss, grad_l1) of rank 0. Raises RuntimeError with
    the tail of its log if a rank fails, and before starting any when
    device is cuda and fewer than n_devices cards are visible;
    subprocess.TimeoutExpired if the ranks outlive DRYRUN_TIMEOUT seconds.
    ranks, a list, receives each rank's record (loss, grad_l1, image_mean,
    backend, device and its trace_launches by kernel) in rank order."""
    n_devices = int(n_devices)
    if torch.device(device).type == "cuda":
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if cards < n_devices:
            raise RuntimeError(
                f"dryrun_multichip({n_devices}): {cards} CUDA cards visible; "
                "NCCL puts one rank on a card (pass device=\"cpu\" to run "
                "the ranks on the CPU)")
    tmp = tempfile.mkdtemp(prefix="goblin_dryrun_")
    try:
        scene_path = write_dryrun_scene(tmp)
        env = {"PYTHONPATH": os.pathsep.join(
            [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p])}
        results = multihost.launch_local(
            n_devices, ["-m", "goblin_tpu_torch.entry", RANK_FLAG,
                        scene_path, tmp, "--device", str(device)],
            port=multihost.free_port(), env_extra=env,
            timeout=DRYRUN_TIMEOUT, cwd=ROOT)
        for rank, (rc, log) in enumerate(results):
            if rc != 0:
                raise RuntimeError(f"dryrun_multichip({n_devices}): rank "
                                   f"{rank} exited with {rc}:\n{log[-4000:]}")
        records = []
        for rank in range(n_devices):
            with open(os.path.join(tmp, f"rank{rank}.json")) as f:
                records.append(json.load(f))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if ranks is not None:
        ranks.extend(records)
    loss, grad_l1 = records[0]["loss"], records[0]["grad_l1"]
    if any(r["loss"] != loss for r in records):
        raise RuntimeError(f"dryrun_multichip({n_devices}): the ranks' "
                           f"losses differ: {[r['loss'] for r in records]}")
    print(f"dryrun_multichip({n_devices}): loss={loss:.5f} "
          f"grad_l1={grad_l1:.5f} ok", flush=True)
    return loss, grad_l1


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m goblin_tpu_torch.entry")
    ap.add_argument("--dryrun", type=int, metavar="N",
                    help="run dryrun_multichip(N)")
    ap.add_argument(RANK_FLAG, nargs=2, metavar=("SCENE", "OUT_DIR"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.dryrun_rank:
        dryrun_rank(*args.dryrun_rank, args.device)
    elif args.dryrun:
        ranks = []
        dryrun_multichip(args.dryrun, args.device, ranks=ranks)
        for rank in ranks:
            print(json.dumps(rank))
    else:
        ap.error("nothing to run: pass --dryrun N")
    return 0


if __name__ == "__main__":
    sys.exit(main())
