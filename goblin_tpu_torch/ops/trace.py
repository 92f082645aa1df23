"""BVH ray traversal: host-side layouts, the CUDA kernels' wrappers, and
their plain PyTorch versions.

Port of goblin_tpu/ops/pallas_trace.py's two traversals, with one contract
(``trace_packets`` / ``trace_packets4``'s): closest-hit returns (hit, t,
tri, b1, b2) with t = 3e38 on a miss and tri in BVH order; any-hit stops a
ray at its first accepted triangle, and then only ``hit`` is defined.

- Width 8 (the default) and width 4: ``collapse_wide`` is ``collapse4`` at
  that width without the TPU bias packing; ``trace`` launches
  csrc/trace_bvh8.cu, which is built once for each width (the width is a
  compile-time constant of the source), and with ``stats=True`` the
  instance that also counts per-ray node visits.
- Width 1: ``bin_tables`` is ``pack_scene``'s per-node layout of the
  binary tree; ``trace_bin`` launches csrc/trace_bvh2.cu.

On a CUDA tensor a wrapper launches its kernel (built with nvcc at first
use, bound with ctypes) and never falls back; on a CPU tensor it runs the
plain version, the same traversal in vectorised lockstep. Both kernels run
persistent blocks that draw rays from a counter (the wide kernel a ray at a
time for each group of 8 or 4 lanes, the binary kernel 32 rays a warp); the
binary kernel also stages the first ``staged_nodes`` nodes of its table in
shared memory, a prefix the wrapper sizes from the budget the kernel's
library reports.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import sys
from typing import NamedTuple

import numpy as np
import torch

WIDTH = 8
WIDTHS = (4, 8)  # of the collapsed trees
# Collapsed nodes on the longest root-to-leaf path that a walk can hold: the
# kernel keeps one stack entry per level (csrc/trace_bvh8.cu kLevels). Width
# 8 was sized from bunny's BVH8 depth 6. A 4-wide tree is deeper (bunny's
# and the studio scene's have depth 9, their binary tree 14): 16 levels
# hold any tree whose binary depth the width-1 kernel's stack also holds.
WIDE_LEVELS = 9
WIDE4_LEVELS = 16
# trace_plain's per-ray stack of child entries: stack_bound(WIDE_LEVELS) at
# width 8, and at least stack_bound(WIDE4_LEVELS, 4)
STACK = 64
# binary per-ray stack entries, in the kernel and trace_bin_plain: bunny's
# binary tree has depth 14 (15 entries), so 32 leaves a 2x margin
BIN_STACK = 32
EMPTY = -1  # child entry of an unused slot
# rays in one launch: the counter the blocks draw from runs past the last
# ray by up to 32 for every warp of the launch and must stay an int32
MAX_RAYS = (1 << 31) - (1 << 24)
BIG_T = 3.0e38
_TINY = 1e-30
_TRI_EPS = 1e-7

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# kernel name -> CUDA source; each builds into its own library
KERNEL_SOURCES = {
    "trace_bvh8": os.path.join(_PKG, "csrc", "trace_bvh8.cu"),
    "trace_bvh4": os.path.join(_PKG, "csrc", "trace_bvh8.cu"),
    "trace_bvh2": os.path.join(_PKG, "csrc", "trace_bvh2.cu"),
}
# what a kernel's build defines besides: the wide source's width
KERNEL_DEFINES = {"trace_bvh4": ("-DGOBLIN_TRACE_WIDTH=4",)}
# what both sources include; its bytes enter each library's build key
KERNEL_HEADERS = (os.path.join(_PKG, "csrc", "trace_common.cuh"),)
_BUILD_DIR = os.path.join(_PKG, "_build")
# --fmad=false: no contraction into FMA, so the kernel rounds as eager
# PyTorch (and trace_plain) does
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# CUDA kernel launches per kernel since the last reset (chip_smoke.py reads
# them to show that a render went through the kernels)
launches = {"trace_bvh8": 0, "trace_bvh8_stats": 0, "trace_bvh4": 0,
            "trace_bvh4_stats": 0, "trace_bvh2": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


class TraceResult(NamedTuple):
    hit: torch.Tensor  # (R,) bool
    t: torch.Tensor  # (R,) f32, BIG_T on a miss
    tri: torch.Tensor  # (R,) i32 in BVH order, -1 on a miss
    b1: torch.Tensor  # (R,) f32
    b2: torch.Tensor  # (R,) f32


# ---------------------------------------------------------------------------
# Host layout
# ---------------------------------------------------------------------------


def leaf_entry(first: int, count: int) -> int:
    """Child entry of a leaf: -(((first / 8) << 7) | count) - 1."""
    if first % 8 or not 0 < count < 128:
        raise ValueError(
            f"leaf (first={first}, count={count}) needs an 8-aligned first "
            "and 0 < count < 128 (build with align_leaves(8))"
        )
    return -(((first // 8) << 7) | count) - 1


def collapse_wide(bounds: np.ndarray, meta: np.ndarray, width: int = WIDTH):
    """Binary BVH (pre-order, skip links, 8-aligned leaves) -> a tree `width`
    (4 or 8) wide.

    Each wide node gathers up to `width` subtree roots under a binary inner
    node, opening the largest-area inner root first (collapse4's rule), and
    node ids are assigned in the same DFS pre-order as collapse4. Returns
    (node_bounds (N, 6, width) f32, node_child (N, width) i32, depth), where
    depth counts wide nodes on the longest root-to-leaf path.
    """
    if width not in WIDTHS:
        raise ValueError(f"collapse_wide: width {width!r} is not in {WIDTHS}")
    is_leaf = meta[:, 1] > 0
    rows_b: list[np.ndarray] = []
    rows_c: list[np.ndarray] = []

    def area(j):
        d = np.maximum(bounds[j, 3:6] - bounds[j, 0:3], 0.0)
        return d[0] * d[1] + d[1] * d[2] + d[2] * d[0]

    def kids(j):
        return [j + 1, int(meta[j + 1, 2])]

    def new_row():
        rows_b.append(np.zeros((6, width), np.float32))
        rows_c.append(np.full(width, EMPTY, np.int32))
        return len(rows_b) - 1

    def emit(j) -> tuple[int, int]:
        my = new_row()
        group = kids(j)
        while len(group) < width:
            inners = [g for g in group if not is_leaf[g]]
            if not inners:
                break
            big = max(inners, key=area)
            gi = group.index(big)
            group[gi:gi + 1] = kids(big)
        depth = 1
        for c, g in enumerate(group):
            rows_b[my][:, c] = bounds[g]
            if is_leaf[g]:
                rows_c[my][c] = leaf_entry(int(meta[g, 0]), int(meta[g, 1]))
            else:
                rows_c[my][c], sub = emit(g)
                depth = max(depth, 1 + sub)
        return my, depth

    sys.setrecursionlimit(max(10000, 64 + 2 * bounds.shape[0]))
    if is_leaf[0]:
        # single-leaf tree: a root with one leaf child
        new_row()
        rows_b[0][:, 0] = bounds[0]
        rows_c[0][0] = leaf_entry(int(meta[0, 0]), int(meta[0, 1]))
        depth = 1
    else:
        depth = emit(0)[1]
    return np.stack(rows_b), np.stack(rows_c), depth


def collapse8(bounds: np.ndarray, meta: np.ndarray):
    """collapse_wide at width 8."""
    return collapse_wide(bounds, meta, 8)


def stack_bound(depth: int, width: int = WIDTH) -> int:
    """Most child entries trace_plain's stack holds for a tree of this
    depth and width: a visit pops one entry and pushes at most `width`."""
    return (width - 1) * depth + 1


def wide_levels(width: int = WIDTH) -> int:
    """Stack levels the trace kernel of this width keeps for a ray."""
    return WIDE_LEVELS if width == 8 else WIDE4_LEVELS


def check_wide_depth(depth: int, width: int = WIDTH) -> None:
    """Refuse a collapsed tree deeper than the trace kernel's per-ray stack:
    one entry per level, wide_levels(width) of them."""
    if depth > wide_levels(width):
        raise ValueError(
            f"BVH{width} depth {depth} needs {depth} stack levels; the trace "
            f"kernel has {wide_levels(width)}"
        )


def staged_nodes(n_nodes: int, node_bytes: int, fixed_bytes: int,
                 budget: int) -> int:
    """How many leading nodes of a table a kernel stages in shared memory:
    as many rows of node_bytes as fit in `budget` bytes of a block's shared
    memory beside fixed_bytes (the barrier and the per-thread stacks), at
    most all n_nodes. Nodes past the prefix are read from device memory."""
    return max(0, min(n_nodes, (budget - fixed_bytes) // node_bytes))


def tri_rows(soup: np.ndarray) -> np.ndarray:
    """(T, 9) v0|e1|e2 -> (T, 12) rows padded for 16-byte loads."""
    out = np.zeros((soup.shape[0], 12), np.float32)
    out[:, :9] = soup
    return out


def bin_tables(bounds: np.ndarray, meta: np.ndarray):
    """Binary BVH (pre-order, skip links) -> the width-1 kernel's tables,
    pack_scene's per-node lanes: (bin_bounds (N, 8) f32 = [bmin xyz, bmax
    xyz, 0, 0], bin_meta (N, 4) i32 = [first tri | right child, count,
    miss, 0]). An inner node (count 0) carries its right child, the miss
    link of its left child j + 1, in the first field, so one load resolves
    both children."""
    n = bounds.shape[0]
    nb = np.zeros((n, 8), np.float32)
    nb[:, :6] = bounds
    nm = np.zeros((n, 4), np.int32)
    nm[:, :3] = meta
    inner = meta[:, 1] == 0
    left = np.arange(n) + 1
    right = np.where(left < n, meta[np.minimum(left, n - 1), 2], 0)
    nm[:, 0] = np.where(inner, right, meta[:, 0])
    return nb, nm


def bin_depth(meta: np.ndarray) -> int:
    """Inner nodes on the longest root-to-leaf path of a binary tree
    (0 for a single leaf)."""
    depth = np.zeros(meta.shape[0], np.int64)
    for j in range(meta.shape[0]):  # pre-order: parents come first
        if meta[j, 1] == 0:
            depth[j + 1] = depth[meta[j + 1, 2]] = depth[j] + 1
    return int(depth.max())


def bin_stack_bound(depth: int) -> int:
    """Most stack entries a binary traversal of a tree of this depth can
    hold: a visit pops one entry and pushes at most 2."""
    return depth + 1


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

_BVH8_TABLES = {"bvh8_bounds": torch.float32, "bvh8_child": torch.int32,
                "tri_rows": torch.float32}
_BVH4_TABLES = {"bvh4_bounds": torch.float32, "bvh4_child": torch.int32,
                "tri_rows": torch.float32}
_BIN_TABLES = {"bin_bounds": torch.float32, "bin_meta": torch.int32,
               "tri_rows": torch.float32}


def wide_tables(width: int) -> dict:
    """Names and types of the scene tables the width's traversal reads."""
    if width not in WIDTHS:
        raise ValueError(f"trace: width {width!r} is not in {WIDTHS}")
    return _BVH8_TABLES if width == 8 else _BVH4_TABLES


def trace(scene, o, d, mint, maxt, any_hit: bool = False,
          stats: bool = False, width: int = WIDTH):
    """Trace rays (o, d (R, 3); mint, maxt (R,)) through the scene's
    collapsed tables of `width` (bvh8_* or bvh4_*): the CUDA kernel for CUDA
    tensors, trace_plain for CPU ones. Returns a TraceResult; with
    stats=True, (TraceResult, counts (R, 3) int32 of inner visits, leaf
    visits and loop iterations per ray)."""
    if o.device.type == "cuda":
        return _trace_cuda(scene, o, d, mint, maxt, any_hit, stats, width)
    if o.device.type == "cpu":
        return trace_plain(scene, o, d, mint, maxt, any_hit, stats,
                           width=width)
    raise ValueError(f"trace: no traversal for device {o.device}")


def trace_bin(scene, o, d, mint, maxt, any_hit: bool = False) -> TraceResult:
    """Trace rays through the scene's binary tables (bin_tables): the CUDA
    kernel for CUDA tensors, trace_bin_plain for CPU ones."""
    if o.device.type == "cuda":
        return _trace_bin_cuda(scene, o, d, mint, maxt, any_hit)
    if o.device.type == "cpu":
        return trace_bin_plain(scene, o, d, mint, maxt, any_hit)
    raise ValueError(f"trace_bin: no traversal for device {o.device}")


def _check_inputs(scene, tables, o, d, mint, maxt):
    R = o.shape[0]
    want = {
        "o": (o, torch.float32, (R, 3)),
        "d": (d, torch.float32, (R, 3)),
        "mint": (mint, torch.float32, (R,)),
        "maxt": (maxt, torch.float32, (R,)),
    }
    want.update({name: (scene[name], dtype, None)
                 for name, dtype in tables.items()})
    for name, (x, dtype, shape) in want.items():
        if x.device != o.device:
            raise ValueError(f"trace: {name} is on {x.device}, rays on {o.device}")
        if x.dtype != dtype:
            raise TypeError(f"trace: {name} must be {dtype}, got {x.dtype}")
        if shape is not None and tuple(x.shape) != shape:
            raise ValueError(f"trace: {name} must have shape {shape}, got "
                             f"{tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"trace: {name} must be contiguous")
    if scene["tri_rows"].shape[1:] != (12,):
        raise ValueError("trace: tri_rows must be (T, 12)")
    if "bin_meta" not in tables:
        width = 8 if "bvh8_child" in tables else 4
        n = scene[f"bvh{width}_child"].shape[0]
        if tuple(scene[f"bvh{width}_bounds"].shape) != (n, 6, width) or \
                tuple(scene[f"bvh{width}_child"].shape) != (n, width):
            raise ValueError(f"trace: BVH{width} tables have the wrong layout")
    else:
        n = scene["bin_meta"].shape[0]
        if tuple(scene["bin_bounds"].shape) != (n, 8) or \
                tuple(scene["bin_meta"].shape) != (n, 4):
            raise ValueError("trace_bin: binary tables have the wrong layout")


def build_key(name: str) -> str:
    """Hash of everything a kernel's library is built from: the flags and
    defines, its source and the header it includes."""
    flags = NVCC_FLAGS + KERNEL_DEFINES.get(name, ())
    digest = hashlib.sha256(" ".join(flags).encode())
    for path in (KERNEL_SOURCES[name], *KERNEL_HEADERS):
        with open(path, "rb") as f:
            digest.update(f.read())
    return digest.hexdigest()[:16]


def build_kernel(name: str = "trace_bvh8") -> tuple[str, str]:
    """Compile KERNEL_SOURCES[name] (with KERNEL_DEFINES[name], if any) with
    nvcc into the package's _build directory, keyed by a hash of the source,
    the shared header and the flags; a library already built is reused.
    Returns (library path, compiler output)."""
    source = KERNEL_SOURCES[name]
    lib_path = os.path.join(_BUILD_DIR, f"{name}-{build_key(name)}.so")
    if os.path.exists(lib_path):
        return lib_path, ""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError(f"{name}: nvcc not found (needs the CUDA toolkit)")
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    proc = subprocess.run([nvcc, *NVCC_FLAGS, *KERNEL_DEFINES.get(name, ()),
                           "-o", tmp, source],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"{name}: nvcc failed\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib_path)
    return lib_path, proc.stdout + proc.stderr


def build_kernels() -> dict:
    """Build every kernel at once, one nvcc per source started together.
    Returns {name: (library path, compiler output)}."""
    with concurrent.futures.ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        futures = {name: pool.submit(build_kernel, name)
                   for name in KERNEL_SOURCES}
        return {name: f.result() for name, f in futures.items()}


@functools.cache
def _kernel_lib(name: str):
    lib = ctypes.CDLL(build_kernel(name)[0])
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    # tables, rays, n_rays, any_hit, [n_staged,] outputs, overflow, counter,
    # [stats,] stream
    head, tail = [ptr] * 7 + [i32, i32], [ptr] * 7 + [ptr]
    if name in ("trace_bvh8", "trace_bvh4"):
        entries = {f"goblin_{name}": head + tail,
                   f"goblin_{name}_stats": head + tail + [ptr],
                   f"goblin_{name}_blocks": [i32, ptr]}
    else:
        entries = {"goblin_trace_bvh2": head + [i32] + tail,
                   "goblin_trace_bvh2_blocks": [i32, i32, ptr],
                   "goblin_trace_bvh2_config": [ptr]}
    for entry, argtypes in entries.items():
        getattr(lib, entry).argtypes = argtypes
        getattr(lib, entry).restype = i32
    return lib


def launch_blocks(name: str, n_rays: int, n_staged: int = 0) -> int:
    """Blocks that a launch of n_rays rays runs on the current device, as the
    kernel's library plans it: the blocks that stay resident at once, or
    fewer where the rays do not fill them. n_staged is the binary kernel's
    staged prefix, which sets its blocks' shared memory."""
    out = ctypes.c_int(0)
    sizes = (n_rays, n_staged) if name == "trace_bvh2" else (n_rays,)
    err = getattr(_kernel_lib(name), f"goblin_{name}_blocks")(
        *sizes, ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"{name}: launch plan failed with CUDA error {err}")
    return out.value


class BinKernelConfig(NamedTuple):
    threads: int  # per block
    stack: int  # per-ray stack entries
    node_bytes: int  # shared memory a staged node takes
    fixed_bytes: int  # shared memory a block takes beside the nodes
    budget: int  # shared memory a block may take on this device


@functools.cache
def bin_kernel_config(device_index: int) -> BinKernelConfig:
    """The built binary kernel's launch shape and its shared-memory budget
    on a device, as its library reports them."""
    out = (ctypes.c_int * 5)()
    with torch.cuda.device(device_index):
        err = _kernel_lib("trace_bvh2").goblin_trace_bvh2_config(out)
    if err != 0:
        raise RuntimeError(f"trace_bvh2: config failed with CUDA error {err}")
    return BinKernelConfig(*out)


def bin_staged_nodes(n_nodes: int, device: torch.device) -> int:
    """Nodes of an n_nodes binary table that trace_bin stages in shared
    memory on a CUDA device."""
    cfg = bin_kernel_config(device.index if device.index is not None
                            else torch.cuda.current_device())
    return staged_nodes(n_nodes, cfg.node_bytes, cfg.fixed_bytes, cfg.budget)


def _launch(entry, counter, tables, o, d, mint, maxt, any_hit, staged=(),
            extra=()):
    """Allocate the outputs and the launch's two zeroed words (the stack
    overflow flag and the ray counter the persistent warps draw from),
    launch `entry` of a kernel library on the current stream, and count the
    launch. `staged` is (n_staged,) for a kernel that stages nodes. Returns
    the TraceResult."""
    for t in tables:
        if t.data_ptr() % 16:
            raise ValueError("trace: scene tables must be 16-byte aligned")
    R = o.shape[0]
    dev = o.device
    hit = torch.empty(R, dtype=torch.bool, device=dev)
    t = torch.empty(R, dtype=torch.float32, device=dev)
    tri = torch.empty(R, dtype=torch.int32, device=dev)
    b1 = torch.empty(R, dtype=torch.float32, device=dev)
    b2 = torch.empty(R, dtype=torch.float32, device=dev)
    if R == 0:
        return TraceResult(hit, t, tri, b1, b2)
    if R > MAX_RAYS:
        raise ValueError(f"trace: {R} rays in one launch, at most {MAX_RAYS}")
    words = torch.zeros(2, dtype=torch.int32, device=dev)  # overflow, counter
    with torch.cuda.device(dev):
        err = entry(
            *(x.data_ptr() for x in tables), o.data_ptr(), d.data_ptr(),
            mint.data_ptr(), maxt.data_ptr(), R, int(any_hit), *staged,
            hit.data_ptr(), t.data_ptr(), tri.data_ptr(), b1.data_ptr(),
            b2.data_ptr(), words.data_ptr(), words.data_ptr() + 4,
            *(x.data_ptr() for x in extra),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"{counter}: launch failed with CUDA error {err}")
    launches[counter] += 1
    # raises at the next synchronisation if a ray's stack overflowed
    torch._assert_async(words[0] == 0)
    return TraceResult(hit, t, tri, b1, b2)


def _trace_cuda(scene, o, d, mint, maxt, any_hit, stats, width):
    names = wide_tables(width)
    _check_inputs(scene, names, o, d, mint, maxt)
    kernel = f"trace_bvh{width}"
    lib = _kernel_lib(kernel)
    tables = [scene[name] for name in names]
    if not stats:
        return _launch(getattr(lib, f"goblin_{kernel}"), kernel, tables, o, d,
                       mint, maxt, any_hit)
    counts = torch.zeros((o.shape[0], 3), dtype=torch.int32, device=o.device)
    res = _launch(getattr(lib, f"goblin_{kernel}_stats"), f"{kernel}_stats",
                  tables, o, d, mint, maxt, any_hit, extra=(counts,))
    return res, counts


def _trace_bin_cuda(scene, o, d, mint, maxt, any_hit):
    _check_inputs(scene, _BIN_TABLES, o, d, mint, maxt)
    n_staged = bin_staged_nodes(scene["bin_meta"].shape[0], o.device)
    return _launch(_kernel_lib("trace_bvh2").goblin_trace_bvh2, "trace_bvh2",
                   [scene[name] for name in _BIN_TABLES], o, d, mint, maxt,
                   any_hit, staged=(n_staged,))


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


class _Best:
    """Per-ray best hit of a lockstep traversal."""

    def __init__(self, maxt):
        R, dev = maxt.shape[0], maxt.device
        self.t = torch.clamp(maxt, max=BIG_T)
        self.tri = torch.full((R,), -1, dtype=torch.int32, device=dev)
        self.b1 = torch.zeros(R, dtype=torch.float32, device=dev)
        self.b2 = torch.zeros(R, dtype=torch.float32, device=dev)

    def result(self) -> TraceResult:
        hit = self.tri >= 0
        return TraceResult(hit, torch.where(hit, self.t, BIG_T), self.tri,
                           self.b1, self.b2)


def _leaf_tests(tris, o, d, mint, best, rl, first, count, any_hit):
    """Moller-Trumbore of triangles first .. first + count - 1 for each
    lane rl, with the kernels' arithmetic and their sequential accept rule
    (mint <= t <= t_best, so of equal t the last triangle tested wins;
    any-hit keeps the first accepted). Updates best in place and returns
    the lanes that accepted a triangle."""
    dev = o.device
    k = torch.arange(int(count.max()), device=dev)
    valid = k[None, :] < count[:, None]
    idx = torch.clamp(first[:, None] + k[None, :], max=tris.shape[0] - 1)
    tr = tris[idx]  # (n, K, 12)
    v0x, v0y, v0z = tr[..., 0], tr[..., 1], tr[..., 2]
    e1x, e1y, e1z = tr[..., 3], tr[..., 4], tr[..., 5]
    e2x, e2y, e2z = tr[..., 6], tr[..., 7], tr[..., 8]
    ox, oy, oz = (o[rl, c][:, None] for c in range(3))
    dx, dy, dz = (d[rl, c][:, None] for c in range(3))
    s1x = dy * e2z - dz * e2y
    s1y = dz * e2x - dx * e2z
    s1z = dx * e2y - dy * e2x
    div = s1x * e1x + s1y * e1y + s1z * e1z
    inv_div = 1.0 / torch.where(div == 0.0, _TINY, div)
    sx, sy, sz = ox - v0x, oy - v0y, oz - v0z
    b1 = (sx * s1x + sy * s1y + sz * s1z) * inv_div
    s2x = sy * e1z - sz * e1y
    s2y = sz * e1x - sx * e1z
    s2z = sx * e1y - sy * e1x
    b2 = (dx * s2x + dy * s2y + dz * s2z) * inv_div
    t = (e2x * s2x + e2y * s2y + e2z * s2z) * inv_div
    ok = (valid & (div != 0.0)
          & (b1 + _TRI_EPS >= 0.0) & (b1 - _TRI_EPS <= 1.0)
          & (b2 + _TRI_EPS >= 0.0) & (b1 + b2 - _TRI_EPS <= 1.0)
          & (t >= mint[rl][:, None]) & (t <= best.t[rl][:, None]))
    kk = k[None, :].expand_as(ok)
    if any_hit:
        # the kernels stop at the first accepted triangle
        win = torch.where(ok, kk, k.numel()).min(dim=1).values
    else:
        # sequential t <= t_best: the smallest t wins, and of equal
        # smallest t the last triangle tested
        tm = torch.where(ok, t, float("inf"))
        tmin = tm.min(dim=1).values
        win = torch.where(ok & (tm == tmin[:, None]), kk, -1)
        win = win.max(dim=1).values
    got = ok.any(dim=1)
    lanes = rl[got]
    w = win[got][:, None]
    best.t[lanes] = torch.gather(t[got], 1, w)[:, 0]
    best.tri[lanes] = (first[got] + win[got]).to(torch.int32)
    best.b1[lanes] = torch.gather(b1[got], 1, w)[:, 0]
    best.b2[lanes] = torch.gather(b2[got], 1, w)[:, 0]
    return lanes


def _slab(lo, hi, o, inv, mint, t_best):
    """Entry and exit distances of boxes [lo, hi] (n, 3, ...) for rays
    (n, 3, 1), clipped to [mint, t_best] (n, 1)."""
    t0 = (lo - o) * inv
    t1 = (hi - o) * inv
    near, far = torch.minimum(t0, t1), torch.maximum(t0, t1)
    tn = torch.maximum(torch.maximum(near[:, 0], near[:, 1]), near[:, 2])
    tf = torch.minimum(torch.minimum(far[:, 0], far[:, 1]), far[:, 2])
    return torch.maximum(tn, mint), torch.minimum(tf, t_best)


def trace_plain(scene, o, d, mint, maxt, any_hit: bool = False,
                stats: bool = False, census: bool = False,
                width: int = WIDTH):
    """The wide kernel's traversal in plain PyTorch, vectorised over rays,
    on the scene's tables of `width` (8 or 4).

    Every ray keeps its own stack in a (R, 64) tensor. Each step pops one
    entry per live ray: an inner node slab-tests its children and pushes
    the kept ones far to near (a stable sort on entry distance, the
    kernel's order); a leaf tests its triangles with the kernel's
    arithmetic and accept rule. Steps repeat until every stack is empty.
    With stats=True also returns the kernel's per-ray counts (R, 3): inner
    visits, leaf visits, loop iterations. With census=True it returns
    instead per-ray counts (R, 4) of the work the walk needed: inner visits,
    leaf visits, child boxes tested (the visited nodes' slots that are not
    EMPTY) and triangles tested.
    """
    if stats and census:
        raise ValueError("trace_plain: stats or census, not both")
    names = wide_tables(width)
    _check_inputs(scene, names, o, d, mint, maxt)
    bounds, child, tris = (scene[name] for name in names)
    R = o.shape[0]
    dev = o.device
    inv = 1.0 / torch.where(d == 0.0, _TINY, d)
    best = _Best(maxt)
    counts = torch.zeros((R, 3), dtype=torch.int32, device=dev)
    work = torch.zeros((R, 4), dtype=torch.int32, device=dev)
    stack = torch.zeros((R, STACK), dtype=torch.int32, device=dev)
    sp = (mint < best.t).to(torch.int64)  # a dead lane skips the root
    slots = torch.arange(width, device=dev)
    while True:
        live = torch.nonzero(sp > 0).squeeze(1)
        if live.numel() == 0:
            break
        sp[live] -= 1
        e = stack[live, sp[live]]
        inner = e >= 0
        counts[live, 2] += 1

        ri = live[inner]
        if ri.numel():
            counts[ri, 0] += 1
            node = e[inner].long()
            nb = bounds[node]  # (n, 6, width)
            ent = child[node]  # (n, width)
            if census:
                work[ri, 0] += 1
                work[ri, 2] += (ent != EMPTY).sum(dim=1).to(torch.int32)
            tn, tf = _slab(nb[:, 0:3], nb[:, 3:6], o[ri][:, :, None],
                           inv[ri][:, :, None], mint[ri][:, None],
                           best.t[ri][:, None])
            key = torch.where((ent != EMPTY) & (tn <= tf), tn, float("inf"))
            key, order = torch.sort(key, dim=1, stable=True)
            ent = torch.gather(ent, 1, order)
            kept = key < float("inf")
            n_keep = kept.sum(dim=1)
            base = sp[ri]
            if int((base + n_keep).max()) > STACK:
                raise RuntimeError("trace_plain: traversal stack overflow")
            # sorted slot j goes to base + n_keep - 1 - j: nearest on top
            pos = base[:, None] + n_keep[:, None] - 1 - slots[None, :]
            rows = ri[:, None].expand(-1, width)
            stack[rows[kept], pos[kept]] = ent[kept]
            sp[ri] = base + n_keep

        rl = live[~inner]
        if rl.numel():
            counts[rl, 1] += 1
            dec = -(e[~inner].long() + 1)
            if census:
                work[rl, 1] += 1
                work[rl, 3] += (dec & 127).to(torch.int32)
            lanes = _leaf_tests(tris, o, d, mint, best, rl, (dec >> 7) * 8,
                                dec & 127, any_hit)
            if any_hit:
                sp[lanes] = 0
    if census:
        return best.result(), work
    if stats:
        return best.result(), counts
    return best.result()


def trace_bin_plain(scene, o, d, mint, maxt, any_hit: bool = False,
                    census: bool = False):
    """The binary kernel's traversal in plain PyTorch, vectorised over rays.

    Every ray keeps its own stack of (node, entry distance) in (R, 32)
    tensors, starting with the root at entry distance -3e38. Each step pops
    one entry per live ray and skips it if it was entered beyond the ray's
    best t; an inner node box-tests both children and pushes the hit ones
    far then near (near: the smaller entry distance, ties to the left
    child); a leaf tests its triangles as trace_plain does. Steps repeat
    until every stack is empty. With census=True also returns per-ray
    counts (R, 3) of the work the walk needed: inner visits (two box tests
    each), leaf visits and triangles tested.
    """
    _check_inputs(scene, _BIN_TABLES, o, d, mint, maxt)
    bounds, meta, tris = (scene["bin_bounds"], scene["bin_meta"],
                          scene["tri_rows"])
    R = o.shape[0]
    dev = o.device
    inv = 1.0 / torch.where(d == 0.0, _TINY, d)
    best = _Best(maxt)
    stack = torch.zeros((R, BIN_STACK), dtype=torch.int64, device=dev)
    stack_tn = torch.full((R, BIN_STACK), -BIG_T, dtype=torch.float32,
                          device=dev)
    sp = torch.ones(R, dtype=torch.int64, device=dev)  # the root
    counts = torch.zeros((R, 3), dtype=torch.int32, device=dev)
    while True:
        live = torch.nonzero(sp > 0).squeeze(1)
        if live.numel() == 0:
            break
        sp[live] -= 1
        node = stack[live, sp[live]]
        keep = stack_tn[live, sp[live]] <= best.t[live]
        live, node = live[keep], node[keep]
        m = meta[node]  # (n, 4)
        inner = m[:, 1] == 0

        ri = live[inner]
        if ri.numel():
            counts[ri, 0] += 1
            kids = torch.stack([node[inner] + 1, m[inner, 0].long()], dim=1)
            nb = bounds[kids]  # (n, 2, 8)
            tn, tf = _slab(nb[..., 0:3].transpose(1, 2),
                           nb[..., 3:6].transpose(1, 2), o[ri][:, :, None],
                           inv[ri][:, :, None], mint[ri][:, None],
                           best.t[ri][:, None])
            tmin = torch.where(tn <= tf, tn, BIG_T)  # (n, 2): left, right
            l_near = tmin[:, 0] <= tmin[:, 1]
            near = torch.where(l_near, kids[:, 0], kids[:, 1])
            far = torch.where(l_near, kids[:, 1], kids[:, 0])
            near_tn = torch.minimum(tmin[:, 0], tmin[:, 1])
            far_tn = torch.maximum(tmin[:, 0], tmin[:, 1])
            push_far, push_near = far_tn < BIG_T, near_tn < BIG_T
            base = sp[ri]
            top = base + push_far.long() + push_near.long()
            if int(top.max()) > BIN_STACK:
                raise RuntimeError("trace_bin_plain: traversal stack overflow")
            rf = ri[push_far]
            stack[rf, base[push_far]] = far[push_far]
            stack_tn[rf, base[push_far]] = far_tn[push_far]
            pos = base + push_far.long()
            rn = ri[push_near]
            stack[rn, pos[push_near]] = near[push_near]
            stack_tn[rn, pos[push_near]] = near_tn[push_near]
            sp[ri] = top

        rl = live[~inner]
        if rl.numel():
            counts[rl, 1] += 1
            counts[rl, 2] += m[~inner, 1]
            lanes = _leaf_tests(tris, o, d, mint, best, rl,
                                m[~inner, 0].long(), m[~inner, 1].long(),
                                any_hit)
            if any_hit:
                sp[lanes] = 0
    if census:
        return best.result(), counts
    return best.result()
