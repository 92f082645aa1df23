"""BVH8 ray traversal: host-side layout, the CUDA kernel's wrapper, and its
plain PyTorch version.

Port of goblin_tpu/ops/pallas_trace.py's wide-BVH path: ``collapse8`` is
``collapse4(width=8)`` without the TPU bias packing, and ``trace`` has the
contract of ``trace_packets4``: closest-hit returns (hit, t, tri, b1, b2)
with t = 3e38 on a miss and tri in BVH order; any-hit stops a ray at its
first accepted triangle, and then only ``hit`` is defined.

On a CUDA tensor ``trace`` launches csrc/trace_bvh8.cu (built with nvcc at
first use, bound with ctypes) and never falls back; on a CPU tensor it runs
``trace_plain``, the same traversal in vectorised lockstep.
"""

from __future__ import annotations

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
STACK = 64  # per-ray stack entries, in the kernel and trace_plain
EMPTY = -1  # child entry of an unused slot
BIG_T = 3.0e38
_TINY = 1e-30
_TRI_EPS = 1e-7

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNEL_SOURCE = os.path.join(_PKG, "csrc", "trace_bvh8.cu")
_BUILD_DIR = os.path.join(_PKG, "_build")
# --fmad=false: no contraction into FMA, so the kernel rounds as eager
# PyTorch (and trace_plain) does
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# CUDA kernel launches since the last reset (chip_smoke.py reads it to show
# that a render went through the kernel)
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


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


def collapse8(bounds: np.ndarray, meta: np.ndarray):
    """Binary BVH (pre-order, skip links, 8-aligned leaves) -> 8-wide tree.

    Each wide node gathers up to 8 subtree roots under a binary inner node,
    opening the largest-area inner root first (collapse4's rule), and node
    ids are assigned in the same DFS pre-order as collapse4. Returns
    (node_bounds (N8, 6, 8) f32, node_child (N8, 8) i32, depth), where
    depth counts wide nodes on the longest root-to-leaf path.
    """
    is_leaf = meta[:, 1] > 0
    rows_b: list[np.ndarray] = []
    rows_c: list[np.ndarray] = []

    def area(j):
        d = np.maximum(bounds[j, 3:6] - bounds[j, 0:3], 0.0)
        return d[0] * d[1] + d[1] * d[2] + d[2] * d[0]

    def kids(j):
        return [j + 1, int(meta[j + 1, 2])]

    def new_row():
        rows_b.append(np.zeros((6, WIDTH), np.float32))
        rows_c.append(np.full(WIDTH, EMPTY, np.int32))
        return len(rows_b) - 1

    def emit(j) -> tuple[int, int]:
        my = new_row()
        group = kids(j)
        while len(group) < WIDTH:
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


def stack_bound(depth: int) -> int:
    """Most stack entries a traversal of a tree of this depth can hold: a
    visit pops one entry and pushes at most 8."""
    return (WIDTH - 1) * depth + 1


def tri_rows(soup: np.ndarray) -> np.ndarray:
    """(T, 9) v0|e1|e2 -> (T, 12) rows padded for 16-byte loads."""
    out = np.zeros((soup.shape[0], 12), np.float32)
    out[:, :9] = soup
    return out


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------


def trace(scene, o, d, mint, maxt, any_hit: bool = False) -> TraceResult:
    """Trace rays (o, d (R, 3); mint, maxt (R,)) through the scene's BVH8
    tables: the CUDA kernel for CUDA tensors, trace_plain for CPU ones."""
    if o.device.type == "cuda":
        return _trace_cuda(scene, o, d, mint, maxt, any_hit)
    if o.device.type == "cpu":
        return trace_plain(scene, o, d, mint, maxt, any_hit)
    raise ValueError(f"trace: no traversal for device {o.device}")


def _check_inputs(scene, o, d, mint, maxt):
    R = o.shape[0]
    want = {
        "o": (o, torch.float32, (R, 3)),
        "d": (d, torch.float32, (R, 3)),
        "mint": (mint, torch.float32, (R,)),
        "maxt": (maxt, torch.float32, (R,)),
        "bvh8_bounds": (scene["bvh8_bounds"], torch.float32, None),
        "bvh8_child": (scene["bvh8_child"], torch.int32, None),
        "tri_rows": (scene["tri_rows"], torch.float32, None),
    }
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
    n8 = scene["bvh8_child"].shape[0]
    if tuple(scene["bvh8_bounds"].shape) != (n8, 6, WIDTH) or \
            tuple(scene["bvh8_child"].shape) != (n8, WIDTH) or \
            scene["tri_rows"].shape[1:] != (12,):
        raise ValueError("trace: BVH8 tables have the wrong layout")


def build_kernel() -> tuple[str, str]:
    """Compile csrc/trace_bvh8.cu with nvcc into the package's _build
    directory, keyed by a hash of the source and flags; a library already
    built is reused. Returns (library path, compiler output)."""
    with open(KERNEL_SOURCE, "rb") as f:
        src = f.read()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib_path = os.path.join(_BUILD_DIR, f"trace_bvh8-{key}.so")
    if os.path.exists(lib_path):
        return lib_path, ""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("trace_bvh8: nvcc not found (needs the CUDA toolkit)")
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, KERNEL_SOURCE],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"trace_bvh8: nvcc failed\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib_path)
    return lib_path, proc.stdout + proc.stderr


@functools.cache
def _kernel_lib():
    lib = ctypes.CDLL(build_kernel()[0])
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.goblin_trace_bvh8.argtypes = [ptr] * 7 + [i32, i32] + [ptr] * 7
    lib.goblin_trace_bvh8.restype = i32
    return lib


def _trace_cuda(scene, o, d, mint, maxt, any_hit):
    global launches
    _check_inputs(scene, o, d, mint, maxt)
    for name in ("bvh8_bounds", "bvh8_child", "tri_rows"):
        if scene[name].data_ptr() % 16:
            raise ValueError(f"trace: {name} must be 16-byte aligned")
    R = o.shape[0]
    dev = o.device
    hit = torch.empty(R, dtype=torch.bool, device=dev)
    t = torch.empty(R, dtype=torch.float32, device=dev)
    tri = torch.empty(R, dtype=torch.int32, device=dev)
    b1 = torch.empty(R, dtype=torch.float32, device=dev)
    b2 = torch.empty(R, dtype=torch.float32, device=dev)
    if R == 0:
        return TraceResult(hit, t, tri, b1, b2)
    overflow = torch.zeros(1, dtype=torch.int32, device=dev)
    lib = _kernel_lib()
    with torch.cuda.device(dev):
        err = lib.goblin_trace_bvh8(
            scene["bvh8_bounds"].data_ptr(), scene["bvh8_child"].data_ptr(),
            scene["tri_rows"].data_ptr(), o.data_ptr(), d.data_ptr(),
            mint.data_ptr(), maxt.data_ptr(), R, int(any_hit),
            hit.data_ptr(), t.data_ptr(), tri.data_ptr(), b1.data_ptr(),
            b2.data_ptr(), overflow.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"trace_bvh8: launch failed with CUDA error {err}")
    launches += 1
    # raises at the next synchronisation if a ray's stack overflowed
    torch._assert_async(overflow[0] == 0)
    return TraceResult(hit, t, tri, b1, b2)


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------


def trace_plain(scene, o, d, mint, maxt, any_hit: bool = False) -> TraceResult:
    """The kernel's traversal in plain PyTorch, vectorised over rays.

    Every ray keeps its own stack in a (R, 64) tensor. Each step pops one
    entry per live ray: an inner node slab-tests its 8 children and pushes
    the kept ones far to near (a stable sort on entry distance, the
    kernel's order); a leaf tests its triangles with the kernel's
    arithmetic and accept rule. Steps repeat until every stack is empty.
    """
    _check_inputs(scene, o, d, mint, maxt)
    bounds, child, tris = (scene["bvh8_bounds"], scene["bvh8_child"],
                           scene["tri_rows"])
    R = o.shape[0]
    dev = o.device
    inv = 1.0 / torch.where(d == 0.0, _TINY, d)
    t_best = torch.clamp(maxt, max=BIG_T)
    tri_best = torch.full((R,), -1, dtype=torch.int32, device=dev)
    b1_best = torch.zeros(R, dtype=torch.float32, device=dev)
    b2_best = torch.zeros(R, dtype=torch.float32, device=dev)
    stack = torch.zeros((R, STACK), dtype=torch.int32, device=dev)
    sp = (mint < t_best).to(torch.int64)  # a dead lane skips the root
    slots = torch.arange(WIDTH, device=dev)
    inf = float("inf")
    while True:
        live = torch.nonzero(sp > 0).squeeze(1)
        if live.numel() == 0:
            break
        sp[live] -= 1
        e = stack[live, sp[live]]
        inner = e >= 0

        ri = live[inner]
        if ri.numel():
            node = e[inner].long()
            nb = bounds[node]  # (n, 6, 8)
            ent = child[node]  # (n, 8)
            oo, ii = o[ri][:, :, None], inv[ri][:, :, None]
            t0 = (nb[:, 0:3] - oo) * ii
            t1 = (nb[:, 3:6] - oo) * ii
            lo, hi = torch.minimum(t0, t1), torch.maximum(t0, t1)
            tn = torch.maximum(torch.maximum(lo[:, 0], lo[:, 1]), lo[:, 2])
            tf = torch.minimum(torch.minimum(hi[:, 0], hi[:, 1]), hi[:, 2])
            tn = torch.maximum(tn, mint[ri][:, None])
            tf = torch.minimum(tf, t_best[ri][:, None])
            key = torch.where((ent != EMPTY) & (tn <= tf), tn, inf)
            key, order = torch.sort(key, dim=1, stable=True)
            ent = torch.gather(ent, 1, order)
            kept = key < inf
            n_keep = kept.sum(dim=1)
            base = sp[ri]
            if int((base + n_keep).max()) > STACK:
                raise RuntimeError("trace_plain: traversal stack overflow")
            # sorted slot j goes to base + n_keep - 1 - j: nearest on top
            pos = base[:, None] + n_keep[:, None] - 1 - slots[None, :]
            rows = ri[:, None].expand(-1, WIDTH)
            stack[rows[kept], pos[kept]] = ent[kept]
            sp[ri] = base + n_keep

        rl = live[~inner]
        if rl.numel():
            dec = -(e[~inner].long() + 1)
            count = dec & 127
            first = (dec >> 7) * 8
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
                  & (t >= mint[rl][:, None]) & (t <= t_best[rl][:, None]))
            kk = k[None, :].expand_as(ok)
            if any_hit:
                # the kernel stops at the first accepted triangle
                win = torch.where(ok, kk, k.numel()).min(dim=1).values
            else:
                # sequential t <= t_best: the smallest t wins, and of equal
                # smallest t the last triangle tested
                tm = torch.where(ok, t, inf)
                tmin = tm.min(dim=1).values
                win = torch.where(ok & (tm == tmin[:, None]), kk, -1)
                win = win.max(dim=1).values
            got = ok.any(dim=1)
            lanes = rl[got]
            w = win[got][:, None]
            t_best[lanes] = torch.gather(t[got], 1, w)[:, 0]
            tri_best[lanes] = (first[got] + win[got]).to(torch.int32)
            b1_best[lanes] = torch.gather(b1[got], 1, w)[:, 0]
            b2_best[lanes] = torch.gather(b2[got], 1, w)[:, 0]
            if any_hit:
                sp[lanes] = 0
    hit = tri_best >= 0
    return TraceResult(hit, torch.where(hit, t_best, BIG_T), tri_best,
                       b1_best, b2_best)
