"""Host-side binary BVH build over the world-space triangle soup (port of
goblin_tpu/accel/bvh.py).

Top-down binned SAH on the longest centroid axis with a median fallback;
nodes in DFS pre-order with skip links (meta = [first_tri, tri_count
(0 = inner), miss_link]); the right child of inner node j is
meta[j + 1, 2]. ops/trace.collapse8 turns this tree into the 8-wide
layout the trace kernel walks.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass

import numpy as np

from .. import native


@dataclass
class BVHArrays:
    """Flattened BVH in DFS pre-order with skip links (host, numpy)."""

    bounds: np.ndarray  # (N, 6) f32: bmin xyz, bmax xyz
    meta: np.ndarray  # (N, 3) i32: [first_tri, tri_count (0=inner), miss]
    order: np.ndarray  # (T,) i32: soup index per slot (-1 = padding)

    @property
    def num_nodes(self) -> int:
        return int(self.bounds.shape[0])


def build_bvh(v0, v1, v2, max_leaf: int = 4, n_bins: int = 16) -> BVHArrays:
    """Build from triangle vertex arrays (T, 3) each: the native builder
    when the library loads, the Python builder otherwise."""
    res = native.build_bvh(v0, v1, v2, max_leaf=max_leaf, n_bins=n_bins)
    if res is not None:
        return BVHArrays(*res)
    return _build_bvh_python(v0, v1, v2, max_leaf, n_bins)


def _build_bvh_python(v0, v1, v2, max_leaf: int = 4,
                      n_bins: int = 16) -> BVHArrays:
    T = v0.shape[0]
    tri_min = np.minimum(np.minimum(v0, v1), v2).astype(np.float32)
    tri_max = np.maximum(np.maximum(v0, v1), v2).astype(np.float32)
    centers = (0.5 * (tri_min + tri_max)).astype(np.float32)
    order = np.empty(T, dtype=np.int32)
    order_pos = 0

    def area_of(lo, hi):
        d = np.maximum(hi - lo, 0.0)
        return d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] + d[..., 2] * d[..., 0]

    def median_split(idx, axis):
        half = idx.shape[0] // 2
        part = np.argsort(centers[idx, axis], kind="stable")
        return idx[part[:half]], idx[part[half:]]

    def sah_split(idx):
        """(left_idx, right_idx), or None for a leaf."""
        n = idx.shape[0]
        if n <= max_leaf:
            return None
        cmin = centers[idx].min(axis=0)
        cmax = centers[idx].max(axis=0)
        extent = cmax - cmin
        axis = int(np.argmax(extent))
        if extent[axis] <= 1e-12:
            # all centroids coincide: arbitrary equal split
            return idx[: n // 2], idx[n // 2:]
        scale = n_bins * (1.0 - 1e-6) / extent[axis]
        bin_id = ((centers[idx, axis] - cmin[axis]) * scale).astype(np.int32)
        counts = np.bincount(bin_id, minlength=n_bins)
        bin_min = np.full((n_bins, 3), np.inf, dtype=np.float64)
        bin_max = np.full((n_bins, 3), -np.inf, dtype=np.float64)
        for a in range(3):
            np.minimum.at(bin_min[:, a], bin_id, tri_min[idx, a])
            np.maximum.at(bin_max[:, a], bin_id, tri_max[idx, a])
        # prefix/suffix sweep
        lmin = np.minimum.accumulate(bin_min, axis=0)
        lmax = np.maximum.accumulate(bin_max, axis=0)
        rmin = np.minimum.accumulate(bin_min[::-1], axis=0)[::-1]
        rmax = np.maximum.accumulate(bin_max[::-1], axis=0)[::-1]
        lcount = np.cumsum(counts)
        rcount = n - lcount
        cost = np.full(n_bins - 1, np.inf)
        valid = (lcount[:-1] > 0) & (rcount[:-1] > 0)
        la = area_of(lmin[:-1], lmax[:-1])
        ra = area_of(rmin[1:], rmax[1:])
        cost[valid] = la[valid] * lcount[:-1][valid] + ra[valid] * rcount[:-1][valid]
        best = int(np.argmin(cost))
        if not np.isfinite(cost[best]):
            return median_split(idx, axis)
        go_left = bin_id <= best
        left, right = idx[go_left], idx[~go_left]
        if left.size == 0 or right.size == 0:  # numeric corner
            return median_split(idx, axis)
        return left, right

    bounds_out: list[tuple] = []
    meta_out: list[list[int]] = []

    def emit(idx) -> int:
        nonlocal order_pos
        my_id = len(bounds_out)
        bounds_out.append((tri_min[idx].min(axis=0), tri_max[idx].max(axis=0)))
        meta_out.append([0, 0, 0])
        split = sah_split(idx)
        if split is None:
            first = order_pos
            order[first:first + idx.shape[0]] = idx
            order_pos += idx.shape[0]
            meta_out[my_id][0] = first
            meta_out[my_id][1] = idx.shape[0]
        else:
            emit(split[0])
            emit(split[1])
        meta_out[my_id][2] = len(bounds_out)  # next node after my subtree
        return my_id

    sys.setrecursionlimit(max(10000, 64 + 2 * T))
    emit(np.arange(T, dtype=np.int64))
    bounds = np.concatenate(
        [np.stack([b for b, _ in bounds_out]),
         np.stack([b for _, b in bounds_out])],
        axis=1,
    ).astype(np.float32)
    return BVHArrays(bounds=bounds, meta=np.asarray(meta_out, dtype=np.int32),
                     order=order)


def align_leaves(bvh: BVHArrays, align: int = 8) -> BVHArrays:
    """Pad the triangle ordering so every leaf's first triangle sits on a
    multiple of `align`; padding slots are -1 (the bake turns them into
    zero-area triangles that never hit). The 8-wide leaf encoding stores
    first / 8."""
    meta = bvh.meta.copy()
    order = bvh.order
    leaf_ids = np.nonzero(meta[:, 1] > 0)[0]
    leaf_ids = leaf_ids[np.argsort(meta[leaf_ids, 0], kind="stable")]
    chunks = []
    pos = 0
    for n in leaf_ids:
        first, count = int(meta[n, 0]), int(meta[n, 1])
        meta[n, 0] = pos
        chunks.append(order[first:first + count])
        pad = (-count) % align
        if pad:
            chunks.append(np.full(pad, -1, np.int32))
        pos += count + pad
    new_order = (np.concatenate(chunks).astype(np.int32)
                 if chunks else np.zeros(0, np.int32))
    return BVHArrays(bounds=bvh.bounds, meta=meta, order=new_order)
