"""Closest-hit and any-hit ray queries by brute force over clusters.

The triangles are sorted by the Morton code of their centroids and cut
into clusters of CLUSTER triangles, each with its bounding box. A query
tests every ray against every cluster's box and every candidate pair
against the cluster's triangles (Moller-Trumbore with a 1e-7 barycentric
tolerance). There is no tree and no traversal order: of equal t the
lowest triangle index wins.
"""

from __future__ import annotations

import numpy as np
import torch

CLUSTER = 32
TRI_EPS = 1e-7


def _morton(c):
    """30-bit Morton codes of points c (N, 3) in their bounding box."""
    lo, hi = c.min(0), c.max(0)
    q = ((c - lo) / np.maximum(hi - lo, 1e-20) * 1023).astype(np.int64)
    code = np.zeros(len(c), np.int64)
    for bit in range(10):
        for axis in range(3):
            code |= ((q[:, axis] >> bit) & 1) << (3 * bit + axis)
    return code


class Clusters:
    """The scene's triangles as padded clusters on a device, in dtype."""

    def __init__(self, scene, device, dtype=torch.float32):
        v0, e1, e2 = scene.v0, scene.e1, scene.e2
        order = np.argsort(_morton(v0 + (e1 + e2) / 3.0), kind="stable")
        n = len(order)
        n_c = -(-n // CLUSTER)
        idx = np.full(n_c * CLUSTER, -1, np.int64)
        idx[:n] = order
        idx = idx.reshape(n_c, CLUSTER)
        safe = np.maximum(idx, 0)
        pad = (idx < 0)[..., None]

        def cl(a):
            return np.where(pad, 0.0, a[safe]).astype(np.float32)

        c0, c1, c2 = cl(v0), cl(v0 + e1), cl(v0 + e2)
        corners = np.stack([c0, c1, c2], 2)  # (C, G, 3, 3)
        big = np.float32(3e38)
        lo = np.where(pad[..., None], big, corners).min(axis=(1, 2))
        hi = np.where(pad[..., None], -big, corners).max(axis=(1, 2))

        def dev(a, dt=dtype):
            return torch.as_tensor(a, device=device).to(dt)

        self.tri = dev(idx, torch.int64)  # (C, G) triangle ids, -1 padding
        self.v0, self.e1, self.e2 = dev(c0), dev(cl(e1)), dev(cl(e2))
        self.lo, self.hi = dev(lo), dev(hi)
        # rays a block, and candidate pairs a block, to bound the memory
        self.ray_block = 8192 if torch.device(device).type == "cuda" else 512
        self.pair_block = 1 << 17 if torch.device(device).type == "cuda" \
            else 1 << 12

    def _pairs(self, o, d, mint, maxt):
        """(ray, cluster) pairs whose box the ray's segment meets."""
        inv = 1.0 / torch.where(d.abs() < 1e-30, 1e-30, d)
        t0 = (self.lo[None] - o[:, None]) * inv[:, None]
        t1 = (self.hi[None] - o[:, None]) * inv[:, None]
        tn = torch.maximum(torch.minimum(t0, t1).amax(-1), mint[:, None])
        tf = torch.minimum(torch.maximum(t0, t1).amin(-1), maxt[:, None])
        return (tn <= tf).nonzero(as_tuple=True)

    def _test(self, o, d, mint, maxt, r, c):
        """Moller-Trumbore of pairs (r, c) against the cluster's triangles
        -> (hit, t), each (P, CLUSTER)."""
        oo, dd = o[r][:, None], d[r][:, None]
        v0, e1, e2 = self.v0[c], self.e1[c], self.e2[c]
        s1 = torch.cross(dd.expand_as(e2), e2, dim=-1)
        div = (s1 * e1).sum(-1)
        inv = 1.0 / torch.where(div == 0.0, 1e-30, div)
        s = oo - v0
        b1 = (s * s1).sum(-1) * inv
        s2 = torch.cross(s, e1, dim=-1)
        b2 = (dd * s2).sum(-1) * inv
        t = (e2 * s2).sum(-1) * inv
        hit = ((div != 0.0) & (b1 + TRI_EPS >= 0.0) & (b1 - TRI_EPS <= 1.0)
               & (b2 + TRI_EPS >= 0.0) & (b1 + b2 - TRI_EPS <= 1.0)
               & (t >= mint[r][:, None]) & (t <= maxt[r][:, None])
               & (self.tri[c] >= 0))
        return hit, t

    def closest(self, o, d, mint, maxt):
        """-> (hit (R,), tri (R,) int64, -1 on a miss). The nearest t wins,
        and of equal t the lowest triangle id: both in one int64 key, t's
        float32 bits (t >= 0, so they order as t does) above the id."""
        R = o.shape[0]
        none = torch.iinfo(torch.int64).max
        best = torch.full((R,), none, dtype=torch.int64, device=o.device)
        for a in range(0, R, self.ray_block):
            sl = slice(a, min(R, a + self.ray_block))
            r_all, c_all = self._pairs(o[sl], d[sl], mint[sl], maxt[sl])
            for b in range(0, r_all.numel(), self.pair_block):
                r = r_all[b:b + self.pair_block] + a
                c = c_all[b:b + self.pair_block]
                hit, t = self._test(o, d, mint, maxt, r, c)
                bits = t.float().view(torch.int32).to(torch.int64)
                key = torch.where(hit, (bits << 32) | self.tri[c], none)
                best.scatter_reduce_(0, r, key.amin(-1), "amin")
        hit = best != none
        return hit, torch.where(hit, best & 0xFFFFFFFF, -1)

    def occluded(self, o, d, mint, maxt):
        """-> (R,) bool: some triangle lies in [mint, maxt]."""
        R = o.shape[0]
        count = torch.zeros(R, dtype=torch.int32, device=o.device)
        for a in range(0, R, self.ray_block):
            sl = slice(a, min(R, a + self.ray_block))
            r_all, c_all = self._pairs(o[sl], d[sl], mint[sl], maxt[sl])
            for b in range(0, r_all.numel(), self.pair_block):
                r = r_all[b:b + self.pair_block] + a
                c = c_all[b:b + self.pair_block]
                hit, _ = self._test(o, d, mint, maxt, r, c)
                count.index_add_(0, r, hit.any(-1).to(torch.int32))
        return count > 0
