"""Edge-sampled visibility gradients for area-light direct lighting (port
of goblin_tpu/integrators/edge_grad.py).

Automatic differentiation reaches every smooth term of a path (BSDFs,
light radiance, the hit recompute of scene/intersect.py), but the binary
visibility V of the next-event integral is a step: moving an occluder
changes which light samples are blocked, a boundary effect AD cannot see.
Edge sampling (the direct-lighting case of Li et al. 2018) supplies it.
For a shading point p and an area light, the blocked region B on the
light's plane is bounded by the projections of the occluder's silhouette
edges from p, and

    dL/dth = - \\oint_{dB} g(y(s)) (v(s) x T(s)) . n_l ds,
    g = f(p, y) Le cos_p cos_l / r^2,

with y(s) the projection of edge point e(s), v = dy/dth, T = dy/ds and
n_l the light's normal; edges are oriented so that the projected
silhouette runs counter-clockwise about n_l.

- direct_light_boundary_grad: one triangle occluder, all three edges,
  its projection inside the light.
- mesh_boundary_grad: a mesh occluder. build_edge_adjacency (numpy, on
  the host) lists the unique edges with their two faces; at run time the
  silhouette seen from p (front- against back-facing neighbours, and
  boundary edges) is a mask over all edges, each edge's projection is
  clipped to the convex light polygon in closed form (_clip_interval),
  and the boundary integral runs over the clipped span. Every edge is one
  row of an (E, S, 3) batch (goblin_tpu's vmap over edges).

The derivatives of the projection (goblin_tpu's jax.jvp) are written out
in closed form. Tensors go on p's device, the card where p is not a
tensor. One occluder mesh; an edge that another object shadows is not
modelled.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import vecmath as vm


def _on(p, *xs):
    """p and xs as float32 tensors on p's device (the card where p is not
    a tensor)."""
    dev = p.device if isinstance(p, torch.Tensor) else torch.device("cuda")
    return [torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor)
                            else x, dtype=torch.float32, device=dev)
            for x in (p, *xs)]


def _project_to_plane(p, e, plane_p, n_l):
    """Project e from center p onto the plane (plane_p, n_l)."""
    denom = vm.dot(e - p, n_l)
    tau = vm.dot(plane_p - p, n_l) / denom
    return p + tau[..., None] * (e - p)


def _project_jvp(p, e, plane_p, n_l, de):
    """_project_to_plane at e and its derivative along de (jax.jvp's
    rules: d(a / b) = -a db / b^2, d(tau q) = dtau q + tau dq)."""
    q = e - p
    denom = vm.dot(q, n_l)
    num = vm.dot(plane_p - p, n_l)
    tau = num / denom
    dtau = (-vm.dot(de, n_l) * num) * denom ** -2
    return (p + tau[..., None] * q,
            dtau[..., None] * q + tau[..., None] * de)


def _g(p, ns, albedo, n_l, Le, y):
    """Integrand of the area-form next-event integral at light points y."""
    to_y = y - p
    r2 = torch.clamp(vm.dot(to_y, to_y), min=1e-12)
    w = to_y / torch.sqrt(r2)[..., None]
    cos_p = torch.clamp(vm.dot(ns, w), min=0.0)
    cos_l = torch.clamp(vm.dot(n_l, -w), min=0.0)
    return (albedo / np.pi) * Le * (cos_p * cos_l / r2)[..., None]


def _edge_terms(p, ns, albedo, plane_p, n_l, Le, a, b, va, vb, s):
    """-mean over s of (v x T) . n_l g(y) for edges a -> b (E, 3) whose
    ends move at va, vb, at parameters s (E, S) -> (E, 3)."""
    e_pts = a[:, None] * (1.0 - s[..., None]) + b[:, None] * s[..., None]
    de_ds = (b - a)[:, None].expand_as(e_pts)
    dth = va[:, None] * (1.0 - s[..., None]) + vb[:, None] * s[..., None]
    y, T = _project_jvp(p, e_pts, plane_p, n_l, de_ds)
    _, v = _project_jvp(p, e_pts, plane_p, n_l, dth)
    sweep = vm.dot(vm.cross(v, T), n_l.expand_as(T))
    g = _g(p, ns, albedo, n_l, Le, y)
    return -(sweep[..., None] * g).mean(dim=1)


def direct_light_boundary_grad(p, ns, albedo, light_p, n_l, Le, occ_tri,
                               u_dir, n_samples: int = 64):
    """Boundary term of d/dth L_direct(p) for an occluder triangle
    translating along u_dir (th = signed distance along u_dir).

    p, ns: (3,) shading point and normal (Lambert albedo (3,)); light_p,
    n_l, Le: a point on the light's plane, its normal, its radiance;
    occ_tri: (3, 3) the occluder's vertices. Returns (3,) dL/dth a
    channel, on p's device."""
    p, ns, albedo, light_p, n_l, Le, q, u = _on(
        p, ns, albedo, light_p, n_l, Le, occ_tri, u_dir)
    # orient the projected polygon counter-clockwise about n_l, so that
    # (T x n_l) points outward
    y_v = _project_to_plane(p.expand(3, 3), q, light_p.expand(3, 3),
                            n_l.expand(3, 3))
    signed2 = vm.dot(vm.cross(y_v[1] - y_v[0], y_v[2] - y_v[0]), n_l)
    order = torch.where(signed2 < 0.0,
                        torch.tensor([0, 2, 1], device=p.device),
                        torch.tensor([0, 1, 2], device=p.device))
    qo = q[order]
    a, b = qo, qo[[1, 2, 0]]
    s = ((torch.arange(n_samples, dtype=torch.float32, device=p.device)
          + 0.5) / n_samples).expand(3, n_samples)
    uu = u.expand(3, 3)
    terms = _edge_terms(p, ns, albedo, light_p, n_l, Le, a, b, uu, uu, s)
    return terms[0] + terms[1] + terms[2]


def build_edge_adjacency(faces):
    """Unique edges of a triangle mesh, on the host.

    faces: (F, 3) int vertex ids. Returns a dict of numpy int32 arrays:
    ev0, ev1 (E,) the edge's vertex ids (ev0 < ev1); ef_l, ef_r (E,) its
    two faces (ef_r = -1 on a boundary edge)."""
    faces = np.asarray(faces)
    F = faces.shape[0]
    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]],
                        faces[:, [2, 0]]])
    face_of = np.repeat(np.arange(F)[None, :], 3, 0).reshape(-1)
    key = np.sort(e, axis=1)
    order = np.lexsort((key[:, 1], key[:, 0]))
    ks = key[order]
    fs = face_of[order]
    uniq = np.ones(ks.shape[0], bool)
    uniq[1:] = (ks[1:] != ks[:-1]).any(axis=1)
    starts = np.flatnonzero(uniq)
    counts = np.diff(np.append(starts, ks.shape[0]))
    ef_r = np.where(counts > 1, fs[np.minimum(starts + 1, ks.shape[0] - 1)],
                    -1)
    return {"ev0": ks[starts, 0].astype(np.int32),
            "ev1": ks[starts, 1].astype(np.int32),
            "ef_l": fs[starts].astype(np.int32),
            "ef_r": ef_r.astype(np.int32)}


def _clip_interval(p, a, b, light_poly, n_l, k_plane):
    """The s-interval [s0, s1] of edges e(s) = a + s (b - a) ((E, 3) ends)
    whose projection from p lies inside the convex polygon light_poly
    ((L, 3), counter-clockwise about n_l) -> (s0, s1, ok), each (E,).

    The projection is y(s) = p + tau(s) (e(s) - p), tau = k / den(s) with
    den linear in s. A half-plane constraint dot(y - q_i, m_i) >= 0 has a
    numerator linear in s (den dot(p - q, m) + k dot(e(s) - p, m)), and den
    keeps one sign for an occluder between p and the light, so each
    half-plane clips the interval in closed form."""
    L = light_poly.shape[0]
    den_a = vm.dot(a - p, n_l)
    den_b = vm.dot(b - p, n_l)
    sgn = torch.sign(den_a + 1e-30)
    s0 = torch.zeros_like(den_a)
    s1 = torch.ones_like(den_a)
    ok = torch.ones_like(den_a, dtype=torch.bool)
    for i in range(L):
        q = light_poly[i]
        q2 = light_poly[(i + 1) % L]
        m = vm.cross(n_l, q2 - q)  # inward normal of the polygon's edge
        ma = vm.dot(a - p, m)
        mb = vm.dot(b - p, m)
        c0 = vm.dot(p - q, m)
        B = (c0 * den_a + k_plane * ma) * sgn
        A = (c0 * (den_b - den_a) + k_plane * (mb - ma)) * sgn
        # constraint A s + B >= 0 on [s0, s1]
        flat = A.abs() < 1e-20
        root = -B / torch.where(flat, 1e-20, A)
        s0 = torch.where(A > 0.0, torch.maximum(s0, root), s0)
        s1 = torch.where(A < 0.0, torch.minimum(s1, root), s1)
        ok = ok & torch.where(flat, B >= 0.0, True)
    return s0, s1, ok & (s1 > s0)


def mesh_boundary_grad(p, ns, albedo, light_poly, n_l, Le, verts, faces,
                       adj, vel, n_samples: int = 32):
    """Boundary term dL/dth at shading point p for a mesh occluder whose
    vertices move at vel ((V, 3) = dverts/dth).

    light_poly: (L, 3) convex light polygon, counter-clockwise about n_l;
    verts (V, 3), faces (F, 3), adj from build_edge_adjacency. Returns (3,)
    dL/dth on p's device."""
    p, ns, albedo, n_l, Le, verts, vel, light_poly = _on(
        p, ns, albedo, n_l, Le, verts, vel, light_poly)
    dev = p.device
    faces = torch.as_tensor(np.asarray(faces), dtype=torch.long, device=dev)
    ev0, ev1, ef_l, ef_r = (
        torch.as_tensor(np.asarray(adj[k]), dtype=torch.long, device=dev)
        for k in ("ev0", "ev1", "ef_l", "ef_r"))
    plane_p = light_poly[0]
    k_plane = vm.dot(plane_p - p, n_l)

    fv = verts[faces]  # (F, 3, 3)
    fn = vm.cross(fv[:, 1] - fv[:, 0], fv[:, 2] - fv[:, 0])
    fc = fv.mean(dim=1)
    front = vm.dot(fn, p - fc) > 0.0  # (F,)
    f_l = front[ef_l]
    f_r = torch.where(ef_r >= 0, front[torch.clamp(ef_r, min=0)], ~f_l)
    silhouette = f_l != f_r  # (E,)

    a, b = verts[ev0], verts[ev1]
    va, vb = vel[ev0], vel[ev1]
    # orient each silhouette edge so that the front face lies on its left:
    # the edge runs forward where its left face is the front face and uses
    # it forward, or is the back face and uses it backward
    fl = faces[ef_l]  # (E, 3)
    as_fwd = (((fl[:, 0] == ev0) & (fl[:, 1] == ev1))
              | ((fl[:, 1] == ev0) & (fl[:, 2] == ev1))
              | ((fl[:, 2] == ev0) & (fl[:, 0] == ev1)))
    fwd = (as_fwd == f_l)[:, None]
    aa, bb = torch.where(fwd, a, b), torch.where(fwd, b, a)
    vaa, vbb = torch.where(fwd, va, vb), torch.where(fwd, vb, va)
    # the projection keeps or flips that winding with the side of the light
    # plane: the signed area of one front face's projection says which
    f_front = torch.argmax(front.to(torch.int32))
    y_tri = _project_to_plane(p, verts[faces[f_front]], plane_p, n_l)
    ccw = vm.dot(vm.cross(y_tri[1] - y_tri[0], y_tri[2] - y_tri[0]),
                 n_l) >= 0.0
    aa, bb = torch.where(ccw, aa, bb), torch.where(ccw, bb, aa)
    vaa, vbb = torch.where(ccw, vaa, vbb), torch.where(ccw, vbb, vaa)

    s0, s1, ok = _clip_interval(p, aa, bb, light_poly, n_l, k_plane)
    span = torch.clamp(s1 - s0, min=0.0)
    s = s0[:, None] + ((torch.arange(n_samples, dtype=torch.float32,
                                     device=dev) + 0.5)
                       / n_samples)[None, :] * span[:, None]
    terms = _edge_terms(p, ns, albedo, plane_p, n_l, Le, aa, bb, vaa, vbb, s)
    use = (silhouette & ok)[:, None]
    return torch.where(use, terms * span[:, None], 0.0).sum(dim=0)
