"""Edge-sampled visibility gradients in goblin_tpu_torch
(integrators/edge_grad.py): the five tests of tests/test_edge_grad.py
mirrored on the port, each function against goblin_tpu's on the same
inputs (adjacency equal, gradients within rtol 1e-5), and the mesh term on
the card against the CPU.

The module imports neither JAX nor goblin_tpu at its top, so that its
CUDA test runs on a machine without them:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_edge_grad.py
"""

import json

import numpy as np
import pytest
import torch

from goblin_tpu_torch.integrators import edge_grad as eg

P = np.float32([0.0, 0.0, 0.0])
NS = np.float32([0.0, 1.0, 0.0])
ALBEDO = np.float32([0.8, 0.6, 0.4])
LIGHT_P = np.float32([0.0, 2.0, 0.0])  # plane y = 2
N_L = np.float32([0.0, -1.0, 0.0])
LE = np.float32([5.0, 5.0, 5.0])
U_X = np.float32([1.0, 0.0, 0.0])
# the light spans [-1, 1]^2 at y = 2, counter-clockwise about N_L
LIGHT_POLY = np.float32([[-1.0, 2.0, -1.0], [1.0, 2.0, -1.0],
                         [1.0, 2.0, 1.0], [-1.0, 2.0, 1.0]])
TET_FACES = np.int32([[0, 2, 1], [0, 1, 3], [1, 2, 3], [2, 0, 3]])
SWEEP = (-0.05, 0.0, 0.12, 0.3)


def tet(theta):
    """tests/test_edge_grad.py's closed tetrahedron, moved theta along +x:
    its shadow straddles the light's +x edge."""
    return np.float32([[0.15 + theta, 1.0, 0.00], [0.55 + theta, 1.0, 0.25],
                       [0.40 + theta, 1.0, -0.30], [0.35 + theta, 1.25, 0.00]])


def _t(a, device="cpu"):
    return torch.as_tensor(np.asarray(a), device=device)


def mesh_grad(theta, device="cpu", n_samples=128):
    v = tet(theta)
    return eg.mesh_boundary_grad(
        _t(P, device), NS, ALBEDO, LIGHT_POLY, N_L, LE, v, TET_FACES,
        eg.build_edge_adjacency(TET_FACES),
        np.tile(U_X, (v.shape[0], 1)), n_samples=n_samples)


def _ref():
    """tests/test_edge_grad.py: its oracles, and goblin_tpu under them."""
    import test_edge_grad

    return test_edge_grad


def _tri_grad(tri, n_samples):
    return eg.direct_light_boundary_grad(
        _t(P), NS, ALBEDO, LIGHT_P, N_L, LE, tri, U_X,
        n_samples=n_samples).numpy()


# ---------------------------------------------------------------------------
# tests/test_edge_grad.py, mirrored
# ---------------------------------------------------------------------------


def test_boundary_grad_matches_dense_fd():
    """FD of the exact blocked-region integral: dL/dth = -d/dth int_B g."""
    ref = _ref()
    h = 2e-3
    fd = -(ref._int_blocked(h) - ref._int_blocked(-h)) / (2 * h)
    est = _tri_grad(ref._occ(0.0), 128)
    assert np.all(np.abs(fd) > 1e-4)  # the boundary term is nonzero
    np.testing.assert_allclose(est, fd, rtol=0.02)


def test_boundary_grad_orientation_flip():
    """The vertex order does not change the result."""
    tri = _ref()._occ(0.0)
    np.testing.assert_allclose(_tri_grad(tri, 64),
                               _tri_grad(tri[::-1].copy(), 64), rtol=1e-5)


def _occluder_scene(tmp_path, theta):
    """tests/test_edge_grad.py's renderer scene: a receiver floor framed
    alone, the occluder triangle at y = 1, a downward quad light at y = 2."""
    tri = _ref()._occ(theta)
    quad = ("v -1 0 1\nv 1 0 1\nv -1 0 -1\nv 1 0 -1\n"
            "vn 0 1 0\nf 1//1 2//1 3//1\nf 3//1 2//1 4//1\n")
    (tmp_path / "occ.obj").write_text(
        "".join(f"v {v[0]} {v[1]} {v[2]}\n" for v in tri)
        + "vn 0 1 0\nf 1//1 2//1 3//1\n")
    (tmp_path / "quad.obj").write_text(quad)
    (tmp_path / "floor.obj").write_text(quad)
    doc = {
        "render_setting": {"render_method": "path_tracing",
                           "sample_per_pixel": 1, "max_ray_depth": 2},
        "camera": {"position": [0.1, 0.45, -0.55], "euler": [40, 0, 0],
                   "rotation_order": "xyz", "fov": 45.0,
                   "film": {"resolution": [12, 12]},
                   "filter": {"type": "box", "width": [0.5, 0.5]}},
        "geometries": [
            {"name": "floor", "type": "mesh", "file": "floor.obj"},
            {"name": "quad", "type": "mesh", "file": "quad.obj"},
            {"name": "occ", "type": "mesh", "file": "occ.obj"}],
        "textures": [
            {"format": "color", "name": "alb", "type": "constant",
             "color": [float(v) for v in ALBEDO]},
            {"format": "color", "name": "dark", "type": "constant",
             "color": [0.0, 0.0, 0.0]}],
        "materials": [{"name": "recv", "type": "lambert", "Kd": "alb"},
                      {"name": "blk", "type": "lambert", "Kd": "dark"}],
        "primitives": [
            {"type": "model", "name": "fm", "geometry": "floor",
             "material": "recv"},
            {"type": "instance", "name": "fi", "model": "fm",
             "scale": [0.5, 0.5, 0.5]},
            {"type": "model", "name": "om", "geometry": "occ",
             "material": "blk"},
            {"type": "instance", "name": "oi", "model": "om"}],
        "lights": [{"name": "panel", "type": "area",
                    "radiance": [float(v) for v in LE], "geometry": "quad",
                    "position": [0.0, 2.0, 0.0], "euler": [180.0, 0.0, 0.0]}],
    }
    path = tmp_path / "scene.json"
    path.write_text(json.dumps(doc))
    return str(path)


@pytest.mark.parametrize("wide", [8, 1])
def test_boundary_location_matches_renderer_occlusion(tmp_path, wide):
    """The boundary the estimator integrates along (the projected
    silhouette) is where the port's occluded() flips: points just inside
    the projected triangle are occluded, just outside lit."""
    from goblin_tpu_torch.scene import intersect as scn
    from goblin_tpu_torch.scene.loader import load_scene

    scene, meta = load_scene(_occluder_scene(tmp_path, 0.0), device="cpu",
                             trace_wide=wide)
    p0 = torch.zeros((1, 3))
    tri_y = _ref()._proj_tri(0.0)
    centroid = tri_y.mean(axis=0)
    for a, b in ((0, 1), (1, 2), (2, 0)):
        mid = 0.5 * (tri_y[a] + tri_y[b])
        inward = (centroid - mid) / np.linalg.norm(centroid - mid)
        for sgn, expect in ((+1.0, True), (-1.0, False)):
            y = mid + sgn * 0.01 * inward
            dist = float(np.linalg.norm(y))
            d = torch.as_tensor((y / dist)[None, :], dtype=torch.float32)
            occ = scn.occluded(scene, meta, p0, d, torch.tensor([1e-3]),
                               torch.tensor([dist - 1e-3]))
            assert bool(occ[0]) == expect, (a, b, sgn)


def test_mesh_boundary_grad_vs_fd_with_clipping():
    """The tetrahedron's shadow starts inside the light and crosses its +x
    edge: the estimate against FD of dense quadrature within 8%."""
    ref = _ref()
    np.testing.assert_array_equal(ref._tet(0.1)[0], tet(0.1))
    np.testing.assert_array_equal(ref._tet(0.1)[1], TET_FACES)
    for theta in SWEEP:
        grad = mesh_grad(theta).numpy()
        h = 5e-3
        fd = (ref._L_direct_mesh(theta + h)
              - ref._L_direct_mesh(theta - h)) / (2 * h)
        err = np.abs(grad - fd).max() / max(np.abs(fd).max(), 1e-4)
        assert err < 0.08, (theta, grad, fd)


def test_mesh_boundary_grad_zero_when_shadow_outside():
    """A shadow wholly off the light: the clip rejects every edge."""
    grad = mesh_grad(3.0, n_samples=32).numpy()
    assert np.abs(grad).max() < 1e-5, grad


# ---------------------------------------------------------------------------
# Against goblin_tpu on the same inputs
# ---------------------------------------------------------------------------


def _jnp(*xs):
    import jax.numpy as jnp

    return [jnp.asarray(x) for x in xs]


@pytest.mark.parametrize("theta", [0.0, 0.07])
def test_direct_light_boundary_grad_matches_goblin_tpu(theta):
    from goblin_tpu.integrators import edge_grad as jeg

    tri = _ref()._occ(theta)
    for t in (tri, tri[::-1].copy()):
        want = np.asarray(jeg.direct_light_boundary_grad(
            *_jnp(P, NS, ALBEDO, LIGHT_P, N_L, LE, t, U_X), n_samples=64))
        np.testing.assert_allclose(_tri_grad(t, 64), want, rtol=1e-5,
                                   atol=1e-9)


def _grid_faces(n):
    """An n x n grid of quads, two triangles each: a mesh with boundary
    edges and interior ones."""
    ids = np.arange((n + 1) * (n + 1)).reshape(n + 1, n + 1)
    a, b = ids[:-1, :-1].ravel(), ids[:-1, 1:].ravel()
    c, d = ids[1:, :-1].ravel(), ids[1:, 1:].ravel()
    return np.concatenate([np.stack([a, b, d], 1),
                           np.stack([a, d, c], 1)]).astype(np.int32)


@pytest.mark.parametrize("faces", [TET_FACES, _grid_faces(5)],
                         ids=["tetrahedron", "grid"])
def test_build_edge_adjacency_matches_goblin_tpu(faces):
    from goblin_tpu.integrators import edge_grad as jeg

    got, want = eg.build_edge_adjacency(faces), jeg.build_edge_adjacency(faces)
    assert set(got) == set(want) == {"ev0", "ev1", "ef_l", "ef_r"}
    for k in want:
        assert got[k].dtype == want[k].dtype == np.int32, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    n_edges = 6 if faces is TET_FACES else 5 * 6 * 2 + 25
    assert got["ev0"].size == n_edges
    assert (got["ef_r"] == -1).sum() == (0 if faces is TET_FACES else 20)


def test_clip_interval_matches_goblin_tpu():
    from goblin_tpu.integrators import edge_grad as jeg

    v = tet(0.3)
    adj = eg.build_edge_adjacency(TET_FACES)
    a, b = v[adj["ev0"]], v[adj["ev1"]]
    k = float(np.dot(LIGHT_POLY[0] - P, N_L))
    got = eg._clip_interval(_t(P), _t(a), _t(b), _t(LIGHT_POLY), _t(N_L), k)
    for i in range(a.shape[0]):
        want = jeg._clip_interval(*_jnp(P, a[i], b[i], LIGHT_POLY, N_L), k)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g[i].numpy(), np.asarray(w),
                                       rtol=1e-5, atol=1e-7)


def test_mesh_boundary_grad_matches_goblin_tpu():
    from goblin_tpu.integrators import edge_grad as jeg

    for theta in SWEEP + (3.0,):
        v = tet(theta)
        vel = np.tile(U_X, (v.shape[0], 1))
        want = np.asarray(jeg.mesh_boundary_grad(
            *_jnp(P, NS, ALBEDO), LIGHT_POLY, *_jnp(N_L, LE), v, TET_FACES,
            jeg.build_edge_adjacency(TET_FACES), vel, n_samples=128))
        np.testing.assert_allclose(mesh_grad(theta).numpy(), want,
                                   rtol=1e-5, atol=1e-9)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_mesh_boundary_grad_on_the_card():
    """The tetrahedron sweep on the card against the CPU, within 1e-5
    rel; the result stays on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for theta in SWEEP:
        got = mesh_grad(theta, device="cuda")
        assert got.device.type == "cuda"
        np.testing.assert_allclose(got.cpu().numpy(), mesh_grad(theta).numpy(),
                                   rtol=1e-5, atol=1e-9)


def test_tensors_go_on_the_callers_device():
    g = mesh_grad(0.0)
    assert g.device.type == "cpu" and g.shape == (3,)
