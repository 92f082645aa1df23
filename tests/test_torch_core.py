"""The rest of core/ and the geometry oracles in goblin_tpu_torch against
goblin_tpu: vecmath's quaternions, transforms and small helpers, the
permuted radical inverse, the primes and the hemisphere pdf, Moller-Trumbore,
the slab test, the brute-force oracles, the sphere mesh and the OBJ writer.

tests/test_vecmath.py and test_sampling.py's permuted radical inverse tests
are mirrored on the port; every new function then meets goblin_tpu's on the
same seeded numpy inputs (float32, rtol 1e-6 / atol 1e-6 unless a test
says otherwise), and the brute-force closest hit meets the port's BVH
traversal (trace_plain) on a sphere mesh.
"""

import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goblin_tpu.core import sampling as jsp
from goblin_tpu.core import vecmath as jvm
from goblin_tpu.geometry import intersect as jisect
from goblin_tpu.geometry import mesh as jmesh
from goblin_tpu_torch.accel import bvh as tbvh
from goblin_tpu_torch.core import sampling as sp
from goblin_tpu_torch.core import vecmath as vm
from goblin_tpu_torch.geometry import intersect as isect
from goblin_tpu_torch.geometry import mesh as tmesh
from goblin_tpu_torch.ops import trace as tt

TOL = dict(rtol=1e-6, atol=1e-6)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------------
# tests/test_vecmath.py on the port
# ---------------------------------------------------------------------------


def test_normalize_and_dot():
    v = torch.tensor([[3.0, 0.0, 4.0], [0.0, 2.0, 0.0]])
    n = vm.normalize(v)
    np.testing.assert_allclose(vm.length(n), [1.0, 1.0], rtol=1e-6)
    np.testing.assert_allclose(vm.dot(v, v), [25.0, 4.0], rtol=1e-6)


def test_coordinate_system_orthonormal():
    rng = np.random.default_rng(0)
    a1 = vm.normalize(_t(rng.normal(size=(64, 3)).astype(np.float32)))
    a2, a3 = vm.coordinate_system(a1)
    for a, b in ((a1, a2), (a1, a3), (a2, a3)):
        np.testing.assert_allclose(vm.dot(a, b), np.zeros(64), atol=1e-5)
    np.testing.assert_allclose(vm.length(a2), np.ones(64), atol=1e-5)
    np.testing.assert_allclose(vm.cross(a1, a2), a3, atol=1e-5)


def test_quat_rotate_matches_matrix():
    rng = np.random.default_rng(1)
    axis = vm.normalize(_t(rng.normal(size=(8, 3)).astype(np.float32)))
    angle = _t(rng.uniform(-np.pi, np.pi, size=(8,)).astype(np.float32))
    q = vm.quat_from_axis_angle(axis, angle)
    v = _t(rng.normal(size=(8, 3)).astype(np.float32))
    rm = torch.einsum("nij,nj->ni", vm.quat_to_matrix(q), v)
    np.testing.assert_allclose(vm.quat_rotate(q, v), rm, atol=1e-5)


def test_quat_mul_composition():
    qx = vm.quat_from_axis_angle([1.0, 0.0, 0.0], 0.3)
    qy = vm.quat_from_axis_angle([0.0, 1.0, 0.0], 0.7)
    v = torch.tensor([0.2, -1.0, 0.5])
    # q = qy * qx applies qx first
    np.testing.assert_allclose(vm.quat_rotate(vm.quat_mul(qy, qx), v),
                               vm.quat_rotate(qy, vm.quat_rotate(qx, v)),
                               atol=1e-6)


def test_euler_to_quat_xyz():
    # 90 degrees about z maps +x to +y
    q = vm.euler_to_quat([0.0, 0.0, 90.0], "xyz")
    np.testing.assert_allclose(vm.quat_rotate(q, torch.tensor([1.0, 0, 0])),
                               [0.0, 1.0, 0.0], atol=1e-6)


def test_compose_matrix_trs_order():
    # scale, then rotation, then translation
    q = vm.quat_from_axis_angle([0.0, 0.0, 1.0], np.pi / 2)
    m = vm.compose_matrix([1.0, 2.0, 3.0], q, [2.0, 1.0, 1.0])
    p = vm.transform_point(m, torch.tensor([1.0, 0.0, 0.0]))
    np.testing.assert_allclose(p, [1.0, 4.0, 3.0], atol=1e-5)


def test_transform_normal_inverse_transpose():
    q = vm.quat_from_axis_angle([0.0, 0.0, 1.0], 0.4)
    m = vm.compose_matrix(torch.zeros(3), q, [2.0, 1.0, 1.0])
    t = vm.transform_vector(m, torch.tensor([1.0, 1.0, 0.0]))
    n = vm.transform_normal(vm.matrix_inverse(m),
                            torch.tensor([-1.0, 1.0, 0.0]) / math.sqrt(2))
    assert abs(float(vm.dot(t, n))) < 1e-5


def test_perspective_matrix_values():
    m = vm.perspective_lh_d3d(np.radians(60.0), 4 / 3, 0.1, 1000.0)
    assert m[3, 2] == 1.0
    np.testing.assert_allclose(m[1, 1], 1.0 / np.tan(np.radians(30.0)),
                               rtol=1e-6)
    np.testing.assert_allclose(m[0, 0], m[1, 1] * 3 / 4, rtol=1e-6)
    np.testing.assert_allclose(m[2, 2], 1000.0 / 999.9, rtol=1e-5)


def test_quadratic_stable():
    has, t1, t2 = vm.quadratic(*map(torch.tensor, (1.0, -5.0, 6.0)))
    assert bool(has)
    np.testing.assert_allclose([float(t1), float(t2)], [2.0, 3.0], rtol=1e-6)
    assert not bool(vm.quadratic(*map(torch.tensor, (1.0, 0.0, 1.0)))[0])


def test_solve_2x2():
    ok, x0, x1 = vm.solve_2x2(*map(torch.tensor,
                                   (2.0, 1.0, 1.0, 3.0, 5.0, 10.0)))
    assert bool(ok)
    np.testing.assert_allclose([float(x0), float(x1)], [1.0, 3.0], rtol=1e-6)


# ---------------------------------------------------------------------------
# vecmath against goblin_tpu, function by function
# ---------------------------------------------------------------------------

_RNG = np.random.default_rng(17)
V = _RNG.normal(size=(64, 3)).astype(np.float32)
W = _RNG.normal(size=(64, 3)).astype(np.float32)
Q = _RNG.normal(size=(64, 4)).astype(np.float32)
Q /= np.linalg.norm(Q, axis=-1, keepdims=True)
S = _RNG.uniform(0.5, 2.0, size=(64, 3)).astype(np.float32)
A = _RNG.uniform(-np.pi, np.pi, size=(64,)).astype(np.float32)
U = _RNG.uniform(0.0, 1.0, size=(64,)).astype(np.float32)
E = _RNG.uniform(-180.0, 180.0, size=(64, 3)).astype(np.float32)
M6 = _RNG.normal(size=(6, 64)).astype(np.float32)
V[0] = 0.0  # a zero vector for safe_normalize


def _compose(lib, t):
    return lib.compose_matrix(t(V), t(Q), t(S))


VECMATH_CASES = {
    "length": lambda lib, t: lib.length(t(V)),
    "safe_normalize": lambda lib, t: lib.safe_normalize(t(V)),
    "lerp": lambda lib, t: lib.lerp(t(U)[:, None], t(V), t(W)),
    "reflect": lambda lib, t: lib.reflect(t(V), lib.normalize(t(W))),
    "face_forward": lambda lib, t: lib.face_forward(t(V), t(W)),
    "spherical_direction": lambda lib, t: lib.spherical_direction(
        t(np.sin(A)), t(np.cos(A)), t(A * 2)),
    "quat_identity": lambda lib, t: lib.quat_identity(),
    "quat_from_axis_angle": lambda lib, t: lib.quat_from_axis_angle(
        lib.normalize(t(V[1:])), t(A[1:])),
    "quat_mul": lambda lib, t: lib.quat_mul(t(Q), t(Q[::-1].copy())),
    "quat_rotate": lambda lib, t: lib.quat_rotate(t(Q), t(W)),
    "quat_to_matrix": lambda lib, t: lib.quat_to_matrix(t(Q)),
    "euler_to_quat": lambda lib, t: lib.euler_to_quat(t(E), "yzx"),
    "euler_to_quat_unknown_order": lambda lib, t: lib.euler_to_quat(
        t(E[0]), "abc"),
    "compose_matrix": _compose,
    "transform_point": lambda lib, t: lib.transform_point(_compose(lib, t),
                                                          t(W)),
    "transform_vector": lambda lib, t: lib.transform_vector(_compose(lib, t),
                                                            t(W)),
    "transform_normal": lambda lib, t: lib.transform_normal(
        lib.matrix_inverse(_compose(lib, t)), t(W)),
    "matrix_inverse": lambda lib, t: lib.matrix_inverse(_compose(lib, t)),
    "solve_2x2": lambda lib, t: lib.solve_2x2(*(t(r) for r in M6)),
}


@pytest.mark.parametrize("name", sorted(VECMATH_CASES))
def test_vecmath_matches_goblin_tpu(name):
    fn = VECMATH_CASES[name]
    got = fn(vm, _t)
    ref = fn(jvm, jnp.asarray)
    got, ref = ((got,), (ref,)) if not isinstance(got, tuple) else (got, ref)
    for g, r in zip(got, ref):
        assert _np(g).dtype == np.asarray(r).dtype, name
        # the inverse of a random transform amplifies rounding
        tol = dict(rtol=1e-4, atol=1e-5) if "inverse" in name or (
            name == "transform_normal") else TOL
        np.testing.assert_allclose(_np(g), np.asarray(r), err_msg=name, **tol)


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------


def test_permuted_radical_inverse_identity_perm():
    ri = sp.permuted_radical_inverse(torch.tensor([1, 2, 3]), 2,
                                     torch.arange(2, dtype=torch.int32))
    np.testing.assert_allclose(ri, [0.5, 0.25, 0.75], atol=1e-5)


def test_permuted_radical_inverse_uniform():
    # any fixed permutation still gives a uniform low-discrepancy sequence
    ri = sp.permuted_radical_inverse(torch.arange(1, 3 ** 5), 3,
                                     torch.tensor([1, 2, 0]))
    xs = np.sort(ri.numpy())
    assert xs.min() >= 0 and xs.max() < 1
    assert np.diff(xs).max() < 0.03


@pytest.mark.parametrize("base", [2, 3, 5, 13, 31])
def test_permuted_radical_inverse_bit_equal(base):
    """Every uint32 range: bit for bit goblin_tpu's, whose loop XLA
    contracts into fused multiply-adds."""
    rng = np.random.default_rng(base)
    perm = rng.permutation(base).astype(np.int32)
    n = rng.integers(0, 2 ** 32, size=4096, dtype=np.uint64).astype(np.uint32)
    ref = np.asarray(jsp.permuted_radical_inverse(jnp.asarray(n), base,
                                                  jnp.asarray(perm)))
    got = sp.permuted_radical_inverse(_t(n.astype(np.int64)), base, _t(perm))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_primes_and_hemisphere_pdf():
    assert sp.primes(80) == jsp.primes(80)
    assert sp.primes(5) == [2, 3, 5, 7, 11]
    assert sp.uniform_hemisphere_pdf() == jsp.uniform_hemisphere_pdf()
    # the uniform hemisphere warp's density integrates to 1
    d = sp.uniform_sample_hemisphere(torch.rand(1), torch.rand(1))
    assert float(d[0, 2]) >= 0.0
    assert sp.uniform_hemisphere_pdf() * 2 * math.pi == pytest.approx(1.0)


# ---------------------------------------------------------------------------
# geometry: Moller-Trumbore, the slab test, the brute-force oracles
# ---------------------------------------------------------------------------


def _triangles_and_rays(seed=3, n_tri=96, n_rays=256):
    rng = np.random.default_rng(seed)
    p0 = rng.normal(size=(n_tri, 3)).astype(np.float32)
    p1 = p0 + rng.normal(size=(n_tri, 3)).astype(np.float32)
    p2 = p0 + rng.normal(size=(n_tri, 3)).astype(np.float32)
    o = (rng.normal(size=(n_rays, 3)) * 3).astype(np.float32)
    tgt = rng.normal(size=(n_rays, 3)).astype(np.float32) * 0.7
    d = tgt - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    mint = np.full(n_rays, 1e-4, np.float32)
    maxt = np.full(n_rays, 1e30, np.float32)
    maxt[::5] = 3.0  # short segments
    return p0, p1 - p0, p2 - p0, o, d, mint, maxt


def test_moller_trumbore_basic():
    hit, t, b1, b2 = isect.moller_trumbore(
        torch.tensor([0.2, 0.2, -1.0]), torch.tensor([0.0, 0.0, 1.0]),
        torch.zeros(3), torch.tensor([1.0, 0, 0]), torch.tensor([0.0, 1, 0]),
        0.0, 1e30)
    assert bool(hit)
    np.testing.assert_allclose([float(t), float(b1), float(b2)],
                               [1.0, 0.2, 0.2], atol=1e-6)
    assert not bool(isect.moller_trumbore(
        torch.tensor([0.9, 0.9, -1.0]), torch.tensor([0.0, 0.0, 1.0]),
        torch.zeros(3), torch.tensor([1.0, 0, 0]), torch.tensor([0.0, 1, 0]),
        0.0, 1e30)[0])


def test_moller_trumbore_matches_goblin_tpu():
    """Ray i against triangle i, aimed near its centroid."""
    v0, e1, e2, o, _, mint, maxt = _triangles_and_rays(n_tri=256)
    rng = np.random.default_rng(4)
    d = v0 + (e1 + e2) / 3 + rng.normal(size=v0.shape).astype(np.float32) \
        * 0.3 - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    args = (o, d, v0, e1, e2, mint, maxt)
    got = isect.moller_trumbore(*map(_t, args))
    ref = jisect.moller_trumbore(*map(jnp.asarray, args))
    assert np.asarray(ref[0]).sum() > 10
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    for g, r in zip(got[1:], ref[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-5)


def test_brute_force_oracles_match_goblin_tpu():
    v0, e1, e2, o, d, mint, maxt = _triangles_and_rays()
    args = (o, d, v0, e1, e2, mint, maxt)
    got = isect.brute_force_closest(*map(_t, args))
    ref = [np.asarray(x) for x in jisect.brute_force_closest(
        *map(jnp.asarray, args))]
    h = ref[0]
    assert 20 < h.sum() < len(h)
    np.testing.assert_array_equal(got[0].numpy(), h)
    np.testing.assert_allclose(got[1].numpy()[h], ref[1][h], rtol=1e-5)
    assert (got[2].numpy()[h] == ref[2][h]).mean() >= 0.99
    for g, r in zip(got[3:], ref[3:]):
        np.testing.assert_allclose(g.numpy()[h], r[h], atol=1e-5)
    occ = isect.brute_force_occluded(*map(_t, args)).numpy()
    np.testing.assert_array_equal(
        occ, np.asarray(jisect.brute_force_occluded(*map(jnp.asarray, args))))
    assert (occ >= h).all()


def test_aabb_slab():
    o = torch.tensor([[0.0, 0.0, -5.0], [3.0, 0.0, -5.0]])
    d = torch.tensor([[0.0, 0.0, 1.0]] * 2)
    inv_d = 1.0 / torch.where(d == 0, 1e-30, d)
    hit, tn = isect.intersect_aabb(o, inv_d, -torch.ones(3), torch.ones(3),
                                   0.0, 1e30)
    assert bool(hit[0]) and not bool(hit[1])
    np.testing.assert_allclose(float(tn[0]), 4.0, rtol=1e-6)


def test_aabb_slab_matches_goblin_tpu():
    rng = np.random.default_rng(5)
    _, _, _, o, d, mint, maxt = _triangles_and_rays(n_rays=512)
    inv_d = (1.0 / np.where(d == 0, 1e-30, d)).astype(np.float32)
    lo = rng.normal(size=(512, 3)).astype(np.float32)
    hi = lo + rng.uniform(0.1, 2.0, size=(512, 3)).astype(np.float32)
    args = (o, inv_d, lo, hi, mint, maxt)
    got = isect.intersect_aabb(*map(_t, args))
    ref = jisect.intersect_aabb(*map(jnp.asarray, args))
    assert 10 < np.asarray(ref[0]).sum() < 512
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))


def test_brute_force_closest_matches_the_traversal():
    """A 16 x 32 UV sphere's soup through the port's BVH8 build and
    trace_plain, against the dense oracle on the same (leaf-ordered)
    triangle rows: hits equal, t within 1e-5 rel, the same triangle."""
    mesh = tmesh.make_sphere_mesh(1.0, 16, 32)
    p = mesh.positions[mesh.faces]
    tree = tbvh.align_leaves(tbvh.build_bvh(p[:, 0], p[:, 1], p[:, 2],
                                            max_leaf=8), align=8)
    safe = np.where(tree.order < 0, 0, tree.order)
    soup = np.concatenate([p[safe, 0], p[safe, 1] - p[safe, 0],
                           p[safe, 2] - p[safe, 0]], axis=-1)
    soup[tree.order < 0] = 0.0
    nb, nc, _ = tt.collapse8(tree.bounds, tree.meta)
    scene = {"bvh8_bounds": _t(nb), "bvh8_child": _t(nc),
             "tri_rows": _t(tt.tri_rows(soup.astype(np.float32)))}
    rng = np.random.default_rng(9)
    o = (rng.normal(size=(512, 3)) * 3).astype(np.float32)
    d = (rng.normal(size=(512, 3)) * 0.5).astype(np.float32) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    mint = np.full(512, 1e-4, np.float32)
    maxt = np.full(512, 1e30, np.float32)
    res = tt.trace_plain(scene, *map(_t, (o, d, mint, maxt)))
    rows = scene["tri_rows"]
    ref = isect.brute_force_closest(_t(o), _t(d), rows[:, 0:3], rows[:, 3:6],
                                    rows[:, 6:9], _t(mint), _t(maxt))
    h = ref[0].numpy()
    assert 100 < h.sum() < 512
    np.testing.assert_array_equal(res.hit.numpy(), h)
    np.testing.assert_allclose(res.t.numpy()[h], ref[1].numpy()[h], rtol=1e-5)
    assert (res.tri.numpy()[h] == ref[2].numpy()[h]).mean() >= 0.99


# ---------------------------------------------------------------------------
# the sphere mesh and the OBJ writer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("size", [(1.0, 8, 16), (0.5, 3, 5), (2.0, 2, 3)])
def test_sphere_mesh_equals_goblin_tpu(size):
    got, ref = tmesh.make_sphere_mesh(*size), jmesh.make_sphere_mesh(*size)
    for key in ("positions", "normals", "uvs", "faces"):
        np.testing.assert_array_equal(getattr(got, key), getattr(ref, key))
    assert got.num_faces == ref.num_faces


def test_write_obj_round_trip(tmp_path):
    """tests/test_geometry.py's round trip on the port, and the written file
    byte for byte goblin_tpu's."""
    mesh = tmesh.make_sphere_mesh(1.0, 8, 16)
    path = os.path.join(tmp_path, "sphere.obj")
    tmesh.write_obj(path, mesh)
    loaded = tmesh.load_obj(path)
    assert loaded.num_faces == mesh.num_faces
    np.testing.assert_allclose(loaded.positions[loaded.faces],
                               mesh.positions[mesh.faces], atol=1e-5)
    assert loaded.has_normals and loaded.has_uvs
    ref = os.path.join(tmp_path, "ref.obj")
    jmesh.write_obj(ref, jmesh.make_sphere_mesh(1.0, 8, 16))
    with open(path) as a, open(ref) as b:
        assert a.read() == b.read()
    mesh.normals = mesh.uvs = None  # the "f v v v" form
    tmesh.write_obj(path, mesh)
    bare = tmesh.load_obj(path)
    assert not bare.has_normals and not bare.has_uvs
    assert bare.num_faces == mesh.num_faces
