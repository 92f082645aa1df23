"""Scene bake: host-side scene description -> flat tensors on one device
(port of goblin_tpu/scene/bake.py at its production trace settings).

Instances are flattened to world space (normals by the inverse
transpose) and one BVH is built over the whole triangle soup: binned SAH
with leaves of at most 32 triangles, leaf starts padded to multiples of 8
(padding slots become zero-area triangles that never hit). The trace width
picks the tables the trace kernel walks (goblin_tpu's GOBLIN_WIDE, here an
argument): 8, the default, collapses the tree to the 8-wide layout;
1 keeps the binary tree in pack_scene's per-node layout.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..accel.bvh import align_leaves, build_bvh
from ..camera.camera import CameraSpec
from ..integrators import materials as mats
from ..lights.lights import DELTA_LIGHTS, LightsBuild, bake_lights
from ..ops.trace import (BIN_STACK, bin_depth, bin_stack_bound, bin_tables,
                         check_wide_depth, collapse8, tri_rows)
from ..shading.bsdf import MAT_LAMBERT
from ..shading.textures import TexSpec, TextureSystem

MAX_LEAF = 32
TRACE_WIDTHS = (1, 8)


@dataclass
class MatSpec:
    """Host-side material: type id, texture ids and index of refraction."""

    kind: int = MAT_LAMBERT
    tex_c0: int = 0  # Kd / Kr
    tex_c1: int = 0  # Kt
    eta: float = 1.5


@dataclass
class InstanceRecord:
    mesh: object  # geometry.mesh.TriangleMesh
    material: int  # material row
    to_world: np.ndarray  # (4, 4)


@dataclass
class SceneMeta:
    camera: CameraSpec = None
    settings: dict = field(default_factory=dict)
    n_tris: int = 0
    n_nodes: int = 0  # binary BVH nodes
    # trace width: 8 walks the BVH8 tables (ops.trace.trace), 1 the binary
    # ones (ops.trace.trace_bin)
    trace_wide: int = 8
    n_wide_nodes: int = 0  # BVH8 nodes (width 8)
    wide_depth: int = 0  # BVH8 nodes on the longest root-to-leaf path
    bin_depth: int = 0  # binary inner nodes on the longest path (width 1)
    n_materials: int = 0
    n_lights: int = 0
    texture_system: TextureSystem = None
    max_leaf: int = MAX_LEAF
    # every light is a delta light: a BSDF ray never hits an emitter, so
    # the path tracer skips the last bounce's continuation trace
    all_delta_lights: bool = False
    # material kinds present (the BSDF prunes the branches of absent ones)
    material_kinds: tuple = ()
    world_bounds: tuple = ((0.0, 0.0, 0.0), (1.0, 1.0, 1.0))


def _transform_mesh(mesh, m):
    """Apply a 4x4 to a TriangleMesh -> (v (V, 3), n (V, 3) | None, uv)."""
    v = mesh.positions @ m[:3, :3].T + m[:3, 3]
    n = None
    if mesh.normals is not None:
        inv_t = np.linalg.inv(m[:3, :3]).T
        n = mesh.normals @ inv_t.T
        n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-20)
        n = n.astype(np.float32)
    return v.astype(np.float32), n, mesh.uvs


class SceneBuilder:
    """Accumulates world-space meshes, materials and lights, then bakes."""

    def __init__(self):
        self.instances: list[InstanceRecord] = []
        self.materials: list[MatSpec] = [MatSpec()]  # row 0: error magenta
        self.color_textures: list[TexSpec] = [
            TexSpec(value=np.array([1.0, 0.0, 1.0], np.float32))
        ]
        self.lights = LightsBuild()
        self.camera: CameraSpec | None = None
        self.settings: dict = {}

    def add_color_texture(self, spec: TexSpec) -> int:
        self.color_textures.append(spec)
        return len(self.color_textures) - 1

    def add_material(self, spec: MatSpec) -> int:
        self.materials.append(spec)
        return len(self.materials) - 1

    def add_instance(self, rec: InstanceRecord):
        self.instances.append(rec)

    def bake(self, device, trace_wide: int = 8):
        """-> (scene dict of tensors on device, SceneMeta), with the trace
        tables of width trace_wide (1 or 8)."""
        if trace_wide not in TRACE_WIDTHS:
            raise ValueError(f"trace_wide {trace_wide!r}: the bake supports "
                             f"{TRACE_WIDTHS}")
        tri_v = [np.zeros((0, 3, 3), np.float32)]
        tri_n = [np.zeros((0, 3, 3), np.float32)]
        tri_uv = [np.zeros((0, 3, 2), np.float32)]
        tri_mat = [np.zeros(0, np.int32)]
        for rec in self.instances:
            v, n, uv = _transform_mesh(rec.mesh, rec.to_world)
            f = rec.mesh.faces
            fv = v[f]  # (F, 3, 3)
            if n is not None:
                fn = n[f]
            else:
                gn = np.cross(fv[:, 1] - fv[:, 0], fv[:, 2] - fv[:, 0])
                gn /= np.maximum(np.linalg.norm(gn, axis=-1, keepdims=True),
                                 1e-20)
                fn = np.repeat(gn[:, None, :], 3, axis=1)
            if uv is not None:
                fuv = uv[f]
            else:
                # reference default uvs (0,0) (1,0) (0,1)
                fuv = np.broadcast_to(
                    np.array([[0, 0], [1, 0], [0, 1]], np.float32),
                    (f.shape[0], 3, 2))
            tri_v.append(fv.astype(np.float32))
            tri_n.append(fn.astype(np.float32))
            tri_uv.append(fuv.astype(np.float32))
            tri_mat.append(np.full(f.shape[0], rec.material, np.int32))
        V = np.concatenate(tri_v)
        N = np.concatenate(tri_n)
        UV = np.concatenate(tri_uv)
        MAT = np.concatenate(tri_mat)
        if V.shape[0] == 0:
            # empty scene: one far-away dummy triangle
            V = np.full((1, 3, 3), 1e30, np.float32)
            V[0, 1, 0] += 1.0
            V[0, 2, 1] += 1.0
            N = np.broadcast_to(np.float32([0, 0, 1]), (1, 3, 3)).copy()
            UV = np.zeros((1, 3, 2), np.float32)
            MAT = np.zeros(1, np.int32)

        bvh = build_bvh(V[:, 0], V[:, 1], V[:, 2], max_leaf=MAX_LEAF)
        bvh = align_leaves(bvh, align=8)
        order = bvh.order
        sentinel = order < 0  # leaf padding -> zero-area triangle
        safe = np.where(sentinel, 0, order)
        V, N, UV, MAT = V[safe], N[safe], UV[safe], MAT[safe]
        V[sentinel] = 0.0
        MAT[sentinel] = 0
        if trace_wide == 8:
            nodes_b, nodes_c, depth = collapse8(bvh.bounds, bvh.meta)
            check_wide_depth(depth)
            trace_tables = {"bvh8_bounds": nodes_b, "bvh8_child": nodes_c}
        else:
            depth = bin_depth(bvh.meta)
            if bin_stack_bound(depth) > BIN_STACK:
                raise ValueError(
                    f"binary BVH depth {depth} needs {bin_stack_bound(depth)} "
                    f"stack entries; the trace kernel has {BIN_STACK}"
                )
            nodes_b, nodes_m = bin_tables(bvh.bounds, bvh.meta)
            trace_tables = {"bin_bounds": nodes_b, "bin_meta": nodes_m}

        bmin = V.reshape(-1, 3).min(axis=0)
        bmax = V.reshape(-1, 3).max(axis=0)
        world_center = 0.5 * (bmin + bmax)
        # reference BBox::getBoundingSphere: the full diagonal as radius
        world_radius = float(np.linalg.norm(bmax - bmin)) or 1.0

        mat_rows = np.zeros((len(self.materials), 8), np.float32)
        for i, m in enumerate(self.materials):
            mat_rows[i, mats.COL_TYPE] = m.kind
            mat_rows[i, mats.COL_C0] = m.tex_c0
            mat_rows[i, mats.COL_C1] = m.tex_c1
            mat_rows[i, mats.COL_ETA] = m.eta
            mat_rows[i, mats.COL_K] = -1.0
            mat_rows[i, mats.COL_INNER] = -1
        soup = np.concatenate([V[:, 0], V[:, 1] - V[:, 0], V[:, 2] - V[:, 0]],
                              axis=-1).astype(np.float32)
        tex_sys = TextureSystem(self.color_textures)

        def dev(a):
            return torch.as_tensor(np.ascontiguousarray(a), device=device)

        scene = {name: dev(a) for name, a in trace_tables.items()}
        scene.update({
            "tri_rows": dev(tri_rows(soup)),
            "tri_n": dev(N),
            "tri_uv": dev(UV),
            "tri_mat": dev(MAT),
            "tri_light": dev(np.full(MAT.shape, -1, np.int32)),
            "mat_rows": dev(mat_rows),
            "tex_const": tex_sys.const_table(device),
            "lights": bake_lights(self.lights, world_center, world_radius,
                                  device),
            # emissive-triangle rows [v0, e1, e2, n]: none until area
            # lights load (ROADMAP Queue 1 item 6b)
            "em_rows": dev(np.zeros((0, 12), np.float32)),
        })
        meta = SceneMeta(
            camera=self.camera,
            settings=dict(self.settings),
            n_tris=V.shape[0],
            n_nodes=bvh.num_nodes,
            trace_wide=trace_wide,
            n_wide_nodes=nodes_b.shape[0] if trace_wide == 8 else 0,
            wide_depth=depth if trace_wide == 8 else 0,
            bin_depth=depth if trace_wide == 1 else 0,
            n_materials=len(self.materials),
            n_lights=len(self.lights.types),
            texture_system=tex_sys,
            all_delta_lights=all(t in DELTA_LIGHTS for t in self.lights.types),
            material_kinds=tuple(sorted({m.kind for m in self.materials})),
            world_bounds=(tuple(float(v) for v in bmin),
                          tuple(float(v) for v in bmax)),
        )
        return scene, meta
