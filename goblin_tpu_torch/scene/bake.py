"""Scene bake: host-side scene description -> flat tensors on one device
(port of goblin_tpu/scene/bake.py at its production trace settings).

Instances are flattened to world space (normals by the inverse
transpose) and one BVH is built over the whole triangle soup: binned SAH
with leaves of at most 32 triangles, leaf starts padded to multiples of 8
(padding slots become zero-area triangles that never hit). Analytic
spheres and disks stay out of the BVH, in small tables that the intersect
stage tests densely; a disk that backs an area light is a 64-wedge
triangle fan instead, so it enters the emissive-triangle tables. The
trace width picks the tables the trace kernel walks (goblin_tpu's
GOBLIN_WIDE, here an argument): 8, the default, and 4 collapse the tree to
that width; 1 keeps the binary tree in pack_scene's per-node layout.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..accel.bvh import align_leaves, build_bvh
from ..camera.camera import CameraSpec
from ..integrators import materials as mats
from ..lights.envmap import bake_env, env_luminance
from ..lights.lights import DELTA_LIGHTS, LIGHT_AREA, LightsBuild, bake_lights
from ..ops.trace import (BIN_STACK, bin_depth, bin_stack_bound, bin_tables,
                         check_wide_depth, collapse_wide, tri_rows)
from ..shading.bsdf import MAT_LAMBERT, MAT_MASK, MAT_SUBSURFACE
from ..shading.bssrdf import fresnel_a
from ..shading.textures import TexSpec, TextureSystem

MAX_LEAF = 32
TRACE_WIDTHS = (1, 4, 8)
DISK_FAN_WEDGES = 64


@dataclass
class MatSpec:
    """Host-side material: type id, texture ids and optics."""

    kind: int = MAT_LAMBERT
    tex_c0: int = 0  # Kd / Kg / Kr (color texture id)
    tex_c1: int = 0  # Kt / transparent_color
    tex_f0: int = 0  # exponent (float texture id)
    tex_f1: int = 0  # alpha
    eta: float = 1.5
    k: float = -1.0
    inner: int = -1  # mask: the wrapped material's row
    # subsurface: sigma_a, sigma_s' and the phase asymmetry g
    absorb: tuple = (0.0, 0.0, 0.0)
    scatter_prime: tuple = (0.0, 0.0, 0.0)
    g: float = 0.0
    bump_tex: int = -1  # float texture id of the bump map, or -1
    normal_tex: int = -1  # color texture id of the normal map, or -1


@dataclass
class InstanceRecord:
    geometry: object  # TriangleMesh | ("sphere", r) | ("disk", r)
    material: int  # material row
    to_world: np.ndarray  # (4, 4)
    area_light: int = -1  # light row, or -1
    is_camera_lens: bool = False


@dataclass
class SceneMeta:
    camera: CameraSpec = None
    settings: dict = field(default_factory=dict)
    n_tris: int = 0
    n_nodes: int = 0  # binary BVH nodes
    # trace width: 8 and 4 walk the collapsed tables (ops.trace.trace), 1
    # the binary ones (ops.trace.trace_bin)
    trace_wide: int = 8
    n_wide_nodes: int = 0  # collapsed nodes (width 4 or 8)
    wide_depth: int = 0  # collapsed nodes on the longest root-to-leaf path
    bin_depth: int = 0  # binary inner nodes on the longest path (width 1)
    n_materials: int = 0
    n_lights: int = 0
    n_spheres: int = 0
    n_disks: int = 0
    has_lens: bool = False  # a camera-lens disk is in the scene
    texture_system: TextureSystem = None
    float_texture_system: TextureSystem = None
    max_leaf: int = MAX_LEAF
    has_perturb: bool = False  # a material carries a bump or normal map
    has_null: bool = False  # a mask material (null lobe) is in the scene
    # an image-based light and its row of the light table (scene["env"]
    # holds its map)
    has_env: bool = False
    env_light_id: int = -1
    # a subsurface material is in the scene (PT and Whitted add its BSSRDF
    # term; scene["mat_sigma_a"] and the rest hold its tables)
    has_bssrdf: bool = False
    # the scene's participating medium (integrators.volume.VolumeSpec; a
    # heterogeneous one's grid is scene["vol_grid"]), or None
    volume: object = None
    # NEE samples of each light (reference Light::getSamplesNum), which
    # Whitted's direct lighting takes
    light_sample_nums: tuple = ()
    # every light is a delta light and there is no environment: a BSDF ray
    # never hits an emitter, so the path tracer skips the last bounce's
    # continuation trace
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


def _disk_frame(m):
    """World normal and in-plane u axis of a z = 0 disk placed by m: the
    normal by the inverse transpose, u re-orthogonalised against it."""
    n = np.linalg.inv(m[:3, :3]).T @ np.float32([0, 0, 1])
    n = (n / max(np.linalg.norm(n), 1e-20)).astype(np.float32)
    u_dir = m[:3, :3] @ np.float32([1, 0, 0])
    u_dir = u_dir - n * float(u_dir @ n)
    u_dir = (u_dir / max(np.linalg.norm(u_dir), 1e-20)).astype(np.float32)
    return n, u_dir


def _disk_fan(radius, m):
    """A z = 0 disk as DISK_FAN_WEDGES world-space triangles about its
    centre -> (v (K, 3, 3), n (3,))."""
    k = DISK_FAN_WEDGES
    ang = np.linspace(0, 2 * np.pi, k + 1)
    pts = np.stack([radius * np.cos(ang), radius * np.sin(ang),
                    np.zeros(k + 1)], axis=-1).astype(np.float32)
    v = np.zeros((k, 3, 3), np.float32)
    v[:, 1] = pts[:-1]
    v[:, 2] = pts[1:]
    v = v @ m[:3, :3].T + m[:3, 3]
    n = np.linalg.inv(m[:3, :3]).T @ np.array([0, 0, 1.0], np.float32)
    return v.astype(np.float32), n / np.linalg.norm(n)


class SceneBuilder:
    """Accumulates world-space primitives, materials and lights, then
    bakes."""

    def __init__(self):
        self.instances: list[InstanceRecord] = []
        self.materials: list[MatSpec] = [MatSpec()]  # row 0: error magenta
        self.color_textures: list[TexSpec] = [
            TexSpec(value=np.array([1.0, 0.0, 1.0], np.float32))
        ]
        self.float_textures: list[TexSpec] = [
            TexSpec(value=np.array([0.5, 0.5, 0.5], np.float32))
        ]
        self.lights = LightsBuild()
        self.camera: CameraSpec | None = None
        self.settings: dict = {}
        # the image-based light: its row, map, filter and orientation
        self.env_light_id = -1
        self.env_image = None
        self.env_filter = np.ones(3, np.float32)
        self.env_orientation = np.array([1.0, 0.0, 0.0, 0.0], np.float32)
        # the participating medium and a heterogeneous one's density grid
        self.volume = None
        self.vol_grid = None

    def add_color_texture(self, spec: TexSpec) -> int:
        self.color_textures.append(spec)
        return len(self.color_textures) - 1

    def add_float_texture(self, spec: TexSpec) -> int:
        self.float_textures.append(spec)
        return len(self.float_textures) - 1

    def add_material(self, spec: MatSpec) -> int:
        self.materials.append(spec)
        return len(self.materials) - 1

    def add_instance(self, rec: InstanceRecord):
        self.instances.append(rec)

    def bake(self, device, trace_wide: int = 8):
        """-> (scene dict of tensors on device, SceneMeta), with the trace
        tables of width trace_wide (1, 4 or 8)."""
        if trace_wide not in TRACE_WIDTHS:
            raise ValueError(f"trace_wide {trace_wide!r}: the bake supports "
                             f"{TRACE_WIDTHS}")
        tri_v = [np.zeros((0, 3, 3), np.float32)]
        tri_n = [np.zeros((0, 3, 3), np.float32)]
        tri_uv = [np.zeros((0, 3, 2), np.float32)]
        tri_mat = [np.zeros(0, np.int32)]
        tri_light = [np.zeros(0, np.int32)]
        spheres = []  # (center, radius, mat, light)
        disks = []  # (center, n, u_dir, radius, mat, light, is_lens)

        def add_tris(fv, fn, fuv, rec):
            tri_v.append(fv.astype(np.float32))
            tri_n.append(fn.astype(np.float32))
            tri_uv.append(fuv.astype(np.float32))
            tri_mat.append(np.full(fv.shape[0], rec.material, np.int32))
            tri_light.append(np.full(fv.shape[0], rec.area_light, np.int32))

        for rec in self.instances:
            g, m = rec.geometry, rec.to_world
            if isinstance(g, tuple):
                # the radius scales with the matrix' first column
                radius = float(g[1]) * float(np.linalg.norm(m[:3, 0]))
                if g[0] == "sphere":
                    spheres.append((m[:3, 3].copy(), radius, rec.material,
                                    rec.area_light))
                elif rec.area_light < 0:
                    # analytic z = 0 disk (reference GoblinDisk.cpp:12-56):
                    # plain disks and the camera lens
                    n, u_dir = _disk_frame(m)
                    disks.append((m[:3, 3].astype(np.float32), n, u_dir,
                                  radius, rec.material, rec.area_light,
                                  rec.is_camera_lens))
                else:
                    # a disk that backs an area light: a triangle fan, so
                    # the emissive-triangle sampling applies to it
                    v, n = _disk_fan(float(g[1]), m)
                    add_tris(v, np.broadcast_to(n, v.shape),
                             np.zeros((v.shape[0], 3, 2), np.float32), rec)
                continue
            v, n, uv = _transform_mesh(g, m)
            f = g.faces
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
            add_tris(fv, fn, fuv, rec)
        V = np.concatenate(tri_v)
        N = np.concatenate(tri_n)
        UV = np.concatenate(tri_uv)
        MAT = np.concatenate(tri_mat)
        LIGHT = np.concatenate(tri_light)
        if V.shape[0] == 0:
            # no triangles: one far-away dummy
            V = np.full((1, 3, 3), 1e30, np.float32)
            V[0, 1, 0] += 1.0
            V[0, 2, 1] += 1.0
            N = np.broadcast_to(np.float32([0, 0, 1]), (1, 3, 3)).copy()
            UV = np.zeros((1, 3, 2), np.float32)
            MAT = np.zeros(1, np.int32)
            LIGHT = np.full(1, -1, np.int32)

        bvh = build_bvh(V[:, 0], V[:, 1], V[:, 2], max_leaf=MAX_LEAF)
        bvh = align_leaves(bvh, align=8)
        order = bvh.order
        sentinel = order < 0  # leaf padding -> zero-area triangle
        safe = np.where(sentinel, 0, order)
        V, N, UV, MAT, LIGHT = V[safe], N[safe], UV[safe], MAT[safe], LIGHT[safe]
        V[sentinel] = 0.0
        MAT[sentinel] = 0
        LIGHT[sentinel] = -1
        if trace_wide == 1:
            depth = bin_depth(bvh.meta)
            if bin_stack_bound(depth) > BIN_STACK:
                raise ValueError(
                    f"binary BVH depth {depth} needs {bin_stack_bound(depth)} "
                    f"stack entries; the trace kernel has {BIN_STACK}"
                )
            nodes_b, nodes_m = bin_tables(bvh.bounds, bvh.meta)
            trace_tables = {"bin_bounds": nodes_b, "bin_meta": nodes_m}
        else:
            nodes_b, nodes_c, depth = collapse_wide(bvh.bounds, bvh.meta,
                                                    trace_wide)
            check_wide_depth(depth, trace_wide)
            trace_tables = {f"bvh{trace_wide}_bounds": nodes_b,
                            f"bvh{trace_wide}_child": nodes_c}

        # world bounds over triangles, spheres and disks (directional
        # emission and SPPM's automatic radius read them)
        bmin = V.reshape(-1, 3).min(axis=0)
        bmax = V.reshape(-1, 3).max(axis=0)
        for prim in spheres:
            bmin = np.minimum(bmin, np.asarray(prim[0]) - prim[1])
            bmax = np.maximum(bmax, np.asarray(prim[0]) + prim[1])
        for prim in disks:
            bmin = np.minimum(bmin, np.asarray(prim[0]) - prim[3])
            bmax = np.maximum(bmax, np.asarray(prim[0]) + prim[3])
        world_center = 0.5 * (bmin + bmax)
        # reference BBox::getBoundingSphere: the full diagonal as radius
        world_radius = float(np.linalg.norm(bmax - bmin)) or 1.0

        # emissive triangles in segments ordered by light id
        em_order = np.argsort(LIGHT + (LIGHT < 0) * (1 << 30), kind="stable")
        em_sel = em_order[LIGHT[em_order] >= 0]
        em_v = V[em_sel]
        e1 = em_v[:, 1] - em_v[:, 0]
        e2 = em_v[:, 2] - em_v[:, 0]
        em_n = np.cross(e1, e2)
        em_area = 0.5 * np.linalg.norm(em_n, axis=-1)
        em_n = em_n / np.maximum(np.linalg.norm(em_n, axis=-1, keepdims=True),
                                 1e-20)

        # world area of each area light: its triangles, or its one sphere
        L_n = max(1, len(self.lights.types))
        areas = np.zeros(L_n, np.float32)
        sph_l_center = np.zeros((L_n, 3), np.float32)
        sph_l_radius = np.zeros(L_n, np.float32)
        light_is_sphere = np.zeros(L_n, bool)
        for i, t in enumerate(self.lights.types):
            if t == LIGHT_AREA:
                areas[i] = em_area[LIGHT[em_sel] == i].sum()
        for center, radius, _, lgt in spheres:
            if lgt >= 0:
                # sample_li sends a sphere light through the cone sampling
                # alone, so a light is either triangles or one sphere
                if areas[lgt] > 0.0 or light_is_sphere[lgt]:
                    raise ValueError(
                        f"area light {lgt} has multiple emitter "
                        "geometries (sphere + triangles or two spheres); "
                        "declare one light per emitter geometry"
                    )
                areas[lgt] = 4.0 * np.pi * radius * radius
                sph_l_center[lgt] = center
                sph_l_radius[lgt] = radius
                light_is_sphere[lgt] = True
        self.lights.areas = list(areas[: len(self.lights.types)])
        has_env = self.env_light_id >= 0
        env_power = 0.0
        if has_env:
            # reference ImageBasedLight::power: the unfiltered map's mean
            # luminance x pi x 4 pi r^2 on the world's bounding sphere
            # (src/GoblinLight.cpp:610-618)
            env_power = float(env_luminance(self.env_image).mean() * np.pi
                              * 4.0 * np.pi * world_radius ** 2)

        mat_rows = np.zeros((len(self.materials), 8), np.float32)
        for i, m in enumerate(self.materials):
            mat_rows[i, mats.COL_TYPE] = m.kind
            mat_rows[i, mats.COL_C0] = m.tex_c0
            mat_rows[i, mats.COL_C1] = m.tex_c1
            mat_rows[i, mats.COL_F0] = m.tex_f0
            mat_rows[i, mats.COL_F1] = m.tex_f1
            mat_rows[i, mats.COL_ETA] = m.eta
            mat_rows[i, mats.COL_K] = m.k
            mat_rows[i, mats.COL_INNER] = m.inner
        soup = np.concatenate([V[:, 0], V[:, 1] - V[:, 0], V[:, 2] - V[:, 0]],
                              axis=-1).astype(np.float32)
        tex_sys = TextureSystem(self.color_textures)
        ftex_sys = TextureSystem(self.float_textures)

        def dev(a):
            return torch.as_tensor(np.ascontiguousarray(a), device=device)

        scene = {name: dev(a) for name, a in trace_tables.items()}
        scene.update({
            "tri_rows": dev(tri_rows(soup)),
            "tri_n": dev(N),
            "tri_uv": dev(UV),
            "tri_mat": dev(MAT),
            "tri_light": dev(LIGHT),
            "mat_rows": dev(mat_rows),
            "mat_bump": dev(np.asarray([m.bump_tex for m in self.materials],
                                       np.int32)),
            "mat_normal": dev(np.asarray([m.normal_tex for m in self.materials],
                                         np.int32)),
            # the BSSRDF's tables, zero rows but for subsurface materials'
            # sigmas and g (A is every row's)
            "mat_sigma_a": dev(np.asarray([m.absorb for m in self.materials],
                                          np.float32)),
            "mat_sigma_sp": dev(np.asarray(
                [m.scatter_prime for m in self.materials], np.float32)),
            "mat_ss_g": dev(np.asarray([m.g for m in self.materials],
                                       np.float32)),
            "mat_ss_A": dev(np.asarray([fresnel_a(m.eta)
                                        for m in self.materials], np.float32)),
            "tex_atlas": dev(tex_sys.atlas),
            "ftex_atlas": dev(ftex_sys.atlas),
            "tex_const": dev(tex_sys.const),
            "ftex_const": dev(ftex_sys.const),
            "lights": bake_lights(self.lights, LIGHT[em_sel], em_area,
                                  world_center, world_radius, device,
                                  sph_l_center, sph_l_radius, light_is_sphere,
                                  env_luminance_power=env_power),
            # emissive-triangle rows [v0, e1, e2, n], one gather a sample
            "em_rows": dev(np.concatenate([em_v[:, 0], e1, e2, em_n], axis=-1)
                           .astype(np.float32)),
        })
        if self.vol_grid is not None:
            scene["vol_grid"] = dev(np.asarray(self.vol_grid, np.float32))
        if has_env:
            scene["env"] = bake_env(self.env_image, self.env_filter,
                                    self.env_orientation, device)
        if spheres:
            scene["sph_center"] = dev(np.stack([s[0] for s in spheres])
                                      .astype(np.float32))
            scene["sph_radius"] = dev(np.asarray([s[1] for s in spheres],
                                                 np.float32))
            scene["sph_mat"] = dev(np.asarray([s[2] for s in spheres], np.int32))
            scene["sph_light"] = dev(np.asarray([s[3] for s in spheres],
                                                np.int32))
        if disks:
            scene["dsk_center"] = dev(np.stack([d[0] for d in disks])
                                      .astype(np.float32))
            scene["dsk_n"] = dev(np.stack([d[1] for d in disks])
                                 .astype(np.float32))
            scene["dsk_u"] = dev(np.stack([d[2] for d in disks])
                                 .astype(np.float32))
            scene["dsk_radius"] = dev(np.asarray([d[3] for d in disks],
                                                 np.float32))
            scene["dsk_mat"] = dev(np.asarray([d[4] for d in disks], np.int32))
            scene["dsk_light"] = dev(np.asarray([d[5] for d in disks],
                                                np.int32))
            scene["dsk_lens"] = dev(np.asarray([d[6] for d in disks], bool))
        meta = SceneMeta(
            camera=self.camera,
            settings=dict(self.settings),
            n_tris=V.shape[0],
            n_nodes=bvh.num_nodes,
            trace_wide=trace_wide,
            n_wide_nodes=nodes_b.shape[0] if trace_wide != 1 else 0,
            wide_depth=depth if trace_wide != 1 else 0,
            bin_depth=depth if trace_wide == 1 else 0,
            n_materials=len(self.materials),
            n_lights=len(self.lights.types),
            n_spheres=len(spheres),
            n_disks=len(disks),
            has_lens=any(d[6] for d in disks),
            texture_system=tex_sys,
            float_texture_system=ftex_sys,
            has_perturb=any(m.bump_tex >= 0 or m.normal_tex >= 0
                            for m in self.materials),
            has_null=any(m.kind == MAT_MASK for m in self.materials),
            has_bssrdf=any(m.kind == MAT_SUBSURFACE for m in self.materials),
            volume=self.volume,
            has_env=has_env,
            env_light_id=self.env_light_id,
            light_sample_nums=tuple(int(n) for n in self.lights.sample_nums),
            all_delta_lights=(not has_env and all(
                t in DELTA_LIGHTS for t in self.lights.types)),
            material_kinds=tuple(sorted({m.kind for m in self.materials})),
            world_bounds=(tuple(float(v) for v in bmin),
                          tuple(float(v) for v in bmax)),
        )
        return scene, meta


# the scene leaves a gradient may flow to, named as goblin_tpu's pytree
# leaves: "lights.color" is scene["lights"]["color"]; "tri_soup" (T, 9) is
# v0 | e1 | e2, the first 9 of the port's 12 tri_rows columns
TRAINABLE = ("lights.color", "tex_const", "tex_atlas", "tri_soup")


def trainable_params(scene) -> dict:
    """The scene's trainable leaves as numpy arrays (copies), keyed as
    TRAINABLE."""
    def host(x):
        return x.detach().cpu().numpy().copy()

    return {"lights.color": host(scene["lights"]["color"]),
            "tex_const": host(scene["tex_const"]),
            "tex_atlas": host(scene["tex_atlas"]),
            "tri_soup": host(scene["tri_rows"][:, :9])}


def set_trainable_params(scene, arrays) -> dict:
    """A new scene dict with the leaves that arrays (keys of TRAINABLE,
    numpy arrays or tensors of the leaves' shapes) name replaced by new
    float32 tensors on the scene's device; tri_soup becomes tri_rows with
    its columns 9-11 kept. The baked tables are not written, and the BVH is
    not refitted: the tree stays that of the baked vertices, as goblin_tpu's
    does."""
    unknown = set(arrays) - set(TRAINABLE)
    if unknown:
        raise KeyError(f"not trainable: {sorted(unknown)}")
    dev = scene["tri_rows"].device
    out = dict(scene)

    def new(name, old_shape):
        a = torch.as_tensor(arrays[name], dtype=torch.float32, device=dev)
        if tuple(a.shape) != tuple(old_shape):
            raise ValueError(f"{name}: shape {tuple(a.shape)}, the scene's "
                             f"is {tuple(old_shape)}")
        return a.clone()

    if "lights.color" in arrays:
        out["lights"] = dict(scene["lights"], color=new(
            "lights.color", scene["lights"]["color"].shape))
    for name in ("tex_const", "tex_atlas"):
        if name in arrays:
            out[name] = new(name, scene[name].shape)
    if "tri_soup" in arrays:
        rows = scene["tri_rows"]
        out["tri_rows"] = torch.cat(
            [new("tri_soup", (rows.shape[0], 9)), rows[:, 9:]], dim=1)
    return out
