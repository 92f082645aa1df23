"""JSON scene loader (port of goblin_tpu/scene/loader.py for the subset of
the reference schema that the ported integrators render).

Supported: meshes (OBJ), analytic spheres and disks placed by instances,
constant color and float textures, lambert / blinn / transparent / mirror /
mask materials, point / spot / directional / area lights, perspective
(pinhole or thin-lens) and orthographic cameras, box / triangle / gaussian
/ mitchell film filters and EXR output. Any other feature raises
NotImplementedError naming the ROADMAP item that brings it; nothing is
silently skipped. Unknown texture and material names resolve to the
magenta error assets, as in the reference (src/GoblinScene.cpp:112-128).

Material and texture ids are table rows, so materials are added in
goblin_tpu's order: a thin-lens camera's lens disk (black Lambert, flagged
is_camera_lens) while the camera is parsed, the scene's materials, then
the black Lambert that every area light's synthesised instance shares
(src/GoblinContextLoader.cpp:148-175, 419-441).
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..camera.camera import CameraSpec
from ..camera.film import FilmSpec, FilterSpec
from ..geometry.mesh import load_obj
from ..lights.lights import (LIGHT_AREA, LIGHT_DIRECTIONAL, LIGHT_POINT,
                             LIGHT_SPOT)
from ..shading.bsdf import (MAT_BLINN, MAT_LAMBERT, MAT_MASK, MAT_MIRROR,
                            MAT_TRANSPARENT)
from ..shading.textures import TexSpec
from .bake import InstanceRecord, MatSpec, SceneBuilder
from .params import ParamSet, get_quaternion, get_transform


def _unsupported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not in goblin_tpu_torch yet (ROADMAP Queue 1 item {item})"
    )


def _add_black(builder) -> int:
    """A new black Lambert material over a new black texture -> its row."""
    return builder.add_material(MatSpec(
        kind=MAT_LAMBERT, tex_c0=builder.add_color_texture(
            TexSpec(value=np.zeros(3, np.float32)))))


def _resolve_path(scene_dir, p):
    return p if os.path.isabs(p) else os.path.join(scene_dir, p)


def resolve_device(name) -> torch.device:
    """The device a name stands for; asking for cuda without a card raises
    (nothing falls back to the CPU)."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device cuda was asked for, but CUDA is not "
                           "available (pass device=\"cpu\" or --device cpu "
                           "to run on the CPU)")
    return dev


def load_scene(path: str, overrides: dict | None = None, device="cuda",
               trace_wide: int = 8):
    """Load a scene JSON -> (scene dict of tensors on device, SceneMeta).
    overrides patches render_setting keys (e.g. {"max_ray_depth": 5});
    device defaults to the card and raises where there is none;
    trace_wide picks the trace kernel's tables: 8 (BVH8), 4 (BVH4) or 1
    (binary)."""
    device = resolve_device(device)
    with open(path) as f:
        doc = json.load(f)
    scene_dir = os.path.dirname(os.path.abspath(path))
    builder = SceneBuilder()

    # --- render_setting
    settings = dict(doc.get("render_setting", {}))
    settings.update(overrides or {})
    rs = ParamSet(settings)
    builder.settings = {
        "render_method": rs.get_string("render_method", "path_tracing"),
        "sample_per_pixel": rs.get_int("sample_per_pixel", 1),
        "max_ray_depth": rs.get_int("max_ray_depth", 5),
        "initial_radius": rs.get_float("initial_radius", -1.0),
        "seed": rs.get_int("seed", 0),
    }

    # --- camera, film, filter
    cam_raw = doc.get("camera", {})
    cam_p = ParamSet(cam_raw)
    filt_p = ParamSet(cam_raw.get("filter", {}))
    fw = filt_p.get_vec2("width", (1.0, 1.0))
    filter_spec = FilterSpec(
        kind=filt_p.get_string("type", "gaussian"),
        x_width=float(fw[0]),
        y_width=float(fw[1]),
        falloff=filt_p.get_float("falloff", 2.0),
        b=filt_p.get_float("b", 2.0),
        c=filt_p.get_float("c", 2.0),
    )
    if filter_spec.kind not in ("box", "triangle", "gaussian", "mitchell"):
        raise ValueError(f"unknown filter type {filter_spec.kind!r}")
    film_p = ParamSet(cam_raw.get("film", {}))
    for key in ("tone_mapping", "bloom_radius", "bloom_weight"):
        if film_p.get_float(key, 0.0):
            raise _unsupported(f"film {key}", "16")
    res = film_p.get_vec2("resolution", (512.0, 512.0))
    default_out = os.path.splitext(os.path.basename(path))[0] + ".exr"
    out_file = film_p.get_string("file", os.path.join(scene_dir, default_out))
    if not out_file.endswith(".exr"):
        raise _unsupported("non-EXR film output", "16")
    ckind = cam_p.get_string("type", "perspective")
    lens_r = cam_p.get_float("lens_radius", 0.0)
    builder.camera = CameraSpec(
        kind=ckind if ckind in ("perspective", "orthographic") else "perspective",
        position=tuple(float(v) for v in cam_p.get_vec3("position")),
        orientation=tuple(float(v) for v in get_quaternion(cam_p)),
        fov=float(np.radians(cam_p.get_float("fov", 60.0))),
        z_near=cam_p.get_float("near_plane", 0.1),
        z_far=cam_p.get_float("far_plane", 1000.0),
        lens_radius=lens_r,
        focal_distance=cam_p.get_float("focal_distance", 1.0),
        film_width=cam_p.get_float("film_width", 35.0),
        film=FilmSpec(
            x_res=int(res[0]),
            y_res=int(res[1]),
            crop=tuple(float(c) for c in
                       film_p.get_vec4("crop", (0.0, 1.0, 0.0, 1.0))),
            filename=out_file,
            filter=filter_spec,
        ),
    )
    if lens_r > 0.0:
        # the camera-lens disk (black Lambert, at the camera pose), which
        # light particles can hit
        builder.add_instance(InstanceRecord(
            geometry=("disk", lens_r), material=_add_black(builder),
            to_world=get_transform(cam_p), is_camera_lens=True))

    if doc.get("volume"):
        raise _unsupported("participating media (volume)", "12")

    # --- geometries
    geometries: dict[str, object] = {}
    for raw in doc.get("geometries", []) or []:
        p = ParamSet(raw)
        gkind = p.get_string("type", "sphere")
        if gkind == "mesh":
            geometries[p.get_string("name")] = load_obj(
                _resolve_path(scene_dir, p.get_string("file")))
        else:
            geometries[p.get_string("name")] = (
                "disk" if gkind == "disk" else "sphere",
                p.get_float("radius", 1.0))

    # --- textures (color and float namespaces, like the reference)
    color_tex: dict[str, int] = {}
    float_tex: dict[str, int] = {}
    for raw in doc.get("textures", []) or []:
        p = ParamSet(raw)
        tkind = p.get_string("type", "constant")
        if tkind != "constant":
            raise _unsupported(f"{tkind} texture", "7")
        if p.get_string("format", "color") == "color":
            color_tex[p.get_string("name")] = builder.add_color_texture(
                TexSpec(value=np.asarray(p.get_vec3("color", (0.5, 0.5, 0.5)),
                                         np.float32)))
        else:
            float_tex[p.get_string("name")] = builder.add_float_texture(
                TexSpec(value=np.full(3, p.get_float("float", 0.5),
                                      np.float32)))

    def color_tex_id(p, key, default=None):
        """The named color texture's row; a new constant where the name is
        unknown and a default is given; else the error magenta."""
        name = p.get_string(key, "")
        if name in color_tex:
            return color_tex[name]
        if default is not None:
            return builder.add_color_texture(
                TexSpec(value=np.asarray(default, np.float32)))
        return 0

    def float_tex_id(p, key, default):
        name = p.get_string(key, "")
        if name in float_tex:
            return float_tex[name]
        return builder.add_float_texture(
            TexSpec(value=np.full(3, float(default), np.float32)))

    # --- materials
    materials: dict[str, int] = {}
    for raw in doc.get("materials", []) or []:
        p = ParamSet(raw)
        mkind = p.get_string("type", "lambert")
        if p.has("bumpmap") or p.has("normalmap"):
            raise _unsupported("bump and normal maps", "7")
        if mkind == "lambert":
            spec = MatSpec(kind=MAT_LAMBERT, tex_c0=color_tex_id(p, "Kd"))
        elif mkind == "blinn":
            spec = MatSpec(kind=MAT_BLINN, tex_c0=color_tex_id(p, "Kg"),
                           tex_f0=float_tex_id(p, "exponent", 10.0),
                           eta=p.get_float("index", 1.5),
                           k=p.get_float("k", -1.0))
        elif mkind == "transparent":
            spec = MatSpec(kind=MAT_TRANSPARENT,
                           tex_c0=color_tex_id(p, "Kr"),
                           tex_c1=color_tex_id(p, "Kt"),
                           eta=p.get_float("index", 1.5))
        elif mkind == "mirror":
            spec = MatSpec(kind=MAT_MIRROR,
                           tex_c0=color_tex_id(p, "Kr", (1.0, 1.0, 1.0)),
                           eta=p.get_float("index", 0.8),
                           k=p.get_float("k", 6.0))
        elif mkind == "mask":
            spec = MatSpec(
                kind=MAT_MASK, tex_f1=float_tex_id(p, "alpha", 1.0),
                tex_c1=color_tex_id(p, "transparent_color", (1.0, 1.0, 1.0)),
                inner=materials.get(p.get_string("material"), 0))
        elif mkind == "subsurface":
            raise _unsupported("subsurface material", "12")
        else:
            raise ValueError(f"unknown material type {mkind!r}")
        materials[p.get_string("name")] = builder.add_material(spec)

    # --- lights (an area light's instance is added after the primitives)
    area_light_geo: list[tuple[int, str, np.ndarray]] = []
    for raw in doc.get("lights", []) or []:
        p = ParamSet(raw)
        lkind = p.get_string("type", "point")
        if lkind == "point":
            builder.lights.add(LIGHT_POINT, p.get_vec3("intensity", (1, 1, 1)),
                               position=p.get_vec3("position"))
        elif lkind == "directional":
            builder.lights.add(LIGHT_DIRECTIONAL,
                               p.get_vec3("radiance", (1, 1, 1)),
                               direction=p.get_vec3("direction", (0, 0, 1)))
        elif lkind == "spot":
            pos = p.get_vec3("position")
            if p.has("target"):
                d = p.get_vec3("target") - pos
            else:
                d = p.get_vec3("direction", (0, 0, 1))
            builder.lights.add(
                LIGHT_SPOT, p.get_vec3("intensity", (1, 1, 1)),
                position=pos, direction=d,
                cos_theta_max=float(np.cos(np.radians(
                    p.get_float("theta_max", 30.0)))),
                cos_falloff_start=float(np.cos(np.radians(
                    p.get_float("falloff_start", 25.0)))),
            )
        elif lkind == "area":
            lid = builder.lights.add(LIGHT_AREA,
                                     p.get_vec3("radiance", (1, 1, 1)),
                                     sample_num=p.get_int("sample_num", 1))
            area_light_geo.append((lid, p.get_string("geometry"),
                                   get_transform(p)))
        elif lkind == "ibl":
            raise _unsupported("image-based light", "12")
        else:
            raise ValueError(f"unknown light type {lkind!r}")

    # --- primitives: models, then the instances that place them
    models: dict[str, dict] = {}
    for raw in doc.get("primitives", []) or []:
        p = ParamSet(raw)
        name = p.get_string("name")
        if p.get_string("type", "model") == "model":
            models[name] = {"geometry": p.get_string("geometry"),
                            "material": p.get_string("material"),
                            "is_camera_lens": p.get_bool("is_camera_lens",
                                                         False)}
            continue
        model = models.get(p.get_string("model"))
        if model is None:
            raise ValueError(f"instance {name!r}: unknown model "
                             f"{p.get_string('model')!r}")
        geo = geometries.get(model["geometry"])
        if geo is None:
            raise ValueError(f"model {p.get_string('model')!r}: unknown "
                             f"geometry {model['geometry']!r}")
        builder.add_instance(InstanceRecord(
            geometry=geo, material=materials.get(model["material"], 0),
            to_world=get_transform(p),
            is_camera_lens=model["is_camera_lens"]))

    # area lights: a black-Lambert instance each, so rays can hit them
    black = _add_black(builder)
    for lid, geo_name, xform in area_light_geo:
        geo = geometries.get(geo_name)
        if geo is None:
            raise ValueError(f"area light {lid}: unknown geometry "
                             f"{geo_name!r}")
        builder.add_instance(InstanceRecord(
            geometry=geo, material=black, to_world=xform, area_light=lid))

    return builder.bake(device, trace_wide)
