"""JSON scene loader (port of goblin_tpu/scene/loader.py for the subset of
the reference schema that the path-tracing slice renders).

Supported: meshes (OBJ) placed by instances, constant textures, lambert
and transparent materials, point / spot / directional lights, a pinhole
perspective camera, box / triangle / gaussian / mitchell film filters and
EXR output. Any other feature raises NotImplementedError naming the
ROADMAP item that brings it; nothing is silently skipped. Unknown texture
and material names resolve to the magenta error assets, as in the
reference (src/GoblinScene.cpp:112-128).
"""

from __future__ import annotations

import json
import os

import numpy as np

from ..camera.camera import CameraSpec
from ..camera.film import FilmSpec, FilterSpec
from ..geometry.mesh import load_obj
from ..lights.lights import LIGHT_DIRECTIONAL, LIGHT_POINT, LIGHT_SPOT
from ..shading.bsdf import MAT_LAMBERT, MAT_TRANSPARENT
from ..shading.textures import TexSpec
from .bake import InstanceRecord, MatSpec, SceneBuilder
from .params import ParamSet, get_quaternion, get_transform


def _unsupported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not in goblin_tpu_torch yet (ROADMAP Queue 1 item {item})"
    )


def _resolve_path(scene_dir, p):
    return p if os.path.isabs(p) else os.path.join(scene_dir, p)


def load_scene(path: str, overrides: dict | None = None, device="cpu"):
    """Load a scene JSON -> (scene dict of tensors on device, SceneMeta).
    overrides patches render_setting keys (e.g. {"max_ray_depth": 5})."""
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
    kind = cam_p.get_string("type", "perspective")
    if kind != "perspective":
        raise _unsupported(f"{kind} camera", "6b")
    if cam_p.get_float("lens_radius", 0.0) > 0.0:
        raise _unsupported("thin-lens camera (lens_radius > 0)", "6b")
    builder.camera = CameraSpec(
        position=tuple(float(v) for v in cam_p.get_vec3("position")),
        orientation=tuple(float(v) for v in get_quaternion(cam_p)),
        fov=float(np.radians(cam_p.get_float("fov", 60.0))),
        z_near=cam_p.get_float("near_plane", 0.1),
        z_far=cam_p.get_float("far_plane", 1000.0),
        film=FilmSpec(
            x_res=int(res[0]),
            y_res=int(res[1]),
            crop=tuple(float(c) for c in
                       film_p.get_vec4("crop", (0.0, 1.0, 0.0, 1.0))),
            filename=out_file,
            filter=filter_spec,
        ),
    )

    if doc.get("volume"):
        raise _unsupported("participating media (volume)", "12")

    # --- geometries (analytic ones are refused when an instance uses them)
    geometries: dict[str, object] = {}
    for raw in doc.get("geometries", []) or []:
        p = ParamSet(raw)
        gkind = p.get_string("type", "sphere")
        if gkind == "mesh":
            geometries[p.get_string("name")] = load_obj(
                _resolve_path(scene_dir, p.get_string("file")))
        else:
            geometries[p.get_string("name")] = gkind

    # --- textures (color and float namespaces, like the reference)
    color_tex: dict[str, int] = {}
    for raw in doc.get("textures", []) or []:
        p = ParamSet(raw)
        tkind = p.get_string("type", "constant")
        if tkind != "constant":
            raise _unsupported(f"{tkind} texture", "7")
        # float-format textures feed only the exponents, alphas and bump
        # maps of materials this port refuses, so only colors are kept
        if p.get_string("format", "color") == "color":
            color_tex[p.get_string("name")] = builder.add_color_texture(
                TexSpec(value=np.asarray(p.get_vec3("color", (0.5, 0.5, 0.5)),
                                         np.float32)))

    # --- materials
    materials: dict[str, int] = {}
    for raw in doc.get("materials", []) or []:
        p = ParamSet(raw)
        mkind = p.get_string("type", "lambert")
        if p.has("bumpmap") or p.has("normalmap"):
            raise _unsupported("bump and normal maps", "7")
        if mkind == "lambert":
            spec = MatSpec(kind=MAT_LAMBERT,
                           tex_c0=color_tex.get(p.get_string("Kd", ""), 0))
        elif mkind == "transparent":
            spec = MatSpec(kind=MAT_TRANSPARENT,
                           tex_c0=color_tex.get(p.get_string("Kr", ""), 0),
                           tex_c1=color_tex.get(p.get_string("Kt", ""), 0),
                           eta=p.get_float("index", 1.5))
        elif mkind == "subsurface":
            raise _unsupported("subsurface material", "12")
        else:
            raise _unsupported(f"{mkind} material", "7")
        materials[p.get_string("name")] = builder.add_material(spec)

    # --- lights
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
        elif lkind == "ibl":
            raise _unsupported("image-based light", "12")
        else:
            raise _unsupported(f"{lkind} light", "6b")

    # --- primitives: models, then the instances that place them
    models: dict[str, dict] = {}
    for raw in doc.get("primitives", []) or []:
        p = ParamSet(raw)
        name = p.get_string("name")
        if p.get_string("type", "model") == "model":
            if p.get_bool("is_camera_lens", False):
                raise _unsupported("camera-lens model", "6b")
            models[name] = {"geometry": p.get_string("geometry"),
                            "material": p.get_string("material")}
            continue
        model = models.get(p.get_string("model"))
        if model is None:
            raise ValueError(f"instance {name!r}: unknown model "
                             f"{p.get_string('model')!r}")
        geo = geometries.get(model["geometry"])
        if geo is None:
            raise ValueError(f"model {p.get_string('model')!r}: unknown "
                             f"geometry {model['geometry']!r}")
        if isinstance(geo, str):
            raise _unsupported(f"{geo} primitive", "6b")
        builder.add_instance(InstanceRecord(
            mesh=geo, material=materials.get(model["material"], 0),
            to_world=get_transform(p)))

    return builder.bake(device)
