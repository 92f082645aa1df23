"""JSON scene loader (port of goblin_tpu/scene/loader.py): every part of
the reference schema that goblin_tpu loads.

Meshes (OBJ), analytic spheres and disks placed by instances, constant /
checkerboard / scale / image textures of color and float format with uv or
spherical mapping, bump and normal maps, lambert / blinn / transparent /
mirror / subsurface / mask materials, point / spot / directional / area /
image-based lights, a homogeneous or heterogeneous (Mitsuba .vol) volume,
perspective (pinhole or thin-lens) and orthographic cameras, box /
triangle / gaussian / mitchell film filters, tone mapping, bloom, and EXR
or PPM output. A texture, environment or density-grid file that does not
load, an unknown material, light or texture type, mapping or channel
raises ValueError, where goblin_tpu prints and goes on; nothing is
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
import struct
import zlib

import numpy as np
import torch

from ..camera.camera import CameraSpec
from ..camera.film import FilmSpec, FilterSpec
from ..geometry.mesh import load_obj
from ..integrators.volume import VolumeSpec, load_vol
from ..io.exr import read_exr
from ..lights.lights import (LIGHT_AREA, LIGHT_DIRECTIONAL, LIGHT_IBL,
                             LIGHT_POINT, LIGHT_SPOT)
from ..shading.bsdf import (MAT_BLINN, MAT_LAMBERT, MAT_MASK, MAT_MIRROR,
                            MAT_SUBSURFACE, MAT_TRANSPARENT)
from ..shading.bssrdf import convert_from_diffuse, fresnel_a
from ..shading.textures import (ADDRESS_BORDER, ADDRESS_CLAMP, ADDRESS_REPEAT,
                                FILTER_BILINEAR, FILTER_EWA, FILTER_NEAREST,
                                FILTER_TRILINEAR, MAP_SPHERICAL,
                                TEX_CHECKERBOARD, TEX_CONSTANT, TEX_IMAGE,
                                TEX_SCALE, TexSpec)
from .bake import InstanceRecord, MatSpec, SceneBuilder
from .params import ParamSet, get_quaternion, get_transform


def _add_black(builder) -> int:
    """A new black Lambert material over a new black texture -> its row."""
    return builder.add_material(MatSpec(
        kind=MAT_LAMBERT, tex_c0=builder.add_color_texture(
            TexSpec(value=np.zeros(3, np.float32)))))


def _resolve_path(scene_dir, p):
    return p if os.path.isabs(p) else os.path.join(scene_dir, p)


_FILTERS = {"nearest": FILTER_NEAREST, "bilinear": FILTER_BILINEAR,
            "trilinear": FILTER_TRILINEAR, "EWA": FILTER_EWA}
_ADDRESSES = {"repeat": ADDRESS_REPEAT, "clamp": ADDRESS_CLAMP,
              "border": ADDRESS_BORDER}


def _read_image(path, what):
    """An EXR file as (H, W, 3) float32; a file that does not load raises
    ValueError naming what it was for."""
    try:
        return read_exr(path)
    except (OSError, ValueError, IndexError, struct.error, zlib.error) as e:
        raise ValueError(f"{what} {path!r} failed to load: {e}") from e


def _load_texture_image(path, channel, fmt):
    """An image file as (H, W, 3) texels with the channel selection done
    (reference convertTexel, src/GoblinTexture.cpp:486-518): R / G / B
    replicate that channel, A reads 1 where the file has no alpha, and
    "All" keeps RGB for a color texture and takes the Rec.709 luminance
    for a float one."""
    img = _read_image(path, "texture image")
    if channel in ("R", "G", "B"):
        c = "RGB".index(channel)
        return np.repeat(img[:, :, c:c + 1], 3, axis=2)
    if channel == "A":
        # the reader returns RGB: an absent alpha is 1 (the EXR default)
        return np.ones_like(img)
    if channel != "All":
        raise ValueError(f"texture image {path!r}: unrecognized channel "
                         f"{channel!r}")
    if fmt == "float":
        lum = (0.212671 * img[:, :, 0:1] + 0.715160 * img[:, :, 1:2]
               + 0.072169 * img[:, :, 2:3])
        return np.repeat(lum.astype(np.float32), 3, axis=2)
    return img


def _parse_texture(out, p, scene_dir, color_tex, float_tex):
    """Add one entry of the scene's textures section to out, the scene being
    built, and file its id under its name, in the namespace of its format. A checkerboard's
    or scale node's child that is not (yet) declared resolves to texture 0,
    the error asset, as in goblin_tpu."""
    fmt = p.get_string("format", "color")
    kind = p.get_string("type", "constant")
    mapping = p.get_string("mapping", "uv")
    ms = p.get_vec2("scale", (1.0, 1.0)) if kind != "scale" else (1.0, 1.0)
    mo = p.get_vec2("offset", (0.0, 0.0))
    # spherical mapping: the texture's own position / orientation / scale,
    # applied forward to the world-space hit point (reference
    # getTextureMapping and SphericalMapping::pointToST,
    # src/GoblinTexture.cpp:600-613, 339-347)
    map_kw = {"map_scale": (float(ms[0]), float(ms[1])),
              "map_offset": (float(mo[0]), float(mo[1]))}
    if mapping == "spherical":
        map_kw.update(mapping=MAP_SPHERICAL, world_to_tex=get_transform(p))
    elif mapping != "uv":
        raise ValueError(f"texture {p.get_string('name')!r}: undefined "
                         f"mapping type {mapping!r}")
    table = color_tex if fmt == "color" else float_tex
    add = out.add_color_texture if fmt == "color" else out.add_float_texture
    if kind == "constant":
        if fmt == "color":
            val = p.get_vec3("color", (0.5, 0.5, 0.5))
        else:
            val = np.full(3, p.get_float("float", 0.5), np.float32)
        spec = TexSpec(kind=TEX_CONSTANT, value=np.asarray(val, np.float32))
    elif kind == "checkerboard":
        spec = TexSpec(kind=TEX_CHECKERBOARD,
                       child0=table.get(p.get_string("texture1"), 0),
                       child1=table.get(p.get_string("texture2"), 0),
                       checker_filter=p.get_bool("filter", False), **map_kw)
    elif kind == "scale":
        if fmt == "color":
            sc = p.get_vec3("scale", (1.0, 1.0, 1.0))
        else:
            sc = np.full(3, p.get_float("scale", 1.0), np.float32)
        spec = TexSpec(kind=TEX_SCALE,
                       child0=table.get(p.get_string("texture"), 0),
                       scale=np.asarray(sc, np.float32))
    elif kind == "image":
        img = _load_texture_image(
            _resolve_path(scene_dir, p.get_string("file")),
            p.get_string("channel", "All"), fmt)
        spec = TexSpec(
            kind=TEX_IMAGE, image=img,
            filter=_FILTERS.get(p.get_string("filter", "nearest"),
                                FILTER_BILINEAR),
            address=_ADDRESSES.get(p.get_string("address", "repeat"),
                                   ADDRESS_REPEAT),
            gamma=p.get_float("gamma", 1.0),
            max_anisotropy=p.get_float("max_anisotropy", 10.0), **map_kw)
    else:
        raise ValueError(f"texture {p.get_string('name')!r}: unknown type "
                         f"{kind!r}")
    table[p.get_string("name")] = add(spec)


def _parse_volume(vp, scene_dir):
    """The scene's volume section -> (VolumeSpec, density grid or None). A
    heterogeneous volume's box is its grid file's; a grid that does not load
    raises ValueError (goblin_tpu prints and renders an empty 1 x 1 x 1
    grid)."""
    m = get_transform(vp)
    m_inv = np.linalg.inv(m)
    common = dict(to_world=tuple(m.reshape(-1).tolist()),
                  to_local=tuple(m_inv.reshape(-1).tolist()),
                  g=vp.get_float("g", 0.0),
                  sample_num=vp.get_int("sample_num", 5),
                  step_size=vp.get_float("step_size", 0.1))
    if vp.get_string("type", "homogeneous") == "heterogeneous":
        gpath = _resolve_path(scene_dir, vp.get_string("density_grid"))
        try:
            grid, gb = load_vol(gpath)
        except (OSError, ValueError, struct.error) as e:
            raise ValueError(f"density grid {gpath!r} failed to load: "
                             f"{e}") from e
        return VolumeSpec(
            kind="heterogeneous",
            box_min=tuple(float(v) for v in gb[:3]),
            box_max=tuple(float(v) for v in gb[3:]),
            albedo=_vec3(vp, "albedo", (0.5, 0.5, 0.5)),
            grid_shape=tuple(int(x) for x in grid.shape), **common), grid
    return VolumeSpec(
        kind="homogeneous",
        box_min=_vec3(vp, "box_min", (0.0, 0.0, 0.0)),
        box_max=_vec3(vp, "box_max", (1.0, 1.0, 1.0)),
        attenuation=_vec3(vp, "attenuation", (0.0, 0.0, 0.0)),
        albedo=_vec3(vp, "albedo", (0.0, 0.0, 0.0)),
        emission=_vec3(vp, "emission", (0.0, 0.0, 0.0)), **common), None


def _vec3(p, key, default):
    return tuple(float(v) for v in p.get_vec3(key, default))


# the marble of the reference's defaults (src/GoblinMaterial.cpp:909, 919)
MARBLE_ABSORB = (0.0021, 0.0041, 0.0071)
MARBLE_SCATTER_PRIME = (2.19, 2.62, 3.00)


def _subsurface_spec(p, raw, builder, color_tex):
    """A subsurface material: with Kd, its sigmas from Kd and mean_free_path
    by convertFromDiffuse (src/GoblinMaterial.cpp:177-212, 884-902); else
    absorb and scatter_prime, each a list or the name of a color texture
    (its constant value), marble by default."""
    spec = MatSpec(kind=MAT_SUBSURFACE,
                   tex_c0=_color_tex_id(builder, color_tex, p, "Kr",
                                        (1.0, 1.0, 1.0)),
                   eta=p.get_float("index", 1.5), g=p.get_float("g", 0.0))
    if p.has("Kd"):
        sa, ssp = convert_from_diffuse(
            p.get_vec3("Kd", (0.5, 0.5, 0.5)),
            p.get_vec3("mean_free_path", (1.0, 1.0, 1.0)), fresnel_a(spec.eta))
        spec.absorb = tuple(float(v) for v in sa)
        spec.scatter_prime = tuple(float(v) for v in ssp)
        return spec

    def sigma(key, default):
        v = raw.get(key)
        if isinstance(v, str):
            tid = color_tex.get(v, -1)
            if tid < 0:
                return default
            return tuple(float(x)
                         for x in builder.color_textures[tid].value[:3])
        return default if v is None else tuple(float(x) for x in v)

    spec.absorb = sigma("absorb", MARBLE_ABSORB)
    spec.scatter_prime = sigma("scatter_prime", MARBLE_SCATTER_PRIME)
    return spec


def _color_tex_id(builder, color_tex, p, key, default=None):
    """The named color texture's row; a new constant where the name is
    unknown and a default is given; else the error magenta."""
    name = p.get_string(key, "")
    if name in color_tex:
        return color_tex[name]
    if default is not None:
        return builder.add_color_texture(
            TexSpec(value=np.asarray(default, np.float32)))
    return 0


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
        "ao_sample_num": rs.get_int("ao_sample_num", 25),
        "bssrdf_sample_num": rs.get_int("bssrdf_sample_num", 4),
        "initial_radius": rs.get_float("initial_radius", -1.0),
        # BDPT's strategy isolation (reference GoblinBDPT.cpp:59-63)
        "debug_s": rs.get_int("debug_s", -1),
        "debug_t": rs.get_int("debug_t", -1),
        "debug_no_mis": rs.get_bool("debug_no_mis", False),
        # the light tracer's estimator: t1 | t0 | s1 (the reference's
        # compile-time splatFilm alternates, src/GoblinLightTracer.h:30-46)
        "lt_strategy": rs.get_string("lt_strategy", "t1"),
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
    res = film_p.get_vec2("resolution", (512.0, 512.0))
    default_out = os.path.splitext(os.path.basename(path))[0] + ".exr"
    out_file = film_p.get_string("file", os.path.join(scene_dir, default_out))
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
            tone_mapping=film_p.get_bool("tone_mapping", False),
            bloom_radius=film_p.get_float("bloom_radius", 0.0),
            bloom_weight=film_p.get_float("bloom_weight", 0.0),
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
        builder.volume, builder.vol_grid = _parse_volume(
            ParamSet(doc["volume"]), scene_dir)

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
        _parse_texture(builder, ParamSet(raw), scene_dir, color_tex, float_tex)

    def color_tex_id(p, key, default=None):
        return _color_tex_id(builder, color_tex, p, key, default)

    def float_tex_id(p, key, default=None):
        name = p.get_string(key, "")
        if name in float_tex:
            return float_tex[name]
        if default is not None:
            return builder.add_float_texture(
                TexSpec(value=np.full(3, float(default), np.float32)))
        return 0

    # --- materials
    materials: dict[str, int] = {}
    for raw in doc.get("materials", []) or []:
        p = ParamSet(raw)
        mkind = p.get_string("type", "lambert")
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
            spec = _subsurface_spec(p, raw, builder, color_tex)
        else:
            raise ValueError(f"unknown material type {mkind!r}")
        if p.has("bumpmap"):
            spec.bump_tex = float_tex_id(p, "bumpmap")
        if p.has("normalmap"):
            spec.normal_tex = color_tex_id(p, "normalmap")
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
            # the map, its filter and its orientation (goblin_tpu/scene/
            # loader.py:485-500)
            img = _read_image(_resolve_path(scene_dir, p.get_string("file")),
                              "environment map")
            filt = p.get_vec3("filter", (1.0, 1.0, 1.0))
            builder.env_light_id = builder.lights.add(
                LIGHT_IBL, filt, sample_num=p.get_int("sample_num", 1))
            builder.env_image = img
            builder.env_filter = filt
            builder.env_orientation = get_quaternion(p)
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
