"""The whole path-tracing slice: goblin_tpu_torch vs goblin_tpu on a small
bunny render, the port's independence from JAX, its CLI, and the
features the loader once refused, which load now."""

import copy
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from goblin_tpu.integrators import common as jcommon
from goblin_tpu.integrators.path import make_li as j_make_li
from goblin_tpu.scene import loader as jloader
from goblin_tpu_torch import render as trender
from goblin_tpu_torch.camera import film as tfilm
from goblin_tpu_torch.integrators import common as tcommon
from goblin_tpu_torch.scene import loader as tloader

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUNNY = os.path.join(REPO, "examples", "bunny.json")
STUDIO = os.path.join(REPO, "examples", "bunny_studio.json")
GALLERY = os.path.join(REPO, "examples", "bunny_gallery.json")
SKY = os.path.join(REPO, "examples", "bunny_sky.json")
SMOKE = os.path.join(REPO, "examples", "bunny_smoke.json")


def _bunny_copy(tmp_path, x_res, y_res, spp, depth, **edits):
    """bunny.json (both OBJ files alongside) at another size and setting."""
    os.makedirs(tmp_path / "models", exist_ok=True)
    for name in ("bunny.obj", "plane.obj"):
        shutil.copy(os.path.join(REPO, "examples", "models", name),
                    tmp_path / "models" / name)
    with open(BUNNY) as f:
        doc = json.load(f)
    doc["render_setting"] = {"sample_per_pixel": spp, "max_ray_depth": depth,
                             "render_method": "path_tracing"}
    doc["camera"]["film"]["resolution"] = [x_res, y_res]
    for key, value in edits.items():
        doc[key] = value
    path = tmp_path / "bunny.json"
    path.write_text(json.dumps(doc))
    return str(path)


def test_bunny_slice_matches_goblin_tpu(tmp_path, monkeypatch):
    """32 x 24, 1 spp, depth 5. Same sample streams and the same tree:
    the images differ only where float rounding flips a discrete choice
    (a refraction / TIR pick, a tie), so nearly every pixel agrees."""
    path = _bunny_copy(tmp_path, 32, 24, 1, 5)
    monkeypatch.setenv("GOBLIN_TRACE", "pallas")
    js, jm = jloader.load_scene(path)
    jm = dataclasses.replace(jm, trace_backend="jnp")
    ref = np.asarray(jcommon.render(js, jm, j_make_li(jm)))
    ts, tm = tloader.load_scene(path, device="cpu")
    got = tcommon.render(ts, tm, trender.make_li(tm)).numpy()
    assert got.shape == ref.shape == (24, 32, 3)
    assert np.isfinite(got).all()
    close = np.abs(got - ref) <= 1e-4 + 1e-3 * np.abs(ref)
    assert close.all(axis=-1).mean() >= 0.99
    assert abs(got.mean() - ref.mean()) <= 1e-3 * abs(ref.mean())
    assert got.mean() > 0


def test_census_matches_goblin_tpu(tmp_path, monkeypatch):
    """make_li(meta, with_stats=True) on bunny.json at 16 x 12, depth 5:
    the shadow rays considered and the continuation rays traced of every
    bounce equal goblin_tpu's (0 traced for the peeled last bounce: the
    spot light is a delta light), and L is bit for bit the L of make_li
    without the census."""
    import jax.numpy as jnp

    from goblin_tpu_torch.integrators.path import make_li as t_path_li

    path = _bunny_copy(tmp_path, 16, 12, 1, 5)
    monkeypatch.setenv("GOBLIN_TRACE", "pallas")
    js, jm = jloader.load_scene(path)
    jm = dataclasses.replace(jm, trace_backend="jnp")
    ts, tm = tloader.load_scene(path, device="cpu")
    ids = np.arange(16 * 12, dtype=np.int32)

    def rays(common, cam, ids, s):
        x, y = common.pixel_samples(0, ids, 16, s, 1)
        return cam.generate_ray(x, y)

    _, (j_cons, j_cont) = j_make_li(jm, with_stats=True)(
        js, jm, rays(jcommon, jm.camera, jnp.asarray(ids), jnp.int32(0)),
        jnp.asarray(ids), jnp.int32(0), 0)
    t_ids = torch.as_tensor(ids)
    ray = rays(tcommon, tm.camera, t_ids, 0)
    L, (cons, cont) = t_path_li(tm, with_stats=True)(ts, tm, ray, t_ids, 0, 0)
    assert cons.dtype == cont.dtype == torch.int32
    assert cons.tolist() == np.asarray(j_cons).tolist()
    assert cont.tolist() == np.asarray(j_cont).tolist()
    assert len(cons) == 4 and cont[-1] == 0 and cons[-1] > 0
    assert 0 < int(cont[0]) <= 16 * 12
    assert torch.equal(L, t_path_li(tm)(ts, tm, ray, t_ids, 0, 0))


TWO_TRIANGLES = {
    "render_setting": {"sample_per_pixel": 1, "max_ray_depth": 3,
                       "render_method": "path_tracing"},
    "camera": {"position": [0, 0, -3], "fov": 60,
               "film": {"resolution": [4, 4]},
               "filter": {"type": "gaussian", "width": [2, 2]}},
    "geometries": [{"name": "quad", "type": "mesh", "file": "quad.obj"}],
    "textures": [{"format": "color", "name": "w", "type": "constant",
                  "color": [0.8, 0.8, 0.8]}],
    "materials": [{"name": "m", "type": "lambert", "Kd": "w"}],
    "lights": [{"type": "point", "intensity": [5, 5, 5],
                "position": [0, 0, -2]}],
    "primitives": [{"type": "model", "name": "q", "geometry": "quad",
                    "material": "m"},
                   {"type": "instance", "name": "q", "model": "q"}],
}


def _two_triangle_scene(tmp_path):
    """The scene file; its image goes to the default quad.exr beside it."""
    (tmp_path / "quad.obj").write_text(
        "v -1 -1 0\nv 1 -1 0\nv 1 1 0\nv -1 1 0\nf 1 2 3\nf 1 3 4\n")
    path = tmp_path / "quad.json"
    path.write_text(json.dumps(TWO_TRIANGLES))
    return str(path)


def test_port_imports_neither_jax_nor_goblin_tpu(tmp_path):
    """A fresh interpreter loads and renders a two-triangle scene on the CPU
    with goblin_tpu_torch, by path tracing and by SPPM at the trace widths,
    then the studio scene (every feature of its slice) at width 4, the
    gallery scene (the texture chain) under whitted, the sky scene (the
    map) under bdpt and the smoke scene (a heterogeneous volume and
    subsurface materials), takes a train step and an edge-sampled boundary
    gradient, renders by the regenerative driver and by a one-process
    sharded pass, calls the rest of core/ and the sphere mesh, and never
    imports jax or goblin_tpu."""
    scene = _two_triangle_scene(tmp_path)
    script = textwrap.dedent(f"""
        import dataclasses, sys
        from goblin_tpu_torch.integrators import common
        from goblin_tpu_torch.render import make_li, render_context
        from goblin_tpu_torch.scene.loader import load_scene
        for ovr, wide in (({{}}, 8), ({{}}, 4), ({{"render_method": "sppm"}}, 8),
                          ({{"render_method": "sppm"}}, 1)):
            img, meta = render_context({scene!r}, ovr, device="cpu",
                                       trace_wide=wide)
            assert tuple(img.shape) == (4, 4, 3), img.shape
            assert bool(img.isfinite().all()) and float(img.mean()) > 0
        scene, meta = load_scene({STUDIO!r}, {{"sample_per_pixel": 1}},
                                 device="cpu", trace_wide=4)
        film = dataclasses.replace(meta.camera.film, x_res=16, y_res=12)
        meta.camera = dataclasses.replace(meta.camera, film=film)
        img = common.render(scene, meta, make_li(meta))
        assert tuple(img.shape) == (12, 16, 3), img.shape
        assert bool(img.isfinite().all()) and float(img.mean()) > 0
        assert meta.trace_wide == 4 and meta.has_null and meta.n_spheres == 2
        scene, meta = load_scene({GALLERY!r}, {{"render_method": "whitted",
                                 "sample_per_pixel": 1, "max_ray_depth": 1}},
                                 device="cpu")
        film = dataclasses.replace(meta.camera.film, x_res=16, y_res=12)
        meta.camera = dataclasses.replace(meta.camera, film=film)
        img = common.render(scene, meta, make_li(meta))
        assert tuple(img.shape) == (12, 16, 3), img.shape
        assert bool(img.isfinite().all()) and float(img.mean()) > 0
        assert meta.has_perturb and scene["tex_atlas"].numel() > 100000
        scene, meta = load_scene({SKY!r}, {{"render_method": "bdpt",
                                 "sample_per_pixel": 1, "max_ray_depth": 3}},
                                 device="cpu")
        film = dataclasses.replace(meta.camera.film, x_res=16, y_res=12)
        meta.camera = dataclasses.replace(meta.camera, film=film)
        from goblin_tpu_torch.splatting import render_dispatch
        img = render_dispatch(scene, meta, "bdpt")
        assert tuple(img.shape) == (12, 16, 3), img.shape
        assert bool(img.isfinite().all()) and float(img.mean()) > 0
        assert meta.has_env and "env" in scene
        scene, meta = load_scene({SMOKE!r}, {{"sample_per_pixel": 1,
                                 "max_ray_depth": 2}}, device="cpu")
        film = dataclasses.replace(meta.camera.film, x_res=8, y_res=6)
        meta.camera = dataclasses.replace(meta.camera, film=film)
        img = common.render(scene, meta, make_li(meta))
        assert tuple(img.shape) == (6, 8, 3), img.shape
        assert bool(img.isfinite().all()) and float(img.mean()) > 0
        assert meta.has_bssrdf and meta.volume.kind == "heterogeneous"
        import numpy as np, torch
        from goblin_tpu_torch.integrators import edge_grad
        from goblin_tpu_torch.parallel.mesh import make_train_step
        scene, meta = load_scene({scene!r}, device="cpu")
        step = make_train_step(scene, meta, make_li(meta))
        loss, (g_light, g_atlas) = step(
            (scene["lights"]["color"], scene["tex_atlas"]),
            torch.arange(16, dtype=torch.int32), 0)
        assert float(loss) > 0 and bool(g_light.isfinite().all())
        assert g_atlas.shape == scene["tex_atlas"].shape
        faces = np.int32([[0, 2, 1], [0, 1, 3], [1, 2, 3], [2, 0, 3]])
        verts = np.float32([[0.15, 1, 0], [0.55, 1, 0.25], [0.4, 1, -0.3],
                            [0.35, 1.25, 0]])
        g = edge_grad.mesh_boundary_grad(
            torch.zeros(3), [0, 1, 0], [0.8, 0.6, 0.4],
            [[-1, 2, -1], [1, 2, -1], [1, 2, 1], [-1, 2, 1]], [0, -1, 0],
            [5, 5, 5], verts, faces, edge_grad.build_edge_adjacency(faces),
            np.tile(np.float32([1, 0, 0]), (4, 1)))
        assert g.shape == (3,) and bool((g != 0).all())
        from goblin_tpu_torch.integrators import wavefront
        from goblin_tpu_torch.parallel import mesh as pmesh
        img, meta = render_context({scene!r}, device="cpu", regen=True)
        assert wavefront.supports(meta) and tuple(img.shape) == (4, 4, 3)
        scene, meta = load_scene({scene!r}, device="cpu")
        mesh = pmesh.make_mesh(device="cpu")
        img = pmesh.render_sharded_dense(scene, meta, make_li(meta), mesh)
        assert tuple(img.shape) == (4, 4, 3) and float(img.mean()) > 0
        from goblin_tpu_torch.core import sampling, vecmath
        from goblin_tpu_torch.geometry import intersect, mesh as gmesh
        q = vecmath.euler_to_quat([0.0, 0.0, 90.0])
        m = vecmath.compose_matrix([0.0, 0.0, 0.0], q, [1.0, 1.0, 1.0])
        assert vecmath.transform_point(m, torch.ones(3)).shape == (3,)
        assert sampling.primes(3) == [2, 3, 5]
        sphere = gmesh.make_sphere_mesh(1.0, 4, 8)
        assert sphere.num_faces == 48
        bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
               or m == "goblin_tpu" or m.startswith("goblin_tpu.")]
        assert not bad, bad
        print("OK")
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", script], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "OK"


def test_cli_renders_on_cpu(tmp_path):
    scene = _two_triangle_scene(tmp_path)
    assert trender.main([scene, "path_tracing", "--device", "cpu"]) == 0
    assert os.path.getsize(tmp_path / "quad.exr") > 0


def test_cli_refuses_cuda_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: there is nothing to refuse")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        trender.main([_two_triangle_scene(tmp_path)])


def _with(doc, section, entry):
    doc = copy.deepcopy(doc)
    doc.setdefault(section, []).append(entry)
    return doc


def _film(**film):
    doc = copy.deepcopy(TWO_TRIANGLES)
    doc["camera"]["film"].update(film)
    return doc


# features that earlier slices refused, each now loaded (the refusal cases
# kept their names as the features came: textures and bump maps in the
# texture slice, bdpt and the image-based light in the slice after it,
# tone mapping, bloom, non-EXR output, subsurface materials and volumes in
# this one), and one the loader refuses as goblin_tpu does not: an unknown
# material type (goblin_tpu renders it as its default Lambert)
SUBSURFACE = {"name": "k", "type": "subsurface"}
IBL = {"type": "ibl", "file": "x.exr"}
HOMOGENEOUS = {"type": "homogeneous", "box_min": [-2, -2, -4],
               "box_max": [2, 2, 1], "attenuation": [0.3, 0.3, 0.3],
               "albedo": [0.5, 0.5, 0.5]}
UNSUPPORTED = {
    "tone mapping": _film(tone_mapping=True),
    "bloom": _film(bloom_radius=0.1, bloom_weight=0.5),
    "non-EXR output": _film(file="out.ppm"),
    "bdpt": dict(TWO_TRIANGLES, render_setting={"render_method": "bdpt"},
                 volume=HOMOGENEOUS),
    "subsurface material": _with(TWO_TRIANGLES, "materials", SUBSURFACE),
    "volume": dict(TWO_TRIANGLES, volume=HOMOGENEOUS),
    "image-based light": _with(_with(TWO_TRIANGLES, "lights", IBL),
                               "materials", SUBSURFACE),
    "unknown material type": _with(TWO_TRIANGLES, "materials",
                                   {"name": "u", "type": "velvet"}),
}
STILL_REFUSED = {"unknown material type": (ValueError, "unknown material")}


@pytest.mark.parametrize("name", sorted(UNSUPPORTED))
def test_loader_refuses_features_outside_the_slice(tmp_path, name):
    """Every feature that goblin_tpu loads, the port loads now: each case an
    earlier slice refused renders finite on the CPU, its film written as
    the film asks. The loader still refuses what goblin_tpu would skip
    silently, and skips nothing."""
    from goblin_tpu_torch.io.exr import write_exr

    _two_triangle_scene(tmp_path)
    write_exr(str(tmp_path / "x.exr"), np.full((4, 8, 3), 0.5, np.float32))
    path = tmp_path / "x.json"
    path.write_text(json.dumps(UNSUPPORTED[name]))
    if name in STILL_REFUSED:
        err, match = STILL_REFUSED[name]
        with pytest.raises(err, match=match):
            trender.render_context(str(path), device="cpu")
        return
    img, meta = trender.render_context(str(path), device="cpu")
    assert tuple(img.shape) == (4, 4, 3)
    assert bool(img.isfinite().all()) and float(img.mean()) > 0
    out = tmp_path / "written"
    out.mkdir()
    spec = dataclasses.replace(meta.camera.film, filename=str(
        out / os.path.basename(meta.camera.film.filename)))
    written = tfilm.write_image(spec, img)
    assert os.path.getsize(written) > 0
    assert written.endswith(".ppm" if name == "non-EXR output" else ".exr")


def test_bake_refuses_trees_deeper_than_the_kernel_stack(tmp_path,
                                                        monkeypatch):
    from goblin_tpu_torch.ops import trace as ttrace

    # the kernel keeps one stack entry per level; bunny's BVH8 has 6
    monkeypatch.setattr(ttrace, "WIDE_LEVELS", 5)
    with pytest.raises(ValueError, match="stack levels"):
        tloader.load_scene(BUNNY, device="cpu")


def test_other_integrators_refused(tmp_path):
    """make_li has no batched Li for a splatting method (goblin_tpu's
    ValueError); bdpt, refused until it was ported, reaches it too."""
    path = _two_triangle_scene(tmp_path)
    for method in ("bdpt", "light_tracing", "sppm", "unknown"):
        _, meta = tloader.load_scene(path, {"render_method": method},
                                     device="cpu")
        with pytest.raises(ValueError, match="no batched Li"):
            trender.make_li(meta)


def test_bdpt_and_image_based_lights_render(tmp_path):
    """The two features this slice brought, through render_context: bdpt
    on the two-triangle scene, and the scene lit by a map as well under
    every method."""
    from goblin_tpu_torch.io.exr import write_exr

    _two_triangle_scene(tmp_path)
    write_exr(str(tmp_path / "x.exr"), np.full((4, 8, 3), 0.5, np.float32))
    every = ("path_tracing", "ao", "whitted", "light_tracing", "bdpt", "sppm")
    for doc, methods in ((TWO_TRIANGLES, ("bdpt",)),
                         (_with(TWO_TRIANGLES, "lights", IBL), every)):
        path = tmp_path / "x.json"
        path.write_text(json.dumps(doc))
        for method in methods:
            img, meta = trender.render_context(
                str(path), {"render_method": method}, device="cpu")
            assert tuple(img.shape) == (4, 4, 3), method
            assert bool(img.isfinite().all()) and float(img.mean()) > 0, method
    assert meta.has_env and meta.n_lights == 2
