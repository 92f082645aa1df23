"""The whole path-tracing slice: goblin_tpu_torch vs goblin_tpu on a small
bunny render, the port's independence from JAX, its CLI, and the
loader's refusal of features outside the slice."""

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
from goblin_tpu_torch.integrators import common as tcommon
from goblin_tpu_torch.scene import loader as tloader

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUNNY = os.path.join(REPO, "examples", "bunny.json")


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
    with goblin_tpu_torch, and never imports jax or goblin_tpu."""
    scene = _two_triangle_scene(tmp_path)
    script = textwrap.dedent(f"""
        import sys
        from goblin_tpu_torch.render import render_context
        img, meta = render_context({scene!r}, device="cpu")
        assert tuple(img.shape) == (4, 4, 3), img.shape
        assert bool(img.isfinite().all()) and float(img.mean()) > 0
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


UNSUPPORTED = {
    "sphere primitive": _with(_with(
        _with(TWO_TRIANGLES, "geometries",
              {"name": "s", "type": "sphere", "radius": 0.5}),
        "primitives", {"type": "model", "name": "sm", "geometry": "s",
                       "material": "m"}),
        "primitives", {"type": "instance", "name": "s1", "model": "sm"}),
    "area light": _with(TWO_TRIANGLES, "lights",
                        {"type": "area", "geometry": "quad"}),
    "image texture": _with(TWO_TRIANGLES, "textures",
                           {"name": "i", "type": "image", "file": "x.exr"}),
    "blinn material": _with(TWO_TRIANGLES, "materials",
                            {"name": "b", "type": "blinn"}),
    "mask material": _with(TWO_TRIANGLES, "materials",
                           {"name": "k", "type": "mask", "material": "m"}),
    "volume": dict(TWO_TRIANGLES, volume={"type": "homogeneous"}),
    "lens camera": dict(TWO_TRIANGLES, camera=dict(
        TWO_TRIANGLES["camera"], lens_radius=0.1)),
}


@pytest.mark.parametrize("name", sorted(UNSUPPORTED))
def test_loader_refuses_features_outside_the_slice(tmp_path, name):
    _two_triangle_scene(tmp_path)
    path = tmp_path / "x.json"
    path.write_text(json.dumps(UNSUPPORTED[name]))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tloader.load_scene(str(path), device="cpu")


def test_bake_refuses_trees_deeper_than_the_kernel_stack(tmp_path,
                                                        monkeypatch):
    from goblin_tpu_torch.scene import bake

    monkeypatch.setattr(bake, "STACK", 8)  # bunny's BVH8 needs 7 * 6 + 1
    with pytest.raises(ValueError, match="stack"):
        tloader.load_scene(BUNNY, device="cpu")


def test_other_integrators_refused(tmp_path):
    _, meta = tloader.load_scene(_two_triangle_scene(tmp_path),
                                 {"render_method": "sppm"}, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        trender.make_li(meta)
