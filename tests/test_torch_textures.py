"""The texture chain of goblin_tpu_torch against goblin_tpu's on the CPU:
the EXR reader, the MIP pyramid, the baked atlas and tables, eval_all lane
by lane for every node kind, filter, address mode and mapping, the loader's
texture section, _perturb (bump and normal maps) and gather_material on
fragments, the mirrors of tests/test_texchain.py's cases, and
examples/bunny_gallery.json (tables, texture file, path tracing).

Inputs come from a numpy seed and go to both packages. goblin_tpu runs op by
op here (no jit), so XLA contracts nothing into fused multiply-adds and both
packages round alike: values are held to atol 2e-5 (1e-4 under the
spherical mapping, whose acos / atan2 differ in the last bit between XLA and
PyTorch, times a 256-texel width). Bilinear, trilinear and EWA lookups and
the filtered checkerboard are continuous in uv and in the MIP level, so
they are compared on every lane. The nearest filter and the unfiltered
checkerboard pick a texel or a square by a floor: there lanes within 1e-3
of a texel / square boundary are left out and the rest must agree.
Baked tables, pyramids and discrete picks are equal bit for bit.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goblin_tpu.camera import film as jfilm
from goblin_tpu.core.rng import hash_uniform as j_hash
from goblin_tpu.integrators import common as jcommon
from goblin_tpu.integrators.materials import gather_material as j_gather
from goblin_tpu.integrators.path import make_li as j_path_li
from goblin_tpu.io import exr as jexr
from goblin_tpu.scene import intersect as jscn
from goblin_tpu.shading import textures as jt
from goblin_tpu_torch import assets
from goblin_tpu_torch.integrators import common as tcommon
from goblin_tpu_torch.integrators.materials import gather_material as t_gather
from goblin_tpu_torch.io import exr as texr
from goblin_tpu_torch.render import make_li as t_make_li
from goblin_tpu_torch.scene import intersect as tscn
from goblin_tpu_torch.scene import loader as tloader
from goblin_tpu_torch.shading import textures as tt
from test_torch_studio import _bar, _load_both, _np, _resized

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GALLERY = os.path.join(REPO, "examples", "bunny_gallery.json")
GALLERY_EXR = os.path.join(REPO, "examples", "textures", "gallery.exr")
ATOL = 2e-5
SPHERICAL_ATOL = 1e-4
EDGE = 1e-3  # texel / square units left out around a floor's boundary

UV_PLANE_OBJ = ("v -1 0 -1\nv 1 0 -1\nv 1 0 1\nv -1 0 1\n"
                "vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\nvn 0 1 0\n"
                "f 1/1/1 2/2/1 3/3/1\nf 1/1/1 3/3/1 4/4/1\n")


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """Two intra-op threads while this module's tests run: the suite runs
    in several worker processes on few cores, where PyTorch's default of a
    thread a core makes the large wavefronts several times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.as_tensor(np.array(a))


def _image(seed, h, w, c=3):
    return np.random.default_rng(seed).uniform(0, 1, (h, w, c)).astype(
        np.float32)


def _both_systems(spec_kwargs):
    """The same spec list baked by both packages."""
    return (jt.TextureSystem([jt.TexSpec(**kw) for kw in spec_kwargs]),
            tt.TextureSystem([tt.TexSpec(**kw) for kw in spec_kwargs]))


def _lanes(seed, n=3000):
    """uv in [-2, 3) (negative and > 1 included), footprints spanning
    sub-texel to many texels, and world positions."""
    rng = np.random.default_rng(seed)
    uv = rng.uniform(-2.0, 3.0, (n, 2)).astype(np.float32)
    uv[:8] = [[0.0, 0.0], [1.0, 1.0], [-1.0, 2.0], [0.5, 0.5],
              [-0.25, 1.25], [0.999999, 1e-7], [2.0, -2.0], [1e-3, 0.75]]
    duv4 = (rng.normal(size=(n, 4))
            * 10.0 ** rng.uniform(-5, -0.5, (n, 1))).astype(np.float32)
    duv = np.stack([np.maximum(abs(duv4[:, 0]), abs(duv4[:, 2])),
                    np.maximum(abs(duv4[:, 1]), abs(duv4[:, 3]))], axis=-1)
    p = rng.normal(size=(n, 3)).astype(np.float32) * 2.0
    return uv, duv, duv4, p


def _eval_both(jsys, tsys, uv, duv=None, duv4=None, p=None):
    def j(a):
        return None if a is None else jnp.asarray(a)

    def t(a):
        return None if a is None else _t(a)

    ref = np.asarray(jsys.eval_all(j(uv), p=j(p), duv=j(duv), duv4=j(duv4)))
    got = tsys.eval_all(t(uv), _t(tsys.atlas), _t(tsys.const), p=t(p),
                        duv=t(duv), duv4=t(duv4)).numpy()
    assert got.shape == (len(tsys.specs), uv.shape[0], 3)
    # goblin_tpu's stack of childless checkerboards alone is one channel wide
    return got, np.broadcast_to(ref, got.shape)


# --- the EXR reader ---------------------------------------------------------

@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("half", [False, True])
@pytest.mark.parametrize("writer", ["goblin_tpu", "goblin_tpu_torch"])
def test_read_exr_reads_both_writers(tmp_path, writer, half, compress):
    """goblin_tpu's writer puts its offset table's values 4 bytes late; the
    reader walks the blocks in order, so both files read alike. 37 rows:
    the last ZIP block is short."""
    img = _image(3, 37, 23)
    path = str(tmp_path / "a.exr")
    (jexr if writer == "goblin_tpu" else texr).write_exr(
        path, img, half=half, compress=compress)
    got = texr.read_exr(path)
    want = img.astype(np.float16).astype(np.float32) if half else img
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jexr.read_exr(path))


def test_read_exr_refuses_what_it_cannot_read(tmp_path):
    path = tmp_path / "bad.exr"
    path.write_bytes(b"not an exr file at all")
    with pytest.raises(ValueError, match="not an EXR"):
        texr.read_exr(str(path))


# --- pyramid, atlas, tables -------------------------------------------------

@pytest.mark.parametrize("shape", [(120, 200), (64, 64), (37, 23), (1, 6),
                                   (5, 1), (2, 2)])
def test_build_pyramid_equal_level_for_level(shape):
    img = _image(sum(shape), *shape)
    ref, got = jt._build_pyramid(img), tt._build_pyramid(img)
    assert len(got) == len(ref) and got[-1].shape == (1, 1, 3)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


ATLAS_SPECS = [
    dict(kind=tt.TEX_CONSTANT, value=np.float32([0.2, 0.4, 0.6])),
    dict(kind=tt.TEX_IMAGE, image=_image(1, 20, 30), filter=tt.FILTER_NEAREST),
    dict(kind=tt.TEX_IMAGE, image=_image(2, 33, 17),
         filter=tt.FILTER_TRILINEAR, gamma=2.2),
    dict(kind=tt.TEX_SCALE, child0=1, scale=np.float32([0.5, 2.0, 1.5])),
    dict(kind=tt.TEX_IMAGE, image=_image(3, 16, 16, c=1),
         filter=tt.FILTER_EWA),
    dict(kind=tt.TEX_IMAGE, image=_image(4, 9, 12), filter=tt.FILTER_BILINEAR),
    dict(kind=tt.TEX_CHECKERBOARD, child0=3, child1=0),
    dict(kind=tt.TEX_CONSTANT, value=np.float32([0.7])),
]


def test_atlas_and_tables_equal():
    """Constants, scale factors, image offsets, the pyramids' level tables
    and the atlas itself: gamma, single-channel images, the resize of a
    non-power-of-two image, the evaluation order."""
    jsys, tsys = _both_systems(ATLAS_SPECS)
    np.testing.assert_array_equal(tsys.const, np.asarray(jsys.const))
    np.testing.assert_array_equal(tsys.atlas, np.asarray(jsys.atlas))
    assert tsys.atlas.dtype == np.float32
    assert tsys.order == jsys.order
    assert tsys.image_info == jsys.image_info
    assert set(tsys.mip_info) == set(jsys.mip_info) == {2, 4}
    for i in tsys.mip_info:
        for a, b in zip(tsys.mip_info[i], jsys.mip_info[i]):
            assert a.dtype == b.dtype == np.int32
            np.testing.assert_array_equal(a, b)
    # the 33 x 17 image is resized to 64 x 32 before its 7 levels
    assert tsys.mip_info[2][1].tolist() == [64, 32, 16, 8, 4, 2, 1]
    assert tsys.mip_info[2][2].tolist() == [32, 16, 8, 4, 2, 1, 1]


def test_empty_system_bakes():
    jsys, tsys = _both_systems([])
    np.testing.assert_array_equal(tsys.atlas, np.asarray(jsys.atlas))
    assert tsys.const.shape == (0, 3)


# --- eval_all lane by lane --------------------------------------------------

FILTERS = {"nearest": tt.FILTER_NEAREST, "bilinear": tt.FILTER_BILINEAR,
           "trilinear": tt.FILTER_TRILINEAR, "ewa": tt.FILTER_EWA}
ADDRESSES = {"repeat": tt.ADDRESS_REPEAT, "clamp": tt.ADDRESS_CLAMP,
             "border": tt.ADDRESS_BORDER}


def _away_from_texel_edges(uv, w, h, scale, offset):
    """Lanes whose u * w and v * h are at least EDGE from an integer."""
    u = uv[:, 0].astype(np.float64) * scale[0] + offset[0]
    v = uv[:, 1].astype(np.float64) * scale[1] + offset[1]
    fu, fv = (u * w) % 1.0, (v * h) % 1.0
    return ((fu > EDGE) & (fu < 1 - EDGE) & (fv > EDGE) & (fv < 1 - EDGE))


@pytest.mark.parametrize("address", sorted(ADDRESSES))
@pytest.mark.parametrize("filt", sorted(FILTERS))
def test_image_eval_matches(filt, address):
    """An image node under each filter and address mode, with a uv scale
    and offset, a 24 x 40 image (its pyramid is resized to 32 x 64) and a
    low anisotropy clamp so the EWA widening runs."""
    scale, offset = (1.5, -0.75), (0.125, 0.3)
    kw = dict(kind=tt.TEX_IMAGE, image=_image(11, 24, 40),
              filter=FILTERS[filt], address=ADDRESSES[address],
              map_scale=scale, map_offset=offset, max_anisotropy=4.0)
    jsys, tsys = _both_systems([kw])
    uv, duv, duv4, _ = _lanes(sum(map(ord, filt + address)))
    got, ref = _eval_both(jsys, tsys, uv, duv, duv4)
    ok = np.ones(len(uv), bool)
    if filt == "nearest":
        ok = _away_from_texel_edges(uv, 40, 24, scale, offset)
        assert ok.mean() > 0.9
    np.testing.assert_allclose(got[0][ok], ref[0][ok], rtol=0, atol=ATOL)
    assert np.isfinite(got).all() and got.std() > 0.05
    if address == "border":
        assert (got[0] == 0).all(axis=-1).mean() > 0.3  # lanes off the image
    # without a footprint the MIP filters are level 0's bilinear lookup
    got0, ref0 = _eval_both(jsys, tsys, uv)
    np.testing.assert_allclose(got0[0][ok], ref0[0][ok], rtol=0, atol=ATOL)
    if filt in ("trilinear", "ewa"):
        assert np.abs(got0 - got).max() > 0.05


def test_ewa_falls_back_to_trilinear_without_duv4():
    kw = dict(kind=tt.TEX_IMAGE, image=_image(5, 32, 32), filter=tt.FILTER_EWA)
    jsys, tsys = _both_systems([kw])
    uv, duv, _, _ = _lanes(6, 500)
    got, ref = _eval_both(jsys, tsys, uv, duv)
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
    tri = tt.TextureSystem([tt.TexSpec(**dict(kw, filter=tt.FILTER_TRILINEAR))])
    want = tri.eval_all(_t(uv), _t(tri.atlas), _t(tri.const), duv=_t(duv))
    np.testing.assert_array_equal(got, want.numpy())


def test_mip_levels_pick_equal_away_from_level_boundaries():
    """The trilinear level is log2 of the footprint in texels, truncated:
    on lanes whose log2 is at least 1e-4 from an integer both packages
    blend the same two levels with weights within 1e-5."""
    img = _image(8, 64, 64)
    jsys, tsys = _both_systems([dict(kind=tt.TEX_IMAGE, image=img,
                                     filter=tt.FILTER_TRILINEAR)])
    rng = np.random.default_rng(2)
    n = 2000
    uv = rng.uniform(0, 1, (n, 2)).astype(np.float32)
    width = 2.0 ** rng.uniform(-2, 7, n)  # texels, levels 0 .. 6 and beyond
    duv = np.stack([width / 64, width / 128], axis=-1).astype(np.float32)
    got, ref = _eval_both(jsys, tsys, uv, duv)
    lvl = np.log2(np.maximum(duv[:, 0].astype(np.float64) * 64, 1.0))
    frac = lvl % 1.0
    ok = (frac > 1e-4) & (frac < 1 - 1e-4)
    assert ok.mean() > 0.7
    np.testing.assert_allclose(got[0][ok], ref[0][ok], rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)  # continuous
    # beyond the coarsest level: the image's mean
    wide = lvl >= 6
    assert np.abs(got[0][wide] - img.mean(axis=(0, 1))).max() <= 1e-5


@pytest.mark.parametrize("filtered", [False, True])
@pytest.mark.parametrize("mapping", ["uv", "spherical"])
def test_checkerboard_and_scale_match(mapping, filtered):
    """A checkerboard whose texture2 is a scale node over an image, under
    both mappings, plain and box-filtered, declared before its children's
    parents so the topological order matters."""
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = [[0.0, 2.0, 0.0], [0.0, 0.0, 1.0], [1.5, 0.0, 0.0]]
    m[:3, 3] = [0.3, -0.2, 0.1]
    map_kw = dict(map_scale=(6.0, -4.0), map_offset=(0.25, 0.5))
    if mapping == "spherical":
        map_kw.update(mapping=tt.MAP_SPHERICAL, world_to_tex=m)
    specs = [
        dict(kind=tt.TEX_CHECKERBOARD, child0=3, child1=1,
             checker_filter=filtered, **map_kw),
        dict(kind=tt.TEX_SCALE, child0=2, scale=np.float32([0.5, 0.25, 2.0])),
        dict(kind=tt.TEX_IMAGE, image=_image(9, 8, 8),
             filter=tt.FILTER_BILINEAR),
        dict(kind=tt.TEX_CONSTANT, value=np.float32([0.9, 0.8, 0.1])),
    ]
    jsys, tsys = _both_systems(specs)
    assert tsys.order == jsys.order == [3, 2, 1, 0]
    uv, duv, duv4, p = _lanes(21 + filtered)
    got, ref = _eval_both(jsys, tsys, uv, duv, duv4, p)
    np.testing.assert_allclose(got[1:], ref[1:], rtol=0, atol=ATOL)
    ok = np.ones(len(uv), bool)
    if not filtered:
        # leave out lanes within EDGE of a square's boundary
        suv = np.asarray(jsys._spec_uv(jsys.specs[0], jnp.asarray(uv),
                                       jnp.asarray(p))).astype(np.float64)
        f = suv % 1.0
        ok = ((f > EDGE) & (f < 1 - EDGE)).all(axis=-1)
        assert ok.mean() > 0.95
    atol = SPHERICAL_ATOL if mapping == "spherical" and filtered else ATOL
    np.testing.assert_allclose(got[0][ok], ref[0][ok], rtol=0, atol=atol)
    on_const = (got[0] == np.float32([0.9, 0.8, 0.1])).all(axis=-1)
    if filtered:
        assert on_const.mean() < 0.9  # blended lanes
    elif mapping == "spherical":
        # spherical coordinates lie in [0, 1) and take no scale: one square
        assert on_const.all()
    else:
        assert 0.3 < on_const.mean() < 0.7  # one child or the other


def test_checkerboard_without_children_is_one_or_zero():
    jsys, tsys = _both_systems([dict(kind=tt.TEX_CHECKERBOARD,
                                     map_scale=(4.0, 4.0))])
    uv, _, _, _ = _lanes(1, 400)
    got, ref = _eval_both(jsys, tsys, uv)
    f = (uv.astype(np.float64) * 4.0) % 1.0
    ok = ((f > EDGE) & (f < 1 - EDGE)).all(axis=-1)
    np.testing.assert_array_equal(got[0][ok], ref[0][ok])
    assert set(np.unique(got)) == {0.0, 1.0}


@pytest.mark.parametrize("filt", ["nearest", "ewa"])
def test_spherical_image_matches(filt):
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = [0.5, -1.0, 0.25]
    kw = dict(kind=tt.TEX_IMAGE, image=_image(13, 32, 64),
              filter=FILTERS[filt], mapping=tt.MAP_SPHERICAL, world_to_tex=m)
    jsys, tsys = _both_systems([kw])
    uv, duv, duv4, p = _lanes(31)
    p[:4] = [[-0.5, 1.0, 5.0], [-0.5, 1.0, -5.0], [1.0, 1.0, -0.25],
             [-0.5, 1.0, -0.25]]  # the poles, phi = 0, the origin itself
    got, ref = _eval_both(jsys, tsys, uv, duv, duv4, p)
    suv = np.asarray(jsys._spec_uv(jsys.specs[0], jnp.asarray(uv),
                                   jnp.asarray(p)))
    ok = np.ones(len(uv), bool)
    if filt == "nearest":
        ok = _away_from_texel_edges(suv, 64, 32, (1, 1), (0, 0))
    np.testing.assert_allclose(got[0][ok], ref[0][ok], rtol=0,
                               atol=SPHERICAL_ATOL)
    # the mesh uv plays no part
    got2, _ = _eval_both(jsys, tsys, uv[::-1].copy(), duv, duv4, p)
    np.testing.assert_array_equal(got2, got)


def test_out_of_range_index_clamps_into_the_atlas():
    """A texel index past the atlas clamps to its ends (jnp.take's clip
    mode), where plain tensor indexing would raise: huge uv under clamp
    addressing, and a NaN coordinate."""
    kw = dict(kind=tt.TEX_IMAGE, image=_image(2, 4, 4),
              filter=tt.FILTER_BILINEAR, address=tt.ADDRESS_CLAMP)
    tsys = tt.TextureSystem([tt.TexSpec(**kw)])
    uv = np.float32([[1e12, -1e12], [np.nan, 0.5], [0.5, 0.5]])
    got = tsys.eval_all(_t(uv), _t(tsys.atlas), _t(tsys.const)).numpy()
    assert got.shape == (1, 3, 3) and np.isfinite(got[0, 2]).all()


# --- mirrors of tests/test_texchain.py --------------------------------------

WHITE = [{"format": "color", "name": "white", "type": "constant",
          "color": [0.8, 0.8, 0.8]}]
LAMBERT = [{"name": "mat", "type": "lambert", "Kd": "white"}]


def _plane_scene_path(tmp_path, materials, textures, extra_files=None):
    """tests/test_texchain.py's scene: a uv-mapped plane under a camera
    that looks straight down, u = (x + 1) / 2, v = (z + 1) / 2."""
    doc = {
        "render_setting": {"render_method": "path_tracing",
                           "sample_per_pixel": 1},
        "camera": {"position": [0, 2.0, 0], "euler": [90, 0, 0],
                   "rotation_order": "xyz", "fov": 60.0,
                   "film": {"resolution": [16, 16]},
                   "filter": {"type": "box", "width": [0.5, 0.5]}},
        "geometries": [{"name": "plane", "type": "mesh",
                        "file": "uvplane.obj"}],
        "textures": textures,
        "materials": materials,
        "primitives": [{"type": "model", "name": "pm", "geometry": "plane",
                        "material": materials[0]["name"]},
                       {"type": "instance", "name": "pi", "model": "pm"}],
        "lights": [{"name": "key", "type": "point", "intensity": [5, 5, 5],
                    "position": [1, 3, 1]}],
    }
    (tmp_path / "uvplane.obj").write_text(UV_PLANE_OBJ)
    for name, img in (extra_files or {}).items():
        texr.write_exr(str(tmp_path / name), img)
    path = tmp_path / "scene.json"
    path.write_text(json.dumps(doc))
    return str(path)


def _plane_scene(tmp_path, materials, textures, extra_files=None):
    return tloader.load_scene(
        _plane_scene_path(tmp_path, materials, textures, extra_files),
        device="cpu")


def _down_rays(n):
    o = torch.tensor([0.0, 1.0, 0.0]).expand(n, 3)
    d = torch.tensor([0.0, -1.0, 0.0]).expand(n, 3)
    return o, d, torch.full((n,), 1e-4), torch.full((n,), 1e30)


def test_uv_differentials_analytic(tmp_path):
    scene, meta = _plane_scene(tmp_path, LAMBERT, WHITE)
    o, d, mint, maxt = _down_rays(8)
    k = 1.0 / np.sqrt(1.0001)
    dxd = (torch.tensor([0.01, -1.0, 0.0]) * k).expand(8, 3)
    dyd = (torch.tensor([0.0, -1.0, 0.01]) * k).expand(8, 3)
    frag = tscn.intersect(scene, meta, o, d, mint, maxt, dxd=dxd, dyd=dyd)
    assert bool(frag["hit"].all())
    duv4 = frag["duv4"].numpy()
    # the plane is hit at t = 1; 0.01 of world offset is du = 0.005
    np.testing.assert_allclose(duv4[:, 0], 0.005, rtol=1e-3)
    np.testing.assert_allclose(duv4[:, 3], 0.005, rtol=1e-3)
    np.testing.assert_allclose(duv4[:, 1:3], 0.0, atol=1e-6)
    np.testing.assert_allclose(frag["duv"].numpy()[:, 0], 0.005, rtol=1e-3)


def _checker_img(n=64):
    img = np.zeros((n, n, 3), np.float32)
    yy, xx = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    img[((yy // 8 + xx // 8) % 2) == 0] = 1.0
    return img


def _eval(tsys, uv, **kw):
    kw = {k: _t(np.float32(v)) for k, v in kw.items()}
    return tsys.eval_all(_t(np.float32(uv)), _t(tsys.atlas), _t(tsys.const),
                         **kw).numpy()


def test_mip_trilinear_converges_to_mean():
    img = _checker_img()
    tsys = tt.TextureSystem([tt.TexSpec(kind=tt.TEX_IMAGE, image=img,
                                        filter=tt.FILTER_TRILINEAR)])
    uv = [[0.3, 0.4], [0.7, 0.2]]
    # a huge footprint: the coarsest level, the image's mean
    wide = _eval(tsys, uv, duv=np.full((2, 2), 4.0))
    np.testing.assert_allclose(wide[0], 0.5, atol=1e-3)
    # a tiny one: level 0's plain bilinear
    tiny = _eval(tsys, uv, duv=np.full((2, 2), 1e-5))
    bil = tt.TextureSystem([tt.TexSpec(kind=tt.TEX_IMAGE, image=img,
                                       filter=tt.FILTER_BILINEAR)])
    np.testing.assert_allclose(tiny, _eval(bil, uv), atol=1e-5)


def test_mip_ewa_anisotropic():
    """A footprint wide in u and thin in v averages along u only."""
    n = 64
    img = np.zeros((n, n, 3), np.float32)
    img[:, (np.arange(n) // 8) % 2 == 0] = 1.0  # stripes along u
    tsys = tt.TextureSystem([tt.TexSpec(kind=tt.TEX_IMAGE, image=img,
                                        filter=tt.FILTER_EWA)])
    out = _eval(tsys, [[0.5, 0.5]], duv=[[0.5, 1e-4]],
                duv4=[[0.5, 0.0, 0.0, 1e-4]])[0, 0, 0]
    assert abs(out - 0.5) < 0.1  # averaged across the stripes
    sharp = _eval(tsys, [[0.44, 0.5]], duv=[[1e-4, 1e-4]],
                  duv4=[[1e-4, 0.0, 0.0, 1e-4]])[0, 0, 0]
    assert abs(sharp - round(sharp)) < 0.05  # a stripe's interior


def test_bump_map_tilts_normal(tmp_path):
    """The height ramp h(u) = u on the uv plane: with dpdu = (2, 0, 0),
    dpdv = (0, 0, 2) and n = (0, 1, 0) the normal becomes
    (-2, 4, 0) / sqrt(20)."""
    n = 64
    ramp = np.broadcast_to((np.arange(n, dtype=np.float32) / n)[None, :, None],
                           (n, n, 3)).copy()
    textures = WHITE + [{"format": "float", "name": "ramp", "type": "image",
                         "file": "ramp.exr", "filter": "bilinear"}]
    mats = [{"name": "mat", "type": "lambert", "Kd": "white",
             "bumpmap": "ramp"}]
    scene, meta = _plane_scene(tmp_path, mats, textures, {"ramp.exr": ramp})
    assert meta.has_perturb
    frag = tscn.intersect(scene, meta, *_down_rays(4))
    ns = frag["ns"].numpy()
    assert bool(frag["hit"].all())
    np.testing.assert_allclose(ns[:, 0], -2 / np.sqrt(20), atol=0.05)
    np.testing.assert_allclose(ns[:, 1], 4 / np.sqrt(20), atol=0.05)
    np.testing.assert_allclose(np.linalg.norm(ns, axis=-1), 1.0, rtol=1e-5)


def test_normal_map_overrides_normal(tmp_path):
    """The constant tangent-space normal (1, 0.5, 0.5) decodes to
    (1, 0, 0): the shading normal becomes the tangent."""
    textures = WHITE + [{"format": "color", "name": "flat_n",
                         "type": "constant", "color": [1.0, 0.5, 0.5]}]
    mats = [{"name": "mat", "type": "lambert", "Kd": "white",
             "normalmap": "flat_n"}]
    scene, meta = _plane_scene(tmp_path, mats, textures)
    frag = tscn.intersect(scene, meta, *_down_rays(4))
    t = frag["dpdu"].numpy()
    t = t / np.linalg.norm(t, axis=-1, keepdims=True)
    np.testing.assert_allclose(frag["ns"].numpy(), t, atol=1e-4)


def test_checker_filter_activates_from_duv(tmp_path):
    textures = [
        {"format": "color", "name": "black", "type": "constant",
         "color": [0, 0, 0]},
        {"format": "color", "name": "whitec", "type": "constant",
         "color": [1, 1, 1]},
        {"format": "color", "name": "check", "type": "checkerboard",
         "texture1": "whitec", "texture2": "black", "filter": True,
         "scale": [16, 16]}]
    mats = [{"name": "mat", "type": "lambert", "Kd": "check"}]
    scene, meta = _plane_scene(tmp_path, mats, textures)
    ts = meta.texture_system

    def at(width):
        return ts.eval_all(torch.tensor([[0.26, 0.26]]), scene["tex_atlas"],
                           scene["tex_const"],
                           duv=torch.full((1, 2), width))[3, 0, 0].item()

    assert abs(at(0.25) - 0.5) < 0.06  # a footprint over many squares
    assert abs(at(1e-5) - round(at(1e-5))) < 0.05  # one square


def test_loader_spherical_mapping(tmp_path):
    """mapping: spherical through the JSON: the lookup keys on the world
    position's spherical coordinates and ignores the mesh uv."""
    n = 64
    ramp = np.broadcast_to(
        ((np.arange(n, dtype=np.float32) + 0.5) / n)[None, :, None],
        (n, n, 3)).copy()
    textures = WHITE + [{"format": "color", "name": "sph", "type": "image",
                         "file": "ramp.exr", "filter": "bilinear",
                         "mapping": "spherical"}]
    mats = [{"name": "mat", "type": "lambert", "Kd": "sph"}]
    scene, meta = _plane_scene(tmp_path, mats, textures, {"ramp.exr": ramp})
    specs = meta.texture_system.specs
    sph = [i for i, s in enumerate(specs) if s.mapping == tt.MAP_SPHERICAL]
    assert len(sph) == 1
    pts = torch.tensor([[1.0, 1.0, 1e-3], [0.0, 1.0, 1e-3], [-1.0, 0.0, 1e-3]])
    stack = meta.texture_system.eval_all(
        torch.full((3, 2), 0.77), scene["tex_atlas"], scene["tex_const"],
        p=pts)
    want = np.asarray([np.pi / 4, np.pi / 2, np.pi]) / (2 * np.pi)
    np.testing.assert_allclose(stack[sph[0], :, 0].numpy(), want, atol=1.5 / n)


def test_loader_channel_selection(tmp_path):
    """R / G / B replicate a channel, A reads 1 where the file has no
    alpha, and a float texture's All is the Rec.709 luminance."""
    img = np.zeros((4, 4, 3), np.float32)
    img[...] = [0.2, 0.5, 0.8]
    textures = WHITE + [
        {"format": "color", "name": f"ch{c}", "type": "image",
         "file": "rgb.exr", "filter": "nearest", "channel": c}
        for c in "RGBA"
    ] + [{"format": "float", "name": "lum", "type": "image",
          "file": "rgb.exr", "filter": "nearest"}]
    mats = [{"name": "mat", "type": "lambert", "Kd": "chR"}]
    scene, meta = _plane_scene(tmp_path, mats, textures, {"rgb.exr": img})
    uv = torch.tensor([[0.5, 0.5]])
    stack = meta.texture_system.eval_all(uv, scene["tex_atlas"],
                                         scene["tex_const"]).numpy()
    images = [i for i, s in enumerate(meta.texture_system.specs)
              if s.kind == tt.TEX_IMAGE]
    for i, want in zip(images, (0.2, 0.5, 0.8, 1.0)):
        np.testing.assert_allclose(stack[i, 0], want, atol=1e-5)
    fstack = meta.float_texture_system.eval_all(
        uv, scene["ftex_atlas"], scene["ftex_const"]).numpy()
    fimg = [i for i, s in enumerate(meta.float_texture_system.specs)
            if s.kind == tt.TEX_IMAGE][0]
    lum = 0.212671 * 0.2 + 0.715160 * 0.5 + 0.072169 * 0.8
    np.testing.assert_allclose(fstack[fimg, 0, 0], lum, atol=1e-4)


# --- the loader's texture section against goblin_tpu's ----------------------

CHAIN_TEXTURES = [
    {"format": "color", "name": "red", "type": "constant",
     "color": [0.9, 0.1, 0.1]},
    {"format": "color", "name": "img", "type": "image", "file": "a.exr",
     "filter": "EWA", "address": "clamp", "gamma": 2.2, "scale": [3, 2],
     "offset": [0.1, 0.2], "max_anisotropy": 6.0},
    {"format": "color", "name": "dim", "type": "scale", "texture": "img",
     "scale": [0.5, 0.6, 0.7]},
    {"format": "color", "name": "check", "type": "checkerboard",
     "texture1": "dim", "texture2": "red", "filter": True, "scale": [5, 7]},
    {"format": "color", "name": "ball", "type": "checkerboard",
     "texture1": "red", "texture2": "undeclared", "mapping": "spherical",
     "position": [0.1, 0.2, 0.3], "euler": [10, 20, 30]},
    {"format": "color", "name": "green only", "type": "image",
     "file": "a.exr", "channel": "G", "filter": "trilinear",
     "address": "border"},
    {"format": "color", "name": "odd filter", "type": "image",
     "file": "a.exr", "filter": "cubic", "address": "mirror"},
    {"format": "float", "name": "height", "type": "image", "file": "a.exr",
     "filter": "bilinear"},
    {"format": "float", "name": "half height", "type": "scale",
     "texture": "height", "scale": 0.5},
    {"format": "float", "name": "blue", "type": "image", "file": "a.exr",
     "channel": "B"},
    {"format": "float", "name": "fcheck", "type": "checkerboard",
     "texture1": "half height", "texture2": "blue"},
]
CHAIN_MATERIALS = [
    {"name": "mat", "type": "lambert", "Kd": "check", "bumpmap": "height",
     "normalmap": "img"},
    {"name": "unknown maps", "type": "lambert", "Kd": "red",
     "bumpmap": "nope", "normalmap": "nope"},
    {"name": "shiny", "type": "blinn", "Kg": "ball", "exponent": "fcheck"},
]


def _spec_fields(s):
    return (s.kind, s.child0, s.child1, tuple(s.map_scale),
            tuple(s.map_offset), s.address, s.filter, s.gamma,
            s.checker_filter, s.max_anisotropy, s.mapping)


def test_loader_texture_tables_match(tmp_path):
    """Every texture kind, option and default through both loaders: spec
    lists in the same row order, atlases, constant tables and the
    materials' map columns equal; an unknown filter falls to bilinear, an
    unknown address to repeat, an undeclared child and an unknown map name
    to texture 0, as in goblin_tpu."""
    path = _plane_scene_path(tmp_path, CHAIN_MATERIALS, CHAIN_TEXTURES,
                             {"a.exr": _image(17, 12, 20)})
    js, jm, ts, tm = _load_both(path)
    for name in ("texture_system", "float_texture_system"):
        jsys, tsys = getattr(jm, name), getattr(tm, name)
        assert [_spec_fields(s) for s in tsys.specs] == [
            _spec_fields(s) for s in jsys.specs], name
        for a, b in zip(tsys.specs, jsys.specs):
            np.testing.assert_array_equal(a.value, b.value)
            np.testing.assert_array_equal(a.scale, b.scale)
            assert (a.image is None) == (b.image is None)
            if a.image is not None:
                np.testing.assert_array_equal(a.image, b.image)
            if a.mapping == tt.MAP_SPHERICAL:
                np.testing.assert_array_equal(a.world_to_tex, b.world_to_tex)
        assert tsys.order == jsys.order and tsys.image_info == jsys.image_info
    for k in ("tex_atlas", "ftex_atlas", "tex_const", "ftex_const",
              "mat_bump", "mat_normal"):
        np.testing.assert_array_equal(_np(ts[k]), np.asarray(js[k]), err_msg=k)
    assert tm.has_perturb and jm.has_perturb
    specs = tm.texture_system.specs
    assert specs[7].filter == tt.FILTER_BILINEAR  # "cubic"
    assert specs[7].address == tt.ADDRESS_REPEAT  # "mirror"
    assert specs[5].child1 == 0  # "undeclared"
    # material rows: error, mat, unknown maps, shiny, black
    assert _np(ts["mat_bump"]).tolist() == [-1, 1, 0, -1, -1]
    assert _np(ts["mat_normal"]).tolist() == [-1, 2, 0, -1, -1]


BAD_TEXTURES = {
    "a missing file": ({"name": "t", "type": "image", "file": "none.exr"},
                       "failed to load"),
    "an unknown mapping": ({"name": "t", "type": "checkerboard",
                            "mapping": "cylindrical"}, "mapping"),
    "an unknown channel": ({"name": "t", "type": "image", "file": "a.exr",
                            "channel": "Z"}, "channel"),
    "an unknown type": ({"name": "t", "type": "marble"}, "unknown type"),
}


@pytest.mark.parametrize("name", sorted(BAD_TEXTURES))
def test_loader_raises_where_goblin_tpu_prints(tmp_path, name):
    """goblin_tpu prints and substitutes (a magenta texel, the uv mapping,
    all channels, texture 0); the port raises."""
    entry, match = BAD_TEXTURES[name]
    path = _plane_scene_path(tmp_path, LAMBERT, WHITE + [entry],
                             {"a.exr": _image(1, 4, 4)})
    with pytest.raises(ValueError, match=match):
        tloader.load_scene(path, device="cpu")


# --- _perturb and gather_material on fragments ------------------------------

def _camera_rays(jm, tm, n_grid=1):
    """Both packages' primary rays of the whole frame, sample 0."""
    spec = tm.camera.film
    ids = np.arange(spec.x_res * spec.y_res, dtype=np.int32)
    jids, tids = jnp.asarray(ids), _t(ids)
    jx, jy = jcommon.pixel_samples(0, jids, spec.x_res, jnp.int32(0), n_grid)
    tx, ty = tcommon.pixel_samples(0, tids, spec.x_res, 0, n_grid)
    jl = [j_hash(0, jids, 0, jcommon.BOUNCE_CAMERA, d)
          for d in (jcommon.DIM_LENS_U, jcommon.DIM_LENS_V)]
    from goblin_tpu_torch.core.rng import hash_uniform as t_hash
    tl = [t_hash(0, tids, 0, tcommon.BOUNCE_CAMERA, d)
          for d in (tcommon.DIM_LENS_U, tcommon.DIM_LENS_V)]
    return (jm.camera.generate_ray(jx, jy, *jl), jids,
            tm.camera.generate_ray(tx, ty, *tl), tids)


def jax_render_unjitted(js, jm, li, seed=0):
    """goblin_tpu's one-pass render of the whole frame, op by op: its
    raygen, li and dense film splat without the jit around them (compiling
    the gallery scene's unrolled texture lookups takes minutes on the
    CPU)."""
    cam, spec = jm.camera, jm.camera.film
    ids = jnp.arange(spec.x_res * spec.y_res, dtype=jnp.int32)
    s = jnp.int32(0)
    x, y = jcommon.pixel_samples(seed, ids, spec.x_res, s, 1)
    ray = cam.generate_ray(
        x, y, j_hash(seed, ids, s, jcommon.BOUNCE_CAMERA, jcommon.DIM_LENS_U),
        j_hash(seed, ids, s, jcommon.BOUNCE_CAMERA, jcommon.DIM_LENS_V))
    L = li(js, jm, ray, ids, s, seed)
    shape = (spec.y_res, spec.x_res)
    jx = j_hash(seed, ids, s, jcommon.BOUNCE_CAMERA, jcommon.DIM_PIXEL_X)
    jy = j_hash(seed, ids, s, jcommon.BOUNCE_CAMERA, jcommon.DIM_PIXEL_Y)
    color, weight = jfilm.new_film(spec)
    color, weight = jfilm.splat_dense(spec, color, weight, jx.reshape(shape),
                                      jy.reshape(shape),
                                      L.reshape(shape + (3,)))
    return np.asarray(jfilm.to_image(color, weight))


@pytest.fixture(scope="module")
def gallery():
    js, jm, ts, tm = _load_both(GALLERY, {"sample_per_pixel": 1})
    return js, _resized(jm, 32, 24), ts, _resized(tm, 32, 24)


def test_gallery_scene_is_what_the_slice_needs(gallery):
    _, _, ts, tm = gallery
    with open(GALLERY) as f:
        doc = json.load(f)
    assert doc["camera"]["film"]["resolution"] == [512, 384]
    assert doc["render_setting"] == {
        "sample_per_pixel": 16, "max_ray_depth": 5,
        "render_method": "path_tracing", "initial_radius": 0.01,
        "ao_sample_num": 25}
    kinds = [s.kind for s in tm.texture_system.specs]
    assert {tt.TEX_CONSTANT, tt.TEX_CHECKERBOARD, tt.TEX_SCALE,
            tt.TEX_IMAGE} == set(kinds)
    by_filter = {s.filter for sysm in (tm.texture_system,
                                       tm.float_texture_system)
                 for s in sysm.specs if s.kind == tt.TEX_IMAGE}
    assert by_filter == {tt.FILTER_NEAREST, tt.FILTER_BILINEAR,
                         tt.FILTER_TRILINEAR, tt.FILTER_EWA}
    ewa = [s for s in tm.texture_system.specs if s.filter == tt.FILTER_EWA][0]
    assert ewa.mapping == tt.MAP_SPHERICAL and ewa.address == tt.ADDRESS_REPEAT
    assert tm.has_perturb and tm.has_null and tm.has_lens
    assert tm.material_kinds == (0, 1, 2, 3, 5)
    assert tm.light_sample_nums == (1, 1, 1)
    assert tm.settings["ao_sample_num"] == 25
    assert tm.settings["lt_strategy"] == "t1"
    assert (_np(ts["mat_bump"]) >= 0).sum() == 1
    assert (_np(ts["mat_normal"]) >= 0).sum() == 1


def test_gallery_texture_file_is_the_committed_function():
    """examples/textures/gallery.exr is make_gallery_image()'s output (to
    1e-6: sin and cos may round differently between numpy builds), 200 x 120,
    and loads unchanged in goblin_tpu."""
    img = texr.read_exr(GALLERY_EXR)
    assert img.shape == (120, 200, 3)
    np.testing.assert_allclose(img, assets.make_gallery_image(), atol=1e-6)
    np.testing.assert_array_equal(img, jexr.read_exr(GALLERY_EXR))
    assert 0.0 <= img.min() and img.max() <= 1.0 and img[..., 2].mean() > 0.8


def test_gallery_tables_match(gallery):
    js, jm, ts, tm = gallery
    for k in ("tex_atlas", "ftex_atlas", "tex_const", "ftex_const",
              "mat_bump", "mat_normal", "tri_n", "tri_uv", "tri_mat"):
        np.testing.assert_array_equal(_np(ts[k]), np.asarray(js[k]), err_msg=k)
    jrows = np.asarray(js["mat_rows"])
    jdec = jrows.copy()
    for c in (0, 1, 2, 3, 4, 7):
        jdec[:, c] = jrows[:, c].view(np.int32)
    np.testing.assert_array_equal(_np(ts["mat_rows"]), jdec)
    for name in ("texture_system", "float_texture_system"):
        jsys, tsys = getattr(jm, name), getattr(tm, name)
        assert tsys.image_info == jsys.image_info and tsys.order == jsys.order
        assert set(tsys.mip_info) == set(jsys.mip_info)
        for i in tsys.mip_info:
            for a, b in zip(tsys.mip_info[i], jsys.mip_info[i]):
                np.testing.assert_array_equal(a, b)
    # the 200 x 120 image's pyramid starts at 256 x 128
    assert tm.texture_system.image_info[7] == (0, 128, 256)
    for f in ("has_perturb", "has_null", "light_sample_nums",
              "material_kinds", "n_materials"):
        assert getattr(tm, f) == getattr(jm, f), f


def test_gallery_fragments_and_materials_match(gallery):
    """The gallery's primary fragments: _perturb's bump map on the floor
    (footprints from the ray differentials) and normal map on the Blinn
    bunny, then gather_material's filtered lookups (the box-filtered
    checkerboard over a scale node, EWA under the spherical mapping, the
    trilinear alpha). Fragments within the repo's intersect bar, 1e-4
    (1e-3 for what the bump map tilts); materials: atol 1e-4 on >= 99.5% of lanes (a lane on a checker edge or
    a silhouette can differ)."""
    js, jm, ts, tm = gallery
    jray, _, tray, _ = _camera_rays(jm, tm)
    jf = jscn.intersect(js, jm, jray["o"], jray["d"], jray["mint"],
                        jray["maxt"], dxd=jray["dxd"], dyd=jray["dyd"])
    tf = tscn.intersect(ts, tm, tray["o"], tray["d"], tray["mint"],
                        tray["maxt"], dxd=tray["dxd"], dyd=tray["dyd"])
    hit = np.asarray(jf["hit"])
    np.testing.assert_array_equal(_np(tf["hit"]), hit)
    np.testing.assert_array_equal(_np(tf["mat"]), np.asarray(jf["mat"]))
    mats = set(_np(tf["mat"])[hit].tolist())
    assert {3, 5} <= mats  # the bump-mapped floor, the normal-mapped bunny
    for k in ("ns", "dpdu", "dpdv", "uv", "duv", "duv4", "p"):
        a, b = _np(tf[k])[hit], np.asarray(jf[k])[hit]
        # the bump's forward difference divides the float32 rounding of uv
        # (1e-7) by its step (5e-4): what it tilts is held to 1e-3
        # (dpdu is 400 long on the floor), relative to the vector's length
        tol = 1e-3 if k in ("ns", "dpdu", "dpdv") else 1e-4
        size = 1.0 + np.linalg.norm(b, axis=-1)
        assert (np.abs(a - b).max(axis=-1) <= tol * size).mean() >= 0.995, k
    # the maps did something: unperturbed, ns would be the geometric normal
    floor = hit & (_np(tf["mat"]) == 3)
    assert np.abs(_np(tf["ns"])[floor] - [0, 1, 0]).max() > 1e-3
    # continuation fragments carry no footprint: _perturb's step is 5e-4
    tf0 = tscn.intersect(ts, tm, tray["o"], tray["d"], tray["mint"],
                         tray["maxt"])
    jf0 = jscn.intersect(js, jm, jray["o"], jray["d"], jray["mint"],
                         jray["maxt"])
    a, b = _np(tf0["ns"])[hit], np.asarray(jf0["ns"])[hit]
    assert (np.abs(a - b) <= 1e-3).all(axis=-1).mean() >= 0.995
    assert np.abs(_np(tf0["ns"])[floor] - _np(tf["ns"])[floor]).max() > 1e-5

    n = hit.size
    u = np.random.default_rng(0).uniform(0, 1, n).astype(np.float32)
    ref = j_gather(js, jm, jf, u_mask=jnp.asarray(u))
    got = t_gather(ts, tm, tf, u_mask=_t(u))
    for k in ("mtype", "is_masked"):
        np.testing.assert_array_equal(_np(got[k]), np.asarray(ref[k]))
    for k in ("c0", "c1", "f0", "eta", "k", "mask_alpha"):
        a, b = _np(got[k])[hit], np.asarray(ref[k])[hit]
        close = np.abs(a - b) <= 1e-4
        assert close.mean() >= 0.995, k
    c0 = _np(got["c0"])
    assert len(np.unique(c0[floor].round(3), axis=0)) >= 2  # both squares
    bunny = hit & (_np(tf["mat"]) == 5)
    assert c0[bunny].std() > 0.01  # the image, not a constant
    # light tracing's connections hand over mat and uv alone
    got2 = t_gather(ts, tm, {"mat": tf["mat"], "uv": tf["uv"]})
    ref2 = j_gather(js, jm, {"mat": jf["mat"], "uv": jf["uv"]})
    a, b = _np(got2["c0"])[hit], np.asarray(ref2["c0"])[hit]
    assert (np.abs(a - b) <= 1e-4).mean() >= 0.995
    assert "mask_u" in got2 and not _np(got2["mask_u"]).any()


def test_gallery_path_tracing_matches_goblin_tpu(gallery):
    """32 x 24, 1 spp, depth 5: the whole texture chain on every bounce.
    goblin_tpu renders op by op (jax_render_unjitted)."""
    js, jm, ts, tm = gallery
    ref = jax_render_unjitted(js, jm, j_path_li(jm, unroll=True))
    got = tcommon.render(ts, tm, t_make_li(tm)).numpy()
    assert got.shape == ref.shape == (24, 32, 3) and np.isfinite(got).all()
    frac, rel = _bar(got, ref)
    assert frac >= 0.99 and rel <= 1e-3 and got.mean() > 0.05
