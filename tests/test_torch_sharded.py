"""The sharded render and train steps of goblin_tpu_torch against
goblin_tpu's: two gloo processes through the port's launch_local on
tests/test_multihost.py's 16 x 12 scene (films equal on both ranks within
1e-6, equal to goblin_tpu's render_sharded on an 8-device mesh within 1e-5,
that test's bar, and to the port's one-process render), the two-rank train
step against goblin_tpu's on make_mesh(8) and make_train_step over the
whole batch (the gradient bars: loss within rtol 1e-5, gradients within rtol 1e-4
/ atol 1e-9), render_sharded_dense at world 1 against goblin_tpu's on
make_mesh(1), both passes' chunk rounding, and init_from_env.

A torch child starts in seconds, so the two-process test is not marked
slow (goblin_tpu's, with jax children, is). The children rendezvous on a
port the OS had free, as xdist workers run side by side, and are killed
after 120 s.
"""

import os
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goblin_tpu.integrators.path import make_li as j_make_li
from goblin_tpu.parallel import mesh as jmesh
from goblin_tpu.scene import loader as jloader
from goblin_tpu_torch.integrators import common as tcommon
from goblin_tpu_torch.integrators.path import make_li as t_make_li
from goblin_tpu_torch.parallel import mesh as tmesh
from goblin_tpu_torch.parallel import multihost
from goblin_tpu_torch.scene import loader as tloader
from test_multihost import _tiny_scene
from test_torch_gradients import _image_scene
from test_torch_studio import _load_both, _resized

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 120

CHILD = textwrap.dedent("""
    import sys
    import numpy as np, torch
    from goblin_tpu_torch.integrators.path import make_li
    from goblin_tpu_torch.parallel import mesh as pm, multihost
    from goblin_tpu_torch.scene.loader import load_scene

    torch.set_num_threads(1)
    tiny, image, params, out = sys.argv[1:]
    assert multihost.init_from_env(device="cpu"), "no process group"
    mesh = pm.make_mesh(2, device="cpu")
    scene, meta = load_scene(tiny, device="cpu")
    sharded = pm.render_sharded(scene, meta, make_li(meta), mesh, spp=1,
                                chunk_size=256)
    dense = pm.render_sharded_dense(scene, meta, make_li(meta), mesh, spp=1)
    scene, meta = load_scene(image, device="cpu")
    step, _ = pm.make_sharded_train_step(scene, meta, make_li(meta), mesh)
    p = np.load(params)
    n = meta.camera.film.x_res * meta.camera.film.y_res
    loss, (g_light, g_atlas) = step((p["light"], p["atlas"]),
                                    torch.arange(n, dtype=torch.int32), 0)
    np.savez(out + f".r{mesh.rank}.npz", sharded=sharded.numpy(),
             dense=dense.numpy(), loss=loss.numpy(), g_light=g_light.numpy(),
             g_atlas=g_atlas.numpy())
    torch.distributed.destroy_process_group()
    print("rank", mesh.rank, "ok")
""")


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The children's results, rank by rank, and the scenes they read."""
    tmp = tmp_path_factory.mktemp("sharded")
    tiny = _tiny_scene(str(tmp))
    image = _image_scene(tmp_path_factory.mktemp("image"), "trilinear")
    js, _ = jloader.load_scene(image)
    params = str(tmp / "params.npz")
    np.savez(params, light=np.asarray(js["lights"]["color"]) * 1.5,
             atlas=np.asarray(js["tex_atlas"]) * 0.9)
    script = tmp / "child.py"
    script.write_text(CHILD)
    out = str(tmp / "out")
    results = multihost.launch_local(
        2, [str(script), tiny, image, params, out],
        port=multihost.free_port(), timeout=TIMEOUT,
        env_extra={"PYTHONPATH": REPO + os.pathsep
                   + os.environ.get("PYTHONPATH", "")})
    for rc, log in results:
        assert rc == 0, f"child failed:\n{log[-3000:]}"
    ranks = [dict(np.load(out + f".r{r}.npz")) for r in range(2)]
    return ranks, tiny, image, dict(np.load(params))


def test_two_ranks_hold_one_film(two_ranks):
    ranks, _, _, _ = two_ranks
    for key in ("sharded", "dense"):
        np.testing.assert_allclose(ranks[0][key], ranks[1][key], atol=1e-6)
        assert np.isfinite(ranks[0][key]).all() and ranks[0][key].mean() > 0
    for key in ("loss", "g_light", "g_atlas"):
        np.testing.assert_array_equal(ranks[0][key], ranks[1][key])


def test_two_ranks_match_goblin_tpu_render_sharded(two_ranks):
    """tests/test_multihost.py's reference: goblin_tpu's render_sharded on
    an 8-device mesh, chunks of 256."""
    ranks, tiny, _, _ = two_ranks
    js, jm = jloader.load_scene(tiny)
    ref = np.asarray(jmesh.render_sharded(js, jm, j_make_li(jm),
                                          jmesh.make_mesh(8), spp=1,
                                          chunk_size=256))
    for key in ("sharded", "dense"):
        np.testing.assert_allclose(ranks[0][key], ref, atol=1e-5)


def test_two_ranks_match_one_process(two_ranks):
    ranks, tiny, _, _ = two_ranks
    ts, tm = tloader.load_scene(tiny, device="cpu")
    ref = tcommon.render(ts, tm, t_make_li(tm)).numpy()
    for key in ("sharded", "dense"):
        np.testing.assert_allclose(ranks[0][key], ref, atol=1e-6)


def test_two_rank_train_step(two_ranks):
    """The loss and gradients of (light colour, atlas) over the 256 pixels,
    split between the ranks, against goblin_tpu's make_sharded_train_step
    on make_mesh(8) and the port's make_train_step over the whole batch."""
    ranks, _, image, p = two_ranks
    js, jm, ts, tm = _load_both(image)
    n = tm.camera.film.x_res * tm.camera.film.y_res
    jstep, _ = jmesh.make_sharded_train_step(js, jm, j_make_li(jm),
                                             jmesh.make_mesh(8))
    jloss, jg = jstep((jnp.asarray(p["light"]), jnp.asarray(p["atlas"])),
                      jnp.arange(n, dtype=jnp.int32), jnp.int32(0))
    tloss, tg = tmesh.make_train_step(ts, tm, t_make_li(tm))(
        (torch.as_tensor(p["light"]), torch.as_tensor(p["atlas"])),
        torch.arange(n, dtype=torch.int32), 0)
    got = ranks[0]
    assert (np.abs(np.asarray(jg[1])) > 0).sum() > 100
    for loss in (jloss, tloss):
        assert float(got["loss"]) == pytest.approx(float(loss), rel=1e-5)
    for refs in (jg, tg):
        for key, r in zip(("g_light", "g_atlas"), refs):
            np.testing.assert_allclose(got[key], np.asarray(r), rtol=1e-4,
                                       atol=1e-9, err_msg=key)


def test_render_sharded_dense_world_1_matches_goblin_tpu():
    """render_sharded_dense and render_sharded with no process group (world
    1, no collective) against goblin_tpu's on make_mesh(1), at the image
    bar, on bunny.json at 32 x 24 (two chunks of 512 for the dense pass)."""
    path = os.path.join(REPO, "examples", "bunny.json")
    ovr = {"render_method": "path_tracing", "sample_per_pixel": 1,
           "max_ray_depth": 3}
    js, jm, ts, tm = _load_both(path, ovr)
    jm, tm = _resized(jm, 32, 24), _resized(tm, 32, 24)
    mesh = tmesh.make_mesh(device="cpu")
    assert (mesh.world, mesh.rank, mesh.group) == (1, 0, None)
    ref = np.asarray(jmesh.render_sharded_dense(js, jm, j_make_li(jm),
                                                jmesh.make_mesh(1),
                                                chunk_size=512))
    for got in (tmesh.render_sharded_dense(ts, tm, t_make_li(tm), mesh,
                                           chunk_size=512),
                tmesh.render_sharded(ts, tm, t_make_li(tm), mesh,
                                     chunk_size=512)):
        got = got.numpy()
        close = np.abs(got - ref) <= 1e-4 + 1e-3 * np.abs(ref)
        assert close.all(axis=-1).mean() >= 0.99
        assert abs(got.mean() - ref.mean()) <= 1e-3 * abs(ref.mean())


@pytest.mark.parametrize("world", [1, 2, 3, 8])
@pytest.mark.parametrize("chunk", [100, 256, 1000, 1 << 16])
def test_chunk_rounding_equals_goblin_tpu(world, chunk, tmp_path):
    """The chunks both passes cut a 16 x 12 frame into, read from
    goblin_tpu's traced shapes (an li that records its batch), against the
    port's sharded_chunk_size and dense_chunk_size."""
    mesh = jmesh.make_mesh(world)
    shapes = []

    def li(scene, meta, ray, pixel_ids, s_idx, seed):
        shapes.append(pixel_ids.shape[0])
        return jnp.zeros((pixel_ids.shape[0], 3), jnp.float32)

    js, jm = jloader.load_scene(_tiny_scene(str(tmp_path)))
    jmesh.render_sharded(js, jm, li, mesh, spp=1, chunk_size=chunk)
    jmesh.render_sharded_dense(js, jm, li, mesh, spp=1, chunk_size=chunk)
    assert shapes == [tmesh.sharded_chunk_size(world, chunk),
                      tmesh.dense_chunk_size(16 * 12, world, chunk)]


def test_init_from_env(monkeypatch):
    """False with no GOBLIN_* variable, a ValueError naming what is missing
    with a partial set; make_mesh refuses a device count other than the
    world's."""
    for key in multihost.ENV_KEYS + ("GOBLIN_DIST",):
        monkeypatch.delenv(key, raising=False)
    assert multihost.init_from_env(device="cpu") is False
    monkeypatch.setenv("GOBLIN_COORDINATOR", "localhost:1")
    monkeypatch.setenv("GOBLIN_PROC_ID", "0")
    with pytest.raises(ValueError, match="GOBLIN_NUM_PROCS"):
        multihost.init_from_env(device="cpu")
    with pytest.raises(ValueError, match="one device a process"):
        tmesh.make_mesh(2, device="cpu")
    assert not torch.distributed.is_initialized()


def test_global_put_places_on_the_mesh_device():
    mesh = tmesh.make_mesh(device="cpu")
    got = multihost.global_put(np.arange(6, dtype=np.int32), mesh)
    assert got.device == mesh.device and got.dtype == torch.int32
    assert got.tolist() == list(range(6))


def test_launch_local_times_out_and_kills(tmp_path):
    """A child that outlives the timeout is killed, and the launcher
    raises."""
    import subprocess

    script = tmp_path / "sleep.py"
    script.write_text("import time\ntime.sleep(60)\n")
    with pytest.raises(subprocess.TimeoutExpired):
        multihost.launch_local(2, [str(script)], port=multihost.free_port(),
                               timeout=2)


def test_share_covers_the_batch():
    """Mesh.share splits n items into world contiguous shares, in rank
    order, that cover them once."""
    for world in (1, 2, 3, 8):
        for n in (8, 10, 256, 1001):
            parts = [tmesh.Mesh(None, world, r, torch.device("cpu")).share(n)
                     for r in range(world)]
            ids = np.concatenate([np.arange(n)[s] for s in parts])
            np.testing.assert_array_equal(ids, np.arange(n))
