"""goblin_tpu_torch.entry, the port's entry points, against
__graft_entry__.py's: entry()'s radiance step on bunny.json against
goblin_tpu's entry() on the same pixel ids and tree, its example arguments,
the tiny scene of the dryrun, and dryrun_multichip(2) over two gloo ranks
against goblin_tpu's make_sharded_train_step on make_mesh(8).

goblin_tpu is loaded with GOBLIN_TRACE=pallas and traced with its jnp
traversal (its loader is wrapped while __graft_entry__ calls it), so both
packages walk one tree. Bars: the image bar on radiance (>= 99% of lanes
within 1e-4 + 1e-3 rel, means within 1e-3 rel); the dryrun's loss and
gradient L1 within rtol 1e-4.

The module imports neither JAX nor goblin_tpu at its top, so that its
CUDA test runs on a machine without them:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_entry.py
"""

import dataclasses
import json
import os
import re

import numpy as np
import pytest
import torch

from goblin_tpu_torch import entry as te
from goblin_tpu_torch.parallel import multihost


def _j_load_on_one_tree(path, overrides=None, load=None):
    """goblin_tpu's load_scene (or load, the function it was before a
    patch) on the port's tree: the production bake, traced by the jnp
    traversal."""
    from goblin_tpu.scene import loader as jloader

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GOBLIN_TRACE", "pallas")
        js, jm = (load or jloader.load_scene)(path, overrides)
    return js, dataclasses.replace(jm, trace_backend="jnp")


def _radiance_agrees(got, ref):
    assert got.shape == ref.shape and np.isfinite(got).all()
    close = np.abs(got - ref) <= 1e-4 + 1e-3 * np.abs(ref)
    assert close.all(axis=-1).mean() >= 0.99
    assert abs(got.mean() - ref.mean()) <= 1e-3 * abs(ref.mean())


@pytest.fixture(scope="module")
def entries():
    """(goblin_tpu's fn and example args, the port's on the CPU)."""
    import __graft_entry__ as ge
    from goblin_tpu.scene import loader as jloader

    load = jloader.load_scene
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jloader, "load_scene", lambda path, overrides=None:
                   _j_load_on_one_tree(path, overrides, load))
        j_entry = ge.entry()
    return j_entry, te.entry(device="cpu")


# pixel ids strided over the 512 x 384 film (most of the example ids, the
# film's top two rows, see black)
STRIDED = np.arange(1024, dtype=np.int32) * 192


@pytest.mark.parametrize("ids", ["example", "strided"])
def test_entry_matches_goblin_tpu(entries, ids):
    import jax.numpy as jnp

    (j_fn, j_args), (t_fn, t_args) = entries
    if ids == "example":
        pix, s_idx = np.asarray(j_args[0]), int(j_args[1])
    else:
        pix, s_idx = STRIDED, 3
    ref = np.asarray(j_fn(jnp.asarray(pix), jnp.int32(s_idx)))
    got = t_fn(torch.as_tensor(pix), s_idx).numpy()
    _radiance_agrees(got, ref)
    if ids == "strided":
        assert (got > 0).any(axis=-1).mean() > 0.25


def test_entry_example_args(entries):
    """1,024 int32 pixel ids and sample 0, as goblin_tpu's; the port's ids
    on the scene's device."""
    (_, (j_ids, j_s)), (_, (t_ids, t_s)) = entries
    assert t_ids.dtype == torch.int32 and j_ids.dtype == np.int32
    assert tuple(t_ids.shape) == j_ids.shape == (1024,)
    np.testing.assert_array_equal(t_ids.numpy(), j_ids)
    assert t_s == int(j_s) == 0
    assert t_ids.device.type == "cpu"


def test_entry_is_bunny_as_shipped():
    """bunny.json path-traced at its own film, depth and sample count
    (goblin_tpu's entry() overrides only the method), trace width 8."""
    with open(te.BUNNY) as f:
        shipped = json.load(f)["render_setting"]
    _, meta = te.load_scene(te.BUNNY, {"render_method": "path_tracing"},
                            device="cpu")
    spec = meta.camera.film
    assert (spec.x_res, spec.y_res) == (512, 384) and meta.trace_wide == 8
    assert meta.settings["render_method"] == "path_tracing"
    for key in ("max_ray_depth", "sample_per_pixel"):
        assert meta.settings[key] == shipped[key], key
    assert meta.settings["max_ray_depth"] == 20


def test_dryrun_scene_is_graft_entrys(tmp_path, monkeypatch):
    """The document and plane.obj that __graft_entry__ writes, read back
    from its load_scene call, equal the port's."""
    import __graft_entry__ as ge
    from goblin_tpu.scene import loader as jloader

    seen = []

    class Seen(Exception):
        pass

    def record(path, overrides=None):
        seen.append(path)
        raise Seen

    monkeypatch.setattr(jloader, "load_scene", record)
    with pytest.raises(Seen):
        ge._tiny_scene_for_dryrun()
    with open(seen[0]) as f:
        assert json.load(f) == te.DRYRUN_SCENE
    with open(os.path.join(os.path.dirname(seen[0]), "plane.obj")) as f:
        assert f.read() == te.PLANE_OBJ
    path = te.write_dryrun_scene(str(tmp_path))
    with open(path) as f:
        assert json.load(f) == te.DRYRUN_SCENE


@pytest.fixture(scope="module")
def j_dryrun_step(tmp_path_factory):
    """goblin_tpu's make_sharded_train_step on the dryrun scene over an
    8-device mesh, and its params."""
    from goblin_tpu.integrators.path import make_li as j_make_li
    from goblin_tpu.parallel import mesh as jmesh

    path = te.write_dryrun_scene(str(tmp_path_factory.mktemp("dryrun")))
    js, jm = _j_load_on_one_tree(path)
    step, sc = jmesh.make_sharded_train_step(js, jm, j_make_li(jm),
                                             jmesh.make_mesh(8))
    return step, (sc["lights"]["color"], sc["tex_atlas"])


def _j_loss_and_l1(j_dryrun_step, ids):
    import jax.numpy as jnp

    step, params = j_dryrun_step
    loss, grads = step(params, jnp.asarray(ids), jnp.int32(0))
    return float(loss), sum(float(jnp.abs(g).sum()) for g in grads)


def test_dryrun_two_ranks_matches_goblin_tpu(j_dryrun_step, capsys):
    loss, grad_l1 = te.dryrun_multichip(2, device="cpu")
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert re.fullmatch(r"dryrun_multichip\(2\): loss=\d+\.\d{5} "
                        r"grad_l1=\d+\.\d{5} ok", line), line
    ids = te.dryrun_batch(2, "cpu").numpy()
    assert ids.shape == (64,) and len(set(ids.tolist())) == 64
    ref_loss, ref_l1 = _j_loss_and_l1(j_dryrun_step, ids)
    assert loss == pytest.approx(ref_loss, rel=1e-4)
    assert grad_l1 == pytest.approx(ref_l1, rel=1e-4)
    assert loss > 0 and grad_l1 > 0


def test_goblin_tpus_dryrun_batch_sees_black(j_dryrun_step):
    """__graft_entry__'s batch, the first n x 32 pixel ids, lies in the
    film's top six rows for n < 7, which see only the black background:
    loss and gradients 0, so its dryrun holds only at 7 devices and more
    (in batches of 64 ids, the jitted step's shape). The port strides its
    batch."""
    for lo in (0, 64, 128):
        ids = np.arange(lo, lo + 64, dtype=np.int32)
        assert _j_loss_and_l1(j_dryrun_step, ids) == (0.0, 0.0), lo
    loss, grad_l1 = _j_loss_and_l1(j_dryrun_step,
                                   np.arange(192, 256, dtype=np.int32))
    assert loss > 0 and grad_l1 > 0


def test_dryrun_refuses_cuda_without_the_cards(monkeypatch):
    """More ranks than visible cards raises before any rank starts: NCCL
    puts one rank on a card, and nothing falls back to the CPU."""
    def no_launch(*a, **kw):
        raise AssertionError("a rank was started")

    monkeypatch.setattr(multihost, "launch_local", no_launch)
    n = torch.cuda.device_count() + 1 if torch.cuda.is_available() else 2
    with pytest.raises(RuntimeError, match="CUDA cards visible"):
        te.dryrun_multichip(n, device="cuda")


def test_dryrun_raises_with_a_failed_ranks_log(monkeypatch):
    """A rank that cannot join its group fails the dryrun, and the error
    carries the rank's log."""
    monkeypatch.setenv("GOBLIN_DIST", "auto")  # env:// with no address
    for key in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(RuntimeError, match=r"rank 0 exited with \d+:\n"
                                           r"(?s:.*)env:// rendezvous"):
        te.dryrun_multichip(2, device="cpu")


@pytest.mark.cuda
def test_entry_on_the_card():
    """entry() on the card against the CPU at the image bar, 38 launches of
    the width-8 kernel a call (depth 20: 1 + 2 x 18 + 1)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from goblin_tpu_torch.ops import trace as tt

    fn, (ids, s_idx) = te.entry()
    assert ids.device.type == "cuda"
    cpu_fn, _ = te.entry(device="cpu")
    for pix, s in ((ids, s_idx), (torch.as_tensor(STRIDED).cuda(), 3)):
        tt.reset_launches()
        got = fn(pix, s)
        assert tt.launches["trace_bvh8"] == 38
        assert sum(tt.launches.values()) == 38
        _radiance_agrees(got.cpu().numpy(), cpu_fn(pix.cpu(), s).numpy())
