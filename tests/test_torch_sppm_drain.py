"""SPPM's drain in pair form (integrators/sppm.py::drain_pairs, the card's
drain) against the turn loop (drain_loop, the CPU's), bit for bit.

On CPU tensors drain_match and drain_sum run their plain forms, so the pair
form is composed of them here: on the two-plane scene with the automatic
radius (about a hundred entries in the fullest cell), two chunks in a row;
on a chunk with no live entry; on a chunk whose entries all sit in one
cell; on the studio scene, whose Blinn, mirror, glass and mask materials
take bsdf_eval's other branches over the pairs. On a card (`-m cuda`): the
three kernels against their plain forms and the whole drain against the
loop on the full-size cell's first chunk, the SPPM state after 3 full-size
iterations against the loop's, and 6 kernel drains an iteration.

This file imports neither JAX nor goblin_tpu, so its card tests run on a
machine without them:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_sppm_drain.py
"""

import dataclasses
import json
import os

import pytest
import torch

from goblin_tpu_torch import telemetry
from goblin_tpu_torch.integrators import sppm
from goblin_tpu_torch.scene.loader import load_scene
from goblin_tpu_torch.shading import bsdf as bx

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUNNY = os.path.join(ROOT, "examples", "bunny.json")
STUDIO = os.path.join(ROOT, "examples", "bunny_studio.json")
SEED = 3000000417  # above 2**31, as a benchmark run's seeds may be
NO_ENTRY = 0x7FFFFFFF  # _grid_entries' hash of an entry that is not live
STATE = ("Ld_acc", "Ni", "Tau", "radius", "emitted", "it")


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def fresh_counters():
    saved = dict(telemetry.counters)
    telemetry.counters.clear()
    yield
    telemetry.counters.clear()
    telemetry.counters.update(saved)


def _two_planes(tmp_path, res=(24, 18)):
    """tests/test_sppm.py's scene: a floor and a wall lit by a point light,
    no radius set (the automatic one)."""
    doc = {
        "render_setting": {"render_method": "sppm", "sample_per_pixel": 1,
                           "max_ray_depth": 3},
        "camera": {"position": [0, 1.2, -2.2], "euler": [20, 0, 0],
                   "rotation_order": "xyz", "fov": 50.0,
                   "film": {"resolution": list(res)},
                   "filter": {"type": "box", "width": [0.5, 0.5]}},
        "geometries": [{"name": "floor", "type": "mesh", "file": "plane.obj"}],
        "textures": [{"format": "color", "name": "grey", "type": "constant",
                      "color": [0.7, 0.7, 0.7]}],
        "materials": [{"name": "diffuse", "type": "lambert", "Kd": "grey"}],
        "primitives": [
            {"type": "model", "name": "fm", "geometry": "floor",
             "material": "diffuse"},
            {"type": "instance", "name": "fi", "model": "fm",
             "scale": [30, 30, 30]},
            {"type": "instance", "name": "wall", "model": "fm",
             "position": [0, 0, 2.0], "euler": [-90, 0, 0],
             "rotation_order": "xyz", "scale": [30, 30, 30]},
        ],
        "lights": [{"name": "key", "type": "point", "intensity": [10, 10, 10],
                    "position": [0.5, 2.5, -0.5]}],
    }
    (tmp_path / "plane.obj").write_text(
        "v -1 0 1\nv 1 0 1\nv -1 0 -1\nv 1 0 -1\n"
        "vn 0 1 0\nf 1//1 2//1 3//1\nf 3//1 2//1 4//1\n")
    path = tmp_path / "scene.json"
    path.write_text(json.dumps(doc))
    return str(path)


def _at_film(scene, meta, film):
    spec = dataclasses.replace(meta.camera.film, x_res=film[0],
                               y_res=film[1])
    meta.camera = dataclasses.replace(meta.camera, film=spec)
    return scene, meta


class Drains:
    """A scene's iteration up to its drains: the ray pass at iteration it,
    the radius (the scene's, or the automatic one), the cell layout and
    make_photon_passes' deposit_chunk."""

    def __init__(self, scene, meta, it=0):
        self.scene, self.meta = scene, meta
        spec = meta.camera.film
        self.n_pix = spec.x_res * spec.y_res
        self.max_len = int(meta.settings["max_ray_depth"])
        dev = scene["tri_rows"].device
        ids = torch.arange(self.n_pix, dtype=torch.int32, device=dev)
        _, self.vp = sppm.make_ray_pass(scene, meta, SEED, self.max_len,
                                        1)(ids, it)
        r0 = float(meta.settings["initial_radius"])
        self.radius = (sppm._auto_radius(self.vp, spec.x_res, spec.y_res)
                       .expand(self.n_pix).clone() if r0 <= 0.0 else
                       torch.full((self.n_pix,), r0, device=dev))
        self.bbox_min, self.inv_len, self.max_r = sppm.vp_cell_meta(
            self.vp, self.radius)
        self.deposit, _ = sppm.make_photon_passes(
            scene, meta, SEED + 77, self.max_len, self.n_pix)
        self.it, self.dev = it, dev

    def chunk(self, lo, n):
        ids = torch.arange(lo, lo + n, dtype=torch.int32, device=self.dev)
        return self.deposit(ids, self.it, self.bbox_min, self.inv_len,
                            self.max_r)

    def match_args(self, chunk):
        """drain_match's arguments for a chunk, as drain_pairs makes them."""
        rows, e_hash, e_idx = chunk
        start, end = sppm._drain_cells(self.vp, e_hash, self.bbox_min,
                                       self.inv_len, self.n_pix)
        budget = float(self.max_len) - self.vp["len"].to(torch.float32)
        return (start, end, e_idx, rows, self.vp["p"],
                self.radius * self.radius, budget)

    def zeros(self):
        return (torch.zeros((self.n_pix, 3), device=self.dev),
                torch.zeros(self.n_pix, device=self.dev))

    def run(self, drain, chunk, Phi, Mi):
        rows, e_hash, e_idx = chunk
        return drain(self.scene, self.meta, self.max_len, self.n_pix,
                     self.vp, self.radius, rows, e_hash, e_idx,
                     self.bbox_min, self.inv_len, Phi, Mi)

    def both(self, chunks, Phi, Mi):
        """Each drain form over the chunks in turn -> its (Phi, Mi), its
        turns and reads and the pair form's pairs."""
        out = {}
        for drain in (sppm.drain_loop, sppm.drain_pairs):
            telemetry.counters.clear()
            phi, mi = Phi, Mi
            for c in chunks:
                phi, mi = self.run(drain, c, phi, mi)
            out[drain.__name__] = (phi, mi, dict(telemetry.counters))
        return out


def _two_planes_chunks(tmp_path):
    d = Drains(*load_scene(_two_planes(tmp_path), device="cpu"))
    return d, [d.chunk(0, 4096), d.chunk(4096, 4096)], d.zeros()


def _no_live_entry(tmp_path):
    """The deposits' rows with no valid one: every entry is the sorted
    list's tail. Phi and Mi come in as earlier chunks left them."""
    d = Drains(*load_scene(_two_planes(tmp_path), device="cpu"))
    rows, _, _ = d.chunk(0, 4096)
    e_hash, e_idx = sppm._grid_entries(
        rows, torch.zeros(rows.shape[0], dtype=torch.bool), d.bbox_min,
        d.inv_len, d.max_r, d.n_pix)
    g = torch.Generator().manual_seed(5)
    Phi = torch.rand((d.n_pix, 3), generator=g)
    Mi = torch.randint(0, 9, (d.n_pix,), generator=g).to(torch.float32)
    return d, [(rows, e_hash, e_idx)], (Phi, Mi)


def _one_cell(tmp_path):
    """300 deposits moved to within a radius of one visible point, all in
    that point's cell: one run of 300 entries, the rest not live."""
    d = Drains(*load_scene(_two_planes(tmp_path), device="cpu"))
    rows, e_hash, e_idx = d.chunk(0, 4096)
    valid = torch.nonzero(d.vp["valid"])[:, 0]
    i0 = int(valid[len(valid) // 3])
    c = torch.floor((d.vp["p"][i0] - d.bbox_min) * d.inv_len).to(torch.int32)
    h0 = int(sppm._hash_cells(c[0:1], c[1:2], c[2:3], d.n_pix)[0])
    g = torch.Generator().manual_seed(6)
    K = 300
    sel = torch.randperm(rows.shape[0], generator=g)[:K]
    rows = rows.clone()
    r = float(d.radius[i0])
    rows[sel, 0:3] = d.vp["p"][i0] + (torch.rand((K, 3), generator=g)
                                      * 2.0 - 1.0) * r
    # each entry's path length within reach of the point's budget
    rows[sel, 9] = 2.0
    e_hash = torch.full_like(e_hash, NO_ENTRY)
    e_hash[:K] = h0
    e_idx = e_idx.clone()
    e_idx[:K] = sel.to(torch.int32)
    return d, [(rows, e_hash, e_idx)], d.zeros()


def _studio(tmp_path):
    """bunny_studio.json under SPPM at 48 x 36, depth 5, radius 0.1."""
    scene, meta = load_scene(STUDIO, {"render_method": "sppm",
                                      "initial_radius": 0.1}, device="cpu")
    d = Drains(*_at_film(scene, meta, (48, 36)))
    return d, [d.chunk(0, 4096)], d.zeros()


CASES = {"two_planes": _two_planes_chunks, "no_live_entry": _no_live_entry,
         "one_cell": _one_cell, "studio": _studio}


@pytest.mark.parametrize("case", list(CASES))
def test_pair_form_bit_equal_to_the_loop(tmp_path, case):
    """drain_pairs (the plain forms composed) == drain_loop: Phi and Mi by
    torch.equal, the same turns counted, one read a drain either way, and
    the pairs counted where some passed."""
    d, chunks, (Phi, Mi) = CASES[case](tmp_path)
    with torch.inference_mode():
        out = d.both(chunks, Phi, Mi)
    phi, mi, pairs = out["drain_pairs"]
    ref_phi, ref_mi, loop = out["drain_loop"]
    assert torch.equal(phi, ref_phi) and torch.equal(mi, ref_mi)
    n = len(chunks)
    assert loop["sppm.drain_reads"] == pairs["sppm.drain_reads"] == n
    assert loop["sppm.drain_turns"] == pairs["sppm.drain_turns"]
    assert pairs["sppm.drain_pairs"] == int((mi - Mi).sum())
    assert "sppm.drain_launches" not in pairs  # no kernel on the CPU
    if case == "no_live_entry":
        assert loop["sppm.drain_turns"] == pairs["sppm.drain_pairs"] == 0
        assert torch.equal(phi, Phi) and torch.equal(mi, Mi)
    elif case == "one_cell":
        assert pairs["sppm.drain_turns"] == 300
        assert 0 < pairs["sppm.drain_pairs"] < 300 * (mi > 0).sum()
    else:
        assert loop["sppm.drain_turns"] > 10 * n
        assert pairs["sppm.drain_pairs"] > 100


def test_the_two_plane_cell_holds_about_a_hundred_entries(tmp_path):
    d, chunks, _ = _two_planes_chunks(tmp_path)
    start, end = d.match_args(chunks[0])[:2]
    assert 50 < int((end - start).max()) < 200


def test_studio_pairs_take_masked_and_lambert_lanes(tmp_path):
    """The studio case's pairs reach a mask material's lanes (its inner
    Lambert scaled by alpha) beside plain Lambert ones, and the BSDF's
    Blinn branch runs over them (the scene has the kind)."""
    d, (chunk,), _ = _studio(tmp_path)
    test = d.match_args(chunk)
    counts = sppm.drain_match_plain(*test)
    ends = torch.cumsum(counts, 0)
    _, point = sppm.drain_match_plain(*test, fill=(counts, ends,
                                                   int(ends[-1])))
    mat = sppm.gather_material(d.scene, d.meta, {"mat": d.vp["mat"][point],
                                                 "uv": d.vp["uv"][point]})
    assert bool(mat["is_masked"].any()) and not bool(mat["is_masked"].all())
    assert bx._need(mat, bx.MAT_BLINN)


def test_match_plain_lists_pairs_in_point_then_turn_order(tmp_path):
    """The fill pass's pairs: points ascending, and within a point its
    entries in the order of the sorted list; as many as the counts say."""
    d, chunks, _ = _two_planes_chunks(tmp_path)
    test = d.match_args(chunks[0])
    start, end, e_idx = test[:3]
    counts = sppm.drain_match_plain(*test)
    assert counts.dtype == torch.int32 and counts.shape == (d.n_pix,)
    ends = torch.cumsum(counts, 0)
    row, point = sppm.drain_match_plain(*test, fill=(counts, ends,
                                                     int(ends[-1])))
    assert row.dtype == point.dtype == torch.int64
    assert row.shape[0] == int(counts.sum()) > 0
    assert bool((point[1:] >= point[:-1]).all())
    assert torch.equal(torch.bincount(point, minlength=d.n_pix),
                       counts.long())
    # within a point, its rows a subsequence of its cell's entries (a row
    # may come twice where two of its cells share a hash)
    for i in torch.unique(point).tolist():
        cell = iter(e_idx[int(start[i]):int(end[i])].tolist())
        assert all(r in cell for r in row[point == i].tolist())


def test_sum_plain_adds_in_pair_order():
    """drain_sum_plain: each point's contributions added one at a time, in
    pair order, onto what it held; 1 a pair into Mi."""
    g = torch.Generator().manual_seed(9)
    counts = torch.tensor([3, 0, 1, 4], dtype=torch.int32)
    ends = torch.cumsum(counts, 0)
    contrib = torch.rand((8, 3), generator=g) * 1e4 - 5e3
    Phi = torch.rand((4, 3), generator=g)
    Mi = torch.tensor([0.0, 2.0, 5.0, 1.0])
    phi, mi = sppm.drain_sum_plain(Phi, Mi, contrib, counts, ends)
    ref = Phi.clone()
    for i, (s, c) in enumerate(zip((ends - counts).tolist(),
                                   counts.tolist())):
        for j in range(s, s + c):
            ref[i] = ref[i] + contrib[j]
    assert torch.equal(phi, ref)
    assert torch.equal(mi, Mi + counts.to(torch.float32))


@pytest.mark.parametrize("what, x, dtype, shape", [
    ("start", torch.zeros(4, dtype=torch.int32), torch.int64, (4,)),
    ("rows", torch.zeros((4, 9)), torch.float32, (4, 10)),
    ("p", torch.zeros((4, 3), dtype=torch.float64), torch.float32, (4, 3)),
])
def test_the_kernels_refuse_what_they_do_not_take(what, x, dtype, shape):
    with pytest.raises(ValueError, match=what):
        sppm._checked(x, dtype, shape, what)


def test_checked_makes_a_strided_array_contiguous():
    x = torch.arange(12, dtype=torch.float32).reshape(4, 3).t()
    y = sppm._checked(x, torch.float32, (3, 4), "p")
    assert y.is_contiguous() and torch.equal(y, x)


def test_turns_read_carries_the_pair_total():
    start = torch.tensor([0, 2, 2, 7])
    end = torch.tensor([2, 2, 7, 9])
    assert sppm._drain_turns(start, end, 9) == (5, None)
    ends = torch.tensor([1, 1, 4, 6])
    assert sppm._drain_turns(start, end, 9, ends) == (5, 6)
    assert sppm._drain_turns(start, end, 3, ends) == (3, 6)


# --- on a card -------------------------------------------------------------


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _shipped(dev):
    """bunny.json as shipped: SPPM, 512 x 384, depth 20, radius 0.01."""
    return load_scene(BUNNY, {"seed": SEED}, device=dev)


@pytest.fixture(scope="module")
def first_chunk(card):
    """The full-size cell's first chunk of 32,768 photons at iteration 5,
    with its drain's inputs."""
    with torch.inference_mode():
        d = Drains(*_shipped(card), it=5)
        chunk = d.chunk(0, sppm.PHOTON_CHUNK)
        return d, chunk, d.match_args(chunk)


@pytest.mark.cuda
def test_kernels_bit_equal_to_their_plain_forms(first_chunk):
    d, _, test = first_chunk
    with torch.inference_mode():
        counts = sppm.drain_match(*test)
        ref_counts = sppm.drain_match_plain(*test)
        torch.cuda.synchronize()
        assert torch.equal(counts, ref_counts)
        ends = torch.cumsum(counts, 0, dtype=torch.int64)
        n_pairs = int(ends[-1])
        assert n_pairs > 1000
        fill = (counts, ends, n_pairs)
        row, point = sppm.drain_match(*test, fill=fill)
        ref_row, ref_point = sppm.drain_match_plain(*test, fill=fill)
        torch.cuda.synchronize()
        assert torch.equal(row, ref_row) and torch.equal(point, ref_point)
        g = torch.Generator(device=d.dev).manual_seed(11)
        contrib = torch.rand((n_pairs, 3), device=d.dev, generator=g)
        Phi = torch.rand((d.n_pix, 3), device=d.dev, generator=g)
        Mi = torch.rand(d.n_pix, device=d.dev, generator=g) * 9.0
        got = sppm.drain_sum(Phi, Mi, contrib, counts, ends)
        ref = sppm.drain_sum_plain(Phi, Mi, contrib, counts, ends)
        torch.cuda.synchronize()
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


@pytest.mark.cuda
def test_card_drain_bit_equal_to_the_loop(first_chunk):
    """The whole drain on the card's tensors, pair form against the loop,
    onto Phi and Mi that an earlier chunk left."""
    d, chunk, _ = first_chunk
    with torch.inference_mode():
        Phi, Mi = d.run(sppm.drain_pairs, chunk, *d.zeros())
        out = d.both([chunk], Phi, Mi)
        torch.cuda.synchronize()
    phi, mi, pairs = out["drain_pairs"]
    ref_phi, ref_mi, loop = out["drain_loop"]
    assert torch.equal(phi, ref_phi) and torch.equal(mi, ref_mi)
    assert loop["sppm.drain_turns"] == pairs["sppm.drain_turns"] > 10
    assert pairs["sppm.drain_launches"] == 1
    assert pairs["sppm.drain_pairs"] == int((mi - Mi).sum()) > 1000


@pytest.mark.cuda
def test_card_state_after_three_iterations_is_the_loops(card, monkeypatch):
    """make_sppm's state after 3 full-size iterations, its drains in pair
    form, against the same with drain_loop in drain_pairs' place; 6 kernel
    drains (one a photon chunk) an iteration."""
    def state():
        with torch.inference_mode():
            sp = sppm.make_sppm(*_shipped(card), seed=SEED)
            st = sp.new_state()
            for it in range(3):
                sp.iterate(st, it)
            torch.cuda.synchronize()
        return st

    got = state()
    launches = telemetry.counters.get("sppm.drain_launches", 0)
    reads = telemetry.counters.get("sppm.drain_reads", 0)
    assert launches == reads == 3 * 6
    assert telemetry.counters["sppm.drain_pairs"] > 3 * 6 * 1000
    monkeypatch.setattr(sppm, "drain_pairs", sppm.drain_loop)
    ref = state()
    for k in STATE:
        if torch.is_tensor(got[k]):
            assert torch.equal(got[k], ref[k]), k
        else:
            assert got[k] == ref[k], k
    assert telemetry.counters["sppm.drain_launches"] == launches
