"""The seam of goblin_tpu_torch/integrators/direct.py: the integrators light
a surface vertex through it, and none samples a light or weighs a sample
by MIS with its own copy of that code. Read from the sources with ast, so
no scene is loaded."""

import ast
import pathlib

import pytest

PACKAGE = pathlib.Path(__file__).resolve().parents[1] / "goblin_tpu_torch"
INTEGRATORS = PACKAGE / "integrators"
WALKS = ({"sample_li", "pdf_li", "power_heuristic"},
         {"direct.sample_light", "direct.light_side", "direct.bsdf_side",
          "direct.bsdf_throughput"})


def _called(path):
    """The names a module calls: a bare name, or base.attr."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if isinstance(f, ast.Name):
            names.add(f.id)
        elif isinstance(f, ast.Attribute):
            base = f.value.id if isinstance(f.value, ast.Name) else "?"
            names.add(f"{base}.{f.attr}")
    return names


@pytest.mark.parametrize("module, banned, needed", [
    ("path.py", *WALKS),
    ("wavefront.py", *WALKS),
    ("sppm.py", *WALKS),
    ("whitted.py", {"sample_li"}, {"direct.light_side"}),
])
def test_surface_lighting_goes_through_direct(module, banned, needed):
    """path.py, wavefront.py and sppm.py call neither lt.sample_li,
    lt.pdf_li nor power_heuristic (under any base name); Whitted's light
    side samples no light itself. Each calls direct.py's steps."""
    called = _called(INTEGRATORS / module)
    own = {n for n in called if n.rsplit(".", 1)[-1] in banned}
    assert not own, f"{module} lights a vertex itself: {sorted(own)}"
    assert needed <= called, sorted(needed - called)


def test_emission_lookups_have_one_home():
    """The emission lookups are direct.py's public names: no module of the
    package defines or imports them under the private names they had in
    path.py and splatting.py."""
    old = {"_area_light_Le", "_env_le", "_env_le_at", "_em_tri_data"}
    for path in PACKAGE.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.FunctionDef):
                assert node.name not in old, (path, node.name)
            elif isinstance(node, ast.ImportFrom):
                names = {a.name for a in node.names}
                assert not names & old, (path, names & old)
            elif isinstance(node, ast.Attribute):
                assert node.attr not in old, (path, node.attr)
    tree = ast.parse((INTEGRATORS / "direct.py").read_text())
    public = {n.name for n in tree.body if isinstance(n, ast.FunctionDef)}
    assert {"area_light_le", "env_le", "env_le_at", "em_tri_data"} <= public
