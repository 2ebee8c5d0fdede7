"""The port's layers import one way: ``models/`` -> ``parallel/`` ->
``ops/`` -> ``utils/`` (and ``csrc/``).

Every module of ``libstacker_tpu_torch/`` is parsed with ``ast`` (no
import runs) and each of its imports, at the top of the file or inside a
function, relative or absolute, is resolved to a module of the package:

- no module under ``ops/``, ``utils/`` or ``parallel/`` imports from
  ``models``;
- no module under ``ops/`` or ``utils/`` imports from ``parallel``.

``utils/profile.py`` is the one exception: a command-line profiler that
runs the package's entry points (``keypoint_match_arrays``,
``ecc_match_arrays``), so it imports the package from above.
"""

import ast
from pathlib import Path

import pytest

PKG = "libstacker_tpu_torch"
ROOT = Path(__file__).resolve().parents[1] / PKG
MODULES = sorted(p.relative_to(ROOT).as_posix() for p in ROOT.rglob("*.py"))
# layer -> the layers above it, which it must not import
FORBIDDEN = {
    "parallel": {"models"},
    "ops": {"models", "parallel"},
    "utils": {"models", "parallel"},
}
# a CLI that drives the entry points
EXCEPTIONS = {"utils/profile.py"}


def _package_of(rel: str) -> list:
    """The dotted package a module's relative imports start from."""
    parts = [PKG] + rel[: -len(".py")].split("/")
    return parts[:-1]


def _imported(rel: str, root: Path = ROOT) -> set:
    """Every module of the package ``rel`` imports (dotted names)."""
    tree = ast.parse((root / rel).read_text(), filename=rel)
    package = _package_of(rel)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = package[: len(package) - (node.level - 1)]
                mod = ".".join(base + ([node.module] if node.module else []))
            else:
                mod = node.module or ""
            out.add(mod)
            # `from .. import models` names a module, not a member
            out.update(f"{mod}.{a.name}" for a in node.names)
    return {m for m in out if m == PKG or m.startswith(PKG + ".")}


def _layer(dotted: str):
    parts = dotted.split(".")
    return parts[1] if len(parts) > 1 else None


def test_resolves_relative_and_absolute_imports(tmp_path):
    """The resolver sees both spellings, at any depth of a function."""
    fake = tmp_path / PKG / "ops"
    fake.mkdir(parents=True)
    (fake / "x.py").write_text(
        "from ..models import ecc\n"
        "def f():\n"
        "    import libstacker_tpu_torch.parallel.mesh\n"
        "    from .. import models\n")
    got = {_layer(m) for m in _imported("ops/x.py", tmp_path / PKG)}
    assert {"models", "parallel"} <= got


@pytest.mark.parametrize("rel", MODULES)
def test_module_imports_point_down(rel):
    layer = rel.split("/")[0] if "/" in rel else None
    above = FORBIDDEN.get(layer, set())
    if rel in EXCEPTIONS:
        above = set()
    bad = sorted(m for m in _imported(rel) if _layer(m) in above)
    assert not bad, f"{rel} (layer {layer!r}) imports from above: {bad}"


@pytest.mark.parametrize("rel", sorted(EXCEPTIONS))
def test_exception_is_still_needed(rel):
    """The exception names a module that does import the entry points."""
    assert f"{PKG}.ecc_match_arrays" in _imported(rel)
