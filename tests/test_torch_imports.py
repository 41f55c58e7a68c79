"""The port stands alone: nothing under ``src/repro_torch/``, and not
``chip_smoke.py``, imports ``jax`` or the reference package ``repro``
(checked on the source's syntax tree, so lazy imports count too)."""
import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "id", "") == "__import__" \
                and node.args and isinstance(node.args[0], ast.Constant):
            yield node.args[0].value


def test_port_files_found():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    assert "src/repro_torch/launch/serve.py" in names and "chip_smoke.py" in names
    assert "src/repro_torch/layers/ssm.py" in names
    assert len(names) > 15


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert bad == [], f"{path.relative_to(ROOT)} imports {bad}"


# the reference's TPU v5e roofline constants (repro/launch/mesh.py): the port
# prices its roofline with the H100's (repro_torch/launch/mesh.py)
TPU_CONSTANTS = ("197e12", "819e9", "ICI_BW")


@pytest.mark.parametrize("path", [p for p in FILES if "repro_torch" in p.parts],
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_tpu_constant_in_the_port(path):
    text = path.read_text()
    assert [c for c in TPU_CONSTANTS if c in text] == []


def test_the_dry_run_modules_are_covered():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    for mod in ("dryrun", "op_cost", "analysis", "specs"):
        assert f"src/repro_torch/launch/{mod}.py" in names
    assert "src/repro_torch/kernels/cost.py" in names
