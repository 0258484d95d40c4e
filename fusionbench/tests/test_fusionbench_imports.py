"""No module under fusionbench/ imports JAX or the JAX package (top-level
names compared whole), and the reference imports nothing of the port."""

import ast
from pathlib import Path

import pytest

PKG = Path(__file__).resolve().parents[1]
FILES = sorted(PKG.rglob("*.py"))


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(PKG)))
def test_no_jax(path):
    assert not top_level_imports(path) & {"jax", "jaxlib", "flax", "topfusion_tpu"}


@pytest.mark.parametrize("path", sorted((PKG / "reference").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PKG)))
def test_reference_is_plain(path):
    names = top_level_imports(path)
    assert "topfusion_tpu_torch" not in names and "fusionbench" not in names
    assert names <= {"torch", "numpy", "math", "dataclasses", "typing", "shutil",
                     "subprocess", "__future__"}


def test_the_scan_compares_whole_names(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import topfusion_tpu_torch.ops\nfrom jax import numpy\n")
    assert top_level_imports(f) == {"topfusion_tpu_torch", "jax"}
