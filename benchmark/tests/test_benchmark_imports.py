"""Nothing under benchmark/ imports JAX or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's),
and the reference imports nothing of the port."""

from __future__ import annotations

import ast

from .conftest import ROOT

BANNED = {"jax", "jaxlib", "flax", "dsd2dxd_tpu"}


def imports(path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_imports_jax_or_the_jax_package():
    files = list(ROOT.rglob("*.py"))
    assert len(files) > 10
    for p in files:
        assert not imports(p) & BANNED, p


def test_the_reference_imports_nothing_of_the_port():
    for p in (ROOT / "reference").rglob("*.py"):
        assert "dsd2dxd_tpu_torch" not in imports(p), p
        assert imports(p) <= {"__future__", "math", "struct", "dataclasses",
                              "fractions", "pathlib", "typing", "numpy",
                              "torch", "benchmark"}, p


def test_the_whole_name_is_compared():
    assert "dsd2dxd_tpu_torch".split(".")[0] not in BANNED
