"""tripled_tpu_torch and chip_smoke.py run where there is no JAX: they
import none of jax, flax, optax or tripled_tpu."""

import ast
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "flax", "optax", "tripled_tpu")
SOURCES = sorted((REPO / "tripled_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imported_roots(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_imports(path):
    assert not set(_imported_roots(path)) & set(FORBIDDEN)


def test_package_import_leaves_jax_out():
    code = (
        "import sys, importlib, pkgutil, tripled_tpu_torch\n"
        "for m in pkgutil.walk_packages(tripled_tpu_torch.__path__, 'tripled_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)
