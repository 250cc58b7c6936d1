"""The port stands alone: neither it nor chip_smoke.py imports JAX or any
module of the JAX package, by its source and by what actually loads."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "vtpu_manager_torch"
FORBIDDEN = {"jax", "jaxlib", "vtpu_manager"}


def _sources():
    return sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_source_imports_nothing_of_jax(path):
    bad = FORBIDDEN & set(_imported_roots(path))
    assert not bad, f"{path} imports {bad}"


# the node-resilience modules keep their own copies of the JAX package's
# failpoints, registry and debug modules
@pytest.mark.parametrize("rel", ["resilience/failpoints.py",
                                 "registry/server.py", "util/debug.py"])
def test_node_resilience_modules_are_among_the_checked(rel):
    assert PKG / rel in _sources()


def test_loading_every_module_loads_no_jax():
    modules = ["chip_smoke"] + [
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(
            ".__init__") for p in sorted(PKG.rglob("*.py"))]
    code = (
        "import importlib, sys\n"
        f"for name in {modules!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'vtpu_manager'))\n"
        "print('LOADED', len(sys.modules), 'BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120,
                         check=False)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "BAD []" in res.stdout
