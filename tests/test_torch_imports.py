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


# slice 16's modules: the quota names, the lease phase and the node tools
@pytest.mark.parametrize("rel", ["quota/__init__.py", "bench_quota_lease.py",
                                 "tools/vtpu_busy.py", "tools/vtpu_inspect.py",
                                 "tools/host_offload_demo.py",
                                 "tools/vtpu_device_client.py"])
def test_slice_16_modules_are_among_the_checked(rel):
    assert PKG / rel in _sources()


def test_the_registrar_imports_only_the_standard_library():
    """A tenant image has neither package: the registrar the interposer
    runs imports the standard library alone, and loads in an isolated
    interpreter (no site, no PYTHONPATH, no cwd on the path)."""
    path = PKG / "tools" / "vtpu_device_client.py"
    roots = set(_imported_roots(path)) - {"__future__"}
    assert roots and roots <= set(sys.stdlib_module_names), roots
    assert not roots & (FORBIDDEN | {"vtpu_manager_torch"})
    code = ("import importlib.util as u, sys\n"
            f"s = u.spec_from_file_location('r', {str(path)!r})\n"
            "m = u.module_from_spec(s); s.loader.exec_module(m)\n"
            "bad = sorted(n for n in sys.modules if n.split('.')[0] in\n"
            "             ('torch', 'numpy', 'jax', 'vtpu_manager',\n"
            "              'vtpu_manager_torch'))\n"
            "print('BAD', bad); sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-I", "-c", code], cwd="/",
                         capture_output=True, text=True, timeout=60)
    assert res.returncode == 0, res.stdout + res.stderr
