"""The port's build cache: an artifact is rebuilt when a source or a listed
header changes, and reused when nothing does. The compile command is a
stand-in (Python writing the output), so no compiler is needed."""

import sys

import pytest

from vtpu_manager_torch import build

# writes the output named after -o, like a compiler would
FAKE_COMPILER = [sys.executable, "-c",
                 "import sys; a = sys.argv; open(a[a.index('-o') + 1], 'w')"
                 ".write('built')"]


@pytest.fixture
def tree(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    src = tmp_path / "kernel.cu"
    header = tmp_path / "kernel.cuh"
    src.write_text("#include \"kernel.cuh\"\n")
    header.write_text("constexpr int kTile = 64;\n")
    return src, header


def _build(src, header):
    return build._compile("libkernel", ".so", [src], [header], FAKE_COMPILER)


def test_unchanged_sources_reuse_the_artifact(tree):
    first = _build(*tree)
    assert first.read_text() == "built"
    assert _build(*tree) == first


@pytest.mark.parametrize("edited", [0, 1], ids=["source", "header"])
def test_an_edited_file_rebuilds(tree, edited):
    first = _build(*tree)
    path = tree[edited]
    path.write_text(path.read_text() + "// edited\n")
    second = _build(*tree)
    assert second != first and second.exists()


def test_attn_kernel_lists_every_file_it_includes(monkeypatch):
    # the kernel's digest covers each csrc file the .cu includes
    seen = {}

    def fake_compile(stem, suffix, sources, headers, command, libs=()):
        seen.update(sources=sources, headers=headers, command=command)
        return build.BUILD_DIR / stem

    monkeypatch.setattr(build, "_compile", fake_compile)
    monkeypatch.setattr(build, "nvcc_path", lambda: "nvcc")
    build.build_attn_kernel()
    included = {line.split('"')[1]
                for src in seen["sources"]
                for line in src.read_text().splitlines()
                if line.startswith("#include \"")}
    assert included == {h.name for h in seen["headers"]}
    assert "arch=compute_90a,code=sm_90a" in seen["command"]
