"""What makes two compiles the same compile: the compile cache's keys.

The port of the JAX package's `compilecache/keys.py`. An entry is shared
only when every input that shaped it matches, and the key folds them all:

- the program fingerprint, what the tenant declares its program to be
  (replicas of one pod share it);
- the topology, the devices it was compiled for and, for a card, its
  compute capability and name (Triton's binaries are built for one);
- the runtime versions: torch with its CUDA build, and Triton. Inductor's
  artifacts are not stable across versions, so a new version misses.

`sanitize_fingerprint`, `topology_fingerprint` (with no card) and
`entry_key` give the JAX functions' bytes for the same components, so one
node store serves both kinds of tenant without a collision.
"""

from __future__ import annotations

import hashlib
import os
import re

# the characters of a fingerprint that may reach an annotation and a file
# name: no quotes, slashes or newlines
_FP_KEEP = set("abcdefghijklmnopqrstuvwxyz"
               "ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789._-")
FINGERPRINT_MAX_LEN = 64


def sanitize_fingerprint(raw: str | None) -> str:
    """The fingerprint cut to its charset and length; "" (none) for
    garbage."""
    if not raw:
        return ""
    return "".join(c for c in raw if c in _FP_KEEP)[:FINGERPRINT_MAX_LEN]


def topology_fingerprint(devices, card: str | None = None) -> str:
    """Device count and sorted (host index, mesh) cells of the enforced
    devices (`config.vtpu_config.DeviceConfig`), as the JAX package writes
    it; `card` ("sm_90:NVIDIA H100 80GB HBM3") follows an `@`."""
    coords = sorted((d.host_index,) + tuple(d.mesh) for d in devices)
    topo = f"n{len(coords)}:" + ",".join(
        "/".join(str(c) for c in cell) for cell in coords)
    return f"{topo}@{card}" if card else topo


def runtime_versions() -> tuple[str, str]:
    """(torch, Triton) as key components, from the installed
    distributions' metadata: nothing is imported. `VTPU_TORCH_VERSION` and
    `VTPU_TRITON_VERSION` override them for pinned images."""
    torch_v = os.environ.get("VTPU_TORCH_VERSION", "")
    triton_v = os.environ.get("VTPU_TRITON_VERSION", "")
    if not torch_v:
        torch_v = _dist_version("torch")
        cuda = _torch_cuda_build()
        if torch_v and cuda:
            torch_v = f"{torch_v};cuda={cuda}"
    if not triton_v:
        triton_v = _dist_version("triton") or _dist_version("pytorch-triton")
    return torch_v or "none", triton_v or "none"


def _dist_version(dist: str) -> str:
    from importlib import metadata
    try:
        return metadata.version(dist)
    except metadata.PackageNotFoundError:
        return ""


def _torch_cuda_build() -> str:
    """The CUDA version torch was built with, read from the text of its
    installed `torch/version.py` ("" for a CPU build)."""
    from importlib import metadata
    try:
        files = metadata.files("torch") or []
    except metadata.PackageNotFoundError:
        return ""
    for f in files:
        if str(f).replace("\\", "/") == "torch/version.py":
            try:
                text = f.read_text() or ""
            except OSError:
                return ""
            m = re.search(r"^cuda\b[^=]*=\s*['\"]([^'\"]+)['\"]", text,
                          re.MULTILINE)
            return m.group(1) if m else ""
    return ""


def entry_key(program_fingerprint: str, topology: str,
              runtime_version: str, compiler_version: str) -> str:
    """sha256 hex over the components, each prefixed with its length so
    ("ab", "c") and ("a", "bc") cannot meet."""
    h = hashlib.sha256()
    for part in (program_fingerprint, topology, runtime_version,
                 compiler_version):
        raw = part.encode()
        h.update(f"{len(raw)}:".encode())
        h.update(raw)
    return h.hexdigest()
