"""Builds the port's native code from the sources in the checkout.

Six artifacts, each compiled at first use into `build-torch/` at the
repo root, which .gitignore lists:

- the block-attention kernel, `csrc/attn_block.cu`, with nvcc for sm_90a
  into a shared library with a plain C interface (loaded with ctypes);
- `csrc/mma_peak.cu`, the card's mma.sync TF32 rate, which chip_smoke.py
  reads the kernel against;
- the interposer, `csrc/shim/*.cc`, with g++, and beside it the
  stdlib-only registrar `tools/vtpu_device_client.py` that a CLIENT-mode
  tenant's interposer runs;
- the fake driver and the harness that test the interposer without a card;
- the quota market's reclaim probe, `csrc/shim/test/quota_reclaim_probe.cc`,
  over the interposer's own reloader.

An artifact's file name carries a digest of its sources and command, so an
edited source is rebuilt and an unchanged one is reused. Builds take a file
lock, so concurrent test workers build once.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

PKG = Path(__file__).resolve().parent
REPO = PKG.parent
CSRC = PKG / "csrc"
SHIM_SRC = CSRC / "shim"
NVCC_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]


BUILD_DIR = REPO / "build-torch"


def _compile(stem: str, suffix: str, sources: list[Path],
             headers: list[Path], command: list[str],
             libs: tuple[str, ...] = ()) -> Path:
    """Runs `command` -o out `sources` `libs` unless `out` exists. Writes
    the compiler's output beside the artifact as <out>.log."""
    digest = hashlib.sha256()
    for path in [*sources, *headers]:
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    digest.update(" ".join([*command, *libs]).encode())
    out_dir = BUILD_DIR
    out_dir.mkdir(exist_ok=True)
    out = out_dir / f"{stem}-{digest.hexdigest()[:12]}{suffix}"
    if out.exists():
        return out
    with open(out_dir / f".{stem}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():
            return out
        tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
        # a compiler is never a tenant: keep an interposer out of it
        env = {k: v for k, v in os.environ.items() if k != "LD_PRELOAD"}
        res = subprocess.run([*command, "-o", str(tmp),
                              *[str(s) for s in sources], *libs],
                             capture_output=True, text=True, env=env,
                             check=False)
        Path(f"{out}.log").write_text(res.stdout + res.stderr)
        if res.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"building {stem} failed:\n"
                               f"{(res.stdout + res.stderr)[-4000:]}")
        os.replace(tmp, out)
    return out


def nvcc_path() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the kernel builds only where the "
                           "CUDA toolkit is installed")
    return found


def build_cuda(stem: str) -> Path:
    """csrc/<stem>.cu -> lib<stem>-<digest>.so (sm_90a)."""
    return _compile(
        f"lib{stem}", ".so", [CSRC / f"{stem}.cu"], [],
        [nvcc_path(), *NVCC_ARCH, "-std=c++17", "-O3", "-shared",
         "-Xcompiler", "-fPIC", "-Xptxas", "-v"])


def build_attn_kernel() -> Path:
    return build_cuda("attn_block")


REGISTRAR = PKG / "tools" / "vtpu_device_client.py"


def install_registrar(directory: Path | str) -> Path:
    """Copies the registrar into `directory` (beside an interposer) unless
    an identical copy is there; atomic, since a tenant may be starting it."""
    dst = Path(directory) / REGISTRAR.name
    data = REGISTRAR.read_bytes()
    if not dst.exists() or dst.read_bytes() != data:
        tmp = dst.with_name(f".{dst.name}.{os.getpid()}.tmp")
        tmp.write_bytes(data)
        os.replace(tmp, dst)
    return dst


def build_shim() -> Path:
    """The interposer: csrc/shim/*.cc -> libvtpu-cuda-control-<digest>.so,
    with the registrar beside it."""
    out = _compile(
        "libvtpu-cuda-control", ".so",
        [SHIM_SRC / "loader.cc", SHIM_SRC / "enforce_mem.cc",
         SHIM_SRC / "enforce_rate.cc", SHIM_SRC / "enforce_comm.cc",
         SHIM_SRC / "enforce_quota.cc"],
        [SHIM_SRC / "shim.h", SHIM_SRC / "cuda_subset.h",
         SHIM_SRC / "vtpu_abi.h", SHIM_SRC / "vtpu_telemetry_abi.h",
         SHIM_SRC / "vtpu_quota_abi.h"],
        ["g++", "-std=c++17", "-O2", "-Wall", "-fPIC", "-shared",
         "-fvisibility=hidden", "-Wl,-Bsymbolic"], libs=("-ldl", "-lpthread"))
    install_registrar(out.parent)
    return out


def build_fake_driver() -> Path:
    """A stand-in libcuda.so.1 for testing the interposer with no card."""
    return _compile(
        "libcuda-fake", ".so", [SHIM_SRC / "test" / "fake_cuda_driver.cc"],
        [SHIM_SRC / "cuda_subset.h"],
        ["g++", "-std=c++17", "-O2", "-Wall", "-fPIC", "-shared",
         "-Wl,-Bsymbolic", "-Wl,-soname,libcuda.so.1"], libs=("-lpthread",))


def build_shim_test() -> Path:
    return _compile(
        "cuda_shim_test", "", [SHIM_SRC / "test" / "cuda_shim_test.cc"],
        [SHIM_SRC / "cuda_subset.h"],
        ["g++", "-std=c++17", "-O2", "-Wall", "-pthread"], libs=("-ldl",))


def build_quota_probe() -> Path:
    """The reclaim probe: the interposer's reloader in the throttle loop's
    quantum, one ADOPT line per generation it takes."""
    return _compile(
        "quota_reclaim_probe", "",
        [SHIM_SRC / "test" / "quota_reclaim_probe.cc"],
        [SHIM_SRC / "vtpu_quota_abi.h", SHIM_SRC / "vtpu_abi.h"],
        ["g++", "-std=c++17", "-O2", "-Wall", f"-I{SHIM_SRC}"])


def build_for_card() -> dict:
    """The kernel, the mma probe and the interposer, built side by side.
    Returns their paths and the wall seconds the builds took together."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=3) as pool:
        futures = {"attn_block": pool.submit(build_attn_kernel),
                   "mma_peak": pool.submit(build_cuda, "mma_peak"),
                   "shim": pool.submit(build_shim)}
        paths = {name: f.result() for name, f in futures.items()}
    return {**paths, "seconds": time.perf_counter() - t0}
