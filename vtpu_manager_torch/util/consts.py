"""The variables and names a tenant's enforcement reads.

The limit variables keep the names the JAX package gives them
(`vtpu_manager/util/consts.py:444-451`), so one device plugin can inject the
same environment into a TPU tenant and a GPU tenant. This is the port's own
copy of the part it needs; the GPU-only names follow.
"""

from __future__ import annotations

ENV_MEM_LIMIT = "VTPU_MEM_LIMIT"            # + "_<i>" per device, bytes
ENV_CORE_LIMIT = "VTPU_CORE_LIMIT"          # + "_<i>", percent
ENV_CORE_SOFT_LIMIT = "VTPU_CORE_SOFT_LIMIT"
ENV_VISIBLE_DEVICES = "MANAGER_VISIBLE_DEVICES"    # host-index list
ENV_COMPAT_MODE = "MANAGER_COMPATIBILITY_MODE"
ENV_DISABLE_CONTROL = "DISABLE_VTPU_CONTROL"

# Compatibility modes (bitmask); the default counts every process.
COMPAT_HOST = 0x01

# Core-limit policies of a device (the JAX package's config/vtpu_config.py).
CORE_LIMIT_NONE = 0
CORE_LIMIT_HARD = 1
CORE_LIMIT_SOFT = 2

MANAGER_BASE_DIR = "/etc/vtpu-manager"
DRIVER_DIR = f"{MANAGER_BASE_DIR}/driver"          # interposer install dir

# GPU side: the interposer is preloaded into the tenant and forwards to the
# real driver named here (libcuda.so.1 from the loader's path when unset).
ENV_LD_PRELOAD = "LD_PRELOAD"
ENV_REAL_CUDA_LIBRARY_PATH = "VTPU_REAL_CUDA_LIBRARY_PATH"
ENV_SHIM_PATH = "VTPU_SHIM_PATH"
CONTROL_LIBRARY_NAME = "libvtpu-cuda-control.so"
