"""Port's runtime client vs vtpu_manager.runtime.client on the same env
(the cases of tests/test_workloads.py:88-115)."""

import dataclasses

import pytest

from vtpu_manager.runtime import client as jclient
from vtpu_manager_torch.runtime import client
from vtpu_manager_torch.util import consts

ENVS = [
    {"VTPU_MEM_LIMIT_0": str(4 * 2**30), "VTPU_CORE_LIMIT_0": "25",
     "MANAGER_VISIBLE_DEVICES": "3"},
    {"VTPU_MEM_LIMIT": "1048576", "VTPU_CORE_LIMIT": "50",
     "MANAGER_VISIBLE_DEVICES": "0,1"},
    {"VTPU_MEM_LIMIT_0": "1048576", "VTPU_MEM_LIMIT_1": "2097152",
     "VTPU_CORE_LIMIT_0": "50", "VTPU_CORE_LIMIT_1": "10",
     "VTPU_CORE_SOFT_LIMIT_1": "40", "MANAGER_VISIBLE_DEVICES": "0,1"},
    {"VTPU_CORE_LIMIT_0": "0", "VTPU_MEM_LIMIT_0": "4096",
     "MANAGER_COMPATIBILITY_MODE": "4"},
    {},
]
LIMIT_VARS = ("VTPU_MEM_LIMIT", "VTPU_CORE_LIMIT", "VTPU_CORE_SOFT_LIMIT",
              "MANAGER_VISIBLE_DEVICES", "MANAGER_COMPATIBILITY_MODE",
              "DISABLE_VTPU_CONTROL")


@pytest.fixture
def clean_env(monkeypatch):
    import os
    for name in list(os.environ):
        if name.startswith(LIMIT_VARS):
            monkeypatch.delenv(name)
    monkeypatch.setenv("VTPU_CONFIG_PATH", "/nonexistent")
    return monkeypatch


@pytest.mark.parametrize("env", ENVS)
def test_env_limits_match_jax(clean_env, env):
    for name, value in env.items():
        clean_env.setenv(name, value)
    want = jclient.effective_limits()
    got = client.effective_limits()
    assert got.source == want.source
    assert got.compat_mode == want.compat_mode
    assert len(got.devices) == len(want.devices)
    for g, w in zip(got.devices, want.devices):
        for field in dataclasses.fields(g):
            assert getattr(g, field.name) == getattr(w, field.name), field


def test_disable_env(clean_env):
    clean_env.setenv("VTPU_MEM_LIMIT_0", "1")
    clean_env.setenv("DISABLE_VTPU_CONTROL", "1")
    assert client.effective_limits().source == "none"
    assert jclient.effective_limits().source == "none"


def test_limit_variable_names_are_shared():
    from vtpu_manager.util import consts as jconsts
    for name in ("ENV_MEM_LIMIT", "ENV_CORE_LIMIT", "ENV_CORE_SOFT_LIMIT",
                 "ENV_VISIBLE_DEVICES", "ENV_COMPAT_MODE",
                 "ENV_DISABLE_CONTROL", "COMPAT_HOST"):
        assert getattr(consts, name) == getattr(jconsts, name)


def test_install_requires_shim(tmp_path, clean_env):
    clean_env.delenv("VTPU_SHIM_PATH", raising=False)
    assert client.install(shim_path=str(tmp_path / "missing.so")) is None


def test_install_returns_the_tenant_env(tmp_path, clean_env):
    shim = tmp_path / consts.CONTROL_LIBRARY_NAME
    shim.write_bytes(b"")
    clean_env.setenv("LD_PRELOAD", "/opt/other.so")
    clean_env.delenv("VTPU_REAL_CUDA_LIBRARY_PATH", raising=False)
    env = client.install(shim_path=str(shim),
                         real_cuda_path="/usr/lib/libcuda.so.1")
    assert env == {"LD_PRELOAD": f"{shim}:/opt/other.so",
                   "VTPU_REAL_CUDA_LIBRARY_PATH": "/usr/lib/libcuda.so.1"}
    import os
    assert os.environ["LD_PRELOAD"] == "/opt/other.so"    # not applied
    client.install(shim_path=str(shim), apply=True)
    assert os.environ["LD_PRELOAD"].startswith(str(shim))
