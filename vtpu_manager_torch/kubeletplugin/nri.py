"""The NRI runtime hook's policy: check a container's claim at create time.

The port of the JAX package's `kubeletplugin/nri.py:35-113`. NRI shows the
hook every container the runtime creates on the node. A container that
names a claim (VTPU_CLAIM_UID in its environment, set by the claim's CDI
device) must name one that is prepared here and that its pod owns (the
claim's reservedFor, resolved by the transport), and for a claim of
several requests, a request that was prepared (VTPU_CLAIM_REQUEST). A
container that copies another tenant's environment is refused rather than
given that tenant's slice. An owned claim's container gets its config
directory mounted read-only at the node's config path and
VTPU_REGISTER_UUID. A container that names no claim is left untouched.

The adjustment only adds: it never removes or overrides the
VTPU_POD_UID and VTPU_CONTAINER_NAME the port's CDI spec sets
(`device_state.py` `_group_envs`), by which the interposer keeps a
claim's processes one tenant under one cap (fault R6 in ROADMAP.md).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field

from vtpu_manager_torch.kubeletplugin.cdi import slugify
from vtpu_manager_torch.kubeletplugin.device_state import DeviceState
from vtpu_manager_torch.util import consts

log = logging.getLogger(__name__)


@dataclass
class ContainerAdjustment:
    env: dict[str, str] = field(default_factory=dict)
    mounts: list[dict] = field(default_factory=list)
    rejected: bool = False
    reason: str = ""


class RuntimeHook:
    def __init__(self, state: DeviceState):
        self.state = state

    def create_container(self, pod_sandbox: dict,
                         container: dict) -> ContainerAdjustment:
        """One container at create time. `pod_sandbox` is {"uid",
        "claim_uids"}: the claims the transport found the pod owns;
        `container` is {"name", "env"}."""
        claimed = self._claimed_uid(container)
        if claimed is None:
            return ContainerAdjustment()      # not a tenant
        if claimed not in self.state.prepared_uids():
            return self._reject(f"container claims unprepared claim "
                                f"{claimed!r}")
        if claimed not in (pod_sandbox.get("claim_uids") or []):
            # the environment names a claim the pod does not own: a spoof
            return self._reject(f"pod {pod_sandbox.get('uid')} does not own "
                                f"claim {claimed!r}")
        claim_dir = f"{self.state.base_dir}/claim_{claimed}"
        # a claim of several requests has one config dir per request; the
        # request's marker picks it, and must name a prepared request, so a
        # container cannot mount a co-container's slice by editing it
        prepared = self.state.checkpoint.claims.get(claimed)
        requests = {d.get("request", "")
                    for d in (prepared.devices if prepared else [])}
        request = self._env_value(container, consts.ENV_CLAIM_REQUEST)
        if request is not None:
            if request not in requests:
                return self._reject(f"claim {claimed!r} has no prepared "
                                    f"request {request!r}")
            config_src = f"{claim_dir}/config_{slugify(request)}"
        elif requests - {""}:
            # no marker on a claim of several requests: the container was
            # not wired through a request's CDI device
            return self._reject(f"claim {claimed!r} is multi-request; "
                                "container carries no VTPU_CLAIM_REQUEST "
                                "marker")
        else:
            config_src = f"{claim_dir}/config"
        return ContainerAdjustment(
            env={consts.ENV_REGISTER_UUID: claimed},
            mounts=[{"source": config_src,
                     "destination": f"{consts.MANAGER_BASE_DIR}/config",
                     "options": ["ro", "rbind"]}])

    @staticmethod
    def _reject(reason: str) -> ContainerAdjustment:
        log.warning("runtime hook rejection: %s", reason)
        return ContainerAdjustment(rejected=True, reason=reason)

    @staticmethod
    def _env_value(container: dict, name: str) -> str | None:
        for entry in container.get("env") or []:
            if isinstance(entry, str):
                key, _, value = entry.partition("=")
            else:
                key, value = entry.get("name", ""), entry.get("value", "")
            if key == name:
                return value
        return None

    @classmethod
    def _claimed_uid(cls, container: dict) -> str | None:
        return cls._env_value(container, consts.ENV_CLAIM_UID)
