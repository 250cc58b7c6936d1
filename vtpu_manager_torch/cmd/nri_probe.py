"""Checks the port's NRI transport against a live runtime's NRI socket.

    python -m vtpu_manager_torch.cmd.nri_probe --socket /var/run/nri/nri.sock

The port of the JAX package's `cmd/nri_probe.py`. The transport is written
from the protocol's description (ttrpc framing, the mux's connection ids,
the field numbers of its own proto3 codec); this probe runs on a node
against the real runtime and reports each step, in order:

  1. connect      the socket accepts a stream connection
  2. register     Runtime.RegisterPlugin round-trips: framing, channel ids,
                  service and method names and the request's field numbers
                  are what the runtime accepts
  3. configure    the runtime calls Plugin.Configure on the plugin's channel
                  and takes the reply (the event mask)
  4. synchronize  the runtime's Synchronize decodes to pods whose uids are
                  strings
  5. idle         the connection stays up for --hold seconds

Exit code 0: every step passed, and the NRISupport gate can be turned on.
Otherwise the number of the first step that failed. The probe's hook only
observes: it adjusts and refuses no container.
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        description="check the port's NRI transport against a live runtime")
    parser.add_argument("--socket", default="/var/run/nri/nri.sock")
    parser.add_argument("--hold", type=float, default=5.0,
                        help="seconds to hold the attachment in step 5")
    parser.add_argument("--timeout", type=float, default=10.0)
    args = parser.parse_args(argv)

    from vtpu_manager_torch.kubeletplugin.nri_transport import NriPlugin

    failed = []

    def step(name: str, ok: bool, detail: str = "") -> bool:
        if not ok:
            failed.append(name)
        print(f"[{'PASS' if ok else 'FAIL'}] {name}"
              + (f": {detail}" if detail else ""), flush=True)
        return ok

    def wait_for(done, timeout: float) -> None:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline and not done():
            time.sleep(0.05)

    plugin = NriPlugin(ObserveOnlyHook(), plugin_name="vtpu-nri-probe",
                       plugin_idx="99")
    session = None
    try:
        if not os.path.exists(args.socket):
            step("connect", False, f"{args.socket} does not exist: is NRI "
                 "enabled in the runtime? (containerd: [plugins."
                 "'io.containerd.nri.v1.nri'] disable = false)")
            return 1
        try:
            session = plugin.run(args.socket)
        except OSError as e:
            step("connect", False, str(e))
            return 1
        except Exception as e:  # noqa: BLE001 - connected, then refused
            step("connect", True)
            step("register", False,
                 f"{type(e).__name__}: {e}: the runtime refused or dropped "
                 "RegisterPlugin")
            return 2
        step("connect", True)
        step("register", True)

        wait_for(lambda: plugin.configured, args.timeout)
        if not step("configure", plugin.configured,
                    "" if plugin.configured else
                    f"no Configure call within {args.timeout}s: the mux "
                    "channel ids or the Plugin service name are likely "
                    "wrong"):
            return 3

        wait_for(lambda: plugin.synchronized is not None, args.timeout)
        if plugin.synchronized is None:
            step("synchronize", False,
                 f"no Synchronize within {args.timeout}s")
            return 4
        pods, containers = plugin.synchronized
        sane = all(isinstance(p.get("uid"), str) for p in pods)
        if not step("synchronize", sane,
                    f"{len(pods)} pods / {len(containers)} containers "
                    "decoded" + ("" if sane else ": uids did not decode as "
                                 "strings (PodSandbox field numbers)")):
            return 4

        t0 = time.monotonic()
        while time.monotonic() - t0 < args.hold:
            if not session.mux.alive():
                step("idle", False,
                     f"the runtime hung up after "
                     f"{time.monotonic() - t0:.1f}s (see its log for "
                     "'nri')")
                return 5
            time.sleep(0.2)
        step("idle", True, f"held {args.hold:.1f}s")
        print("\nAll steps passed. Enable the hook with "
              "--feature-gates=NRISupport=true or --nri-socket.", flush=True)
        return 0
    finally:
        if session is not None:
            session.close()
        if failed:
            print(f"\n{len(failed)} step(s) failed.", file=sys.stderr)


class ObserveOnlyHook:
    """Adjusts and refuses nothing: a tenant created during the probe is
    left to the node's own plugin."""

    def create_container(self, pod_sandbox, container):
        from vtpu_manager_torch.kubeletplugin.nri import ContainerAdjustment
        return ContainerAdjustment()


if __name__ == "__main__":
    sys.exit(main())
