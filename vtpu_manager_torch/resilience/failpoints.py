"""Failpoint registry: named fault-injection sites.

The port of the JAX package's `resilience/failpoints.py` (the etcd gofail
pattern), whole: the site catalog `SITES`, `enable`, `disable`, `arm`,
`disarm`, `armed_sites`, `stats`, `fire`, `CrashFailpoint`, the
`partial-write` truncation, the `failpoint.<site>` trace event of each
fire, the `VTPU_FAILPOINTS` grammar (`arm_spec`) and
`render_failpoint_metrics`. The same seed, arms and calls give the JAX
registry's fire sequence, stats and metrics text.

Every load-bearing step of the node's allocation path calls
``failpoints.fire("<site>", **ctx)``. Unarmed, ``fire`` is one dict
lookup returning None: the FaultInjection gate's "default off" cost. An
armed site consults its spec: a seeded RNG decides probabilistically, a
count bounds total fires, a ``match`` dict selects by context, and the
action runs:

- ``error``   raise a KubeError with the chosen status (or ``exc``): the
              transient failure a RetryPolicy must absorb;
- ``latency`` sleep a fixed delay: the slow dependency a deadline bounds;
- ``crash``   raise :class:`CrashFailpoint`, a **BaseException**, so
              ``except Exception`` recovery cannot swallow it: it
              propagates like process death at that line;
- ``partial-write`` truncate the file the site just wrote (ctx ``path``)
              to a seeded fraction, then crash: a torn file.

The sites fired in the port are those of the modules it has ported:
`kube.request` and `kube.watch` (`client/kube.py`, `client/fake.py`),
`flock.acquire`, `plugin.allocate`, `plugin.config_write`,
`plugin.record_devices`, `health.probe`, `dra.prepare`, `dra.cdi_write`,
`cache.write`, `cache.lease`, `trace.spool_flush` and `registry.register`.
The other sites stay in the catalog so that a JAX spec parses the same
way; nothing in the port fires them.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field
from random import Random

log = logging.getLogger(__name__)

# Canonical site catalog: name -> where it fires (docs/resilience.md
# carries the operator-facing version). Arming an unknown site is an
# error — a typo must not silently inject nothing.
SITES: dict[str, str] = {
    "kube.request": "client/kube.py _request + every FakeKubeClient verb",
    "kube.watch": "client/kube.py _watch + FakeKubeClient watch streams",
    "scheduler.filter_commit": "filter.py _commit, after the annotation "
                               "patch, before the assumed-cache insert",
    "scheduler.bind_patch": "bind.py, between the allocating/intent patch "
                            "and the Binding POST (the bind crash window)",
    "bind.batch": "scheduler/bindpipe.py, after each pod's intent patch "
                  "lands within a wave and before the wave's single lease "
                  "confirm (crash = a TORN WAVE: some pods of the batch "
                  "carry intents, none carry Bindings — the PR 4 reapers "
                  "must converge every one of them; error = the pod "
                  "degrades to the serial bind path, never the wave)",
    "snapshot.apply": "snapshot.py apply_event, before decode/apply",
    "plugin.allocate": "vnum.py _allocate_container, inside the Allocate "
                       "try block",
    "plugin.config_write": "vnum.py, after vtpu.config is written",
    "plugin.record_devices": "vnum.py _record_devices, after devices.json "
                             "is written",
    "registry.register": "registry/server.py handle_request, after "
                         "attestation, before the registration write",
    "trace.spool_flush": "trace/recorder.py flush, before spool I/O",
    "flock.acquire": "util/flock.py FileLock.acquire entry",
    "controller.evict": "controller/reschedule.py _evict entry",
    "lease.acquire": "scheduler/lease.py try_acquire, before the lease "
                     "GET/create/CAS sequence",
    "lease.renew": "scheduler/lease.py renew, before the CAS update (the "
                   "bind-time confirm() rides this site too)",
    "shard.handoff": "scheduler/shard.py takeover replay entry, after a "
                     "lease acquisition and before the shard accepts work",
    "dra.prepare": "kubeletplugin/device_state.py prepare_claim, after "
                   "the idempotency check, before any disk write",
    "dra.cdi_write": "kubeletplugin/device_state.py, after the CDI spec "
                     "lands on disk and before the checkpoint write "
                     "(partial-write tears the spec the runtime reads)",
    "cache.write": "compilecache/cache.py put, after the temp entry is "
                   "written and before the atomic rename (partial-write "
                   "= a torn executable that must be quarantined, never "
                   "loaded)",
    "cache.lease": "compilecache/cache.py, after the single-flight lease "
                   "is acquired and before the compile runs (crash = a "
                   "dead lease holder waiters must take over within the "
                   "stale-lease budget)",
    "cache.fetch": "clustercache/fetch.py _fetch_remote, after the peer "
                   "payload is staged to a temp file and before the "
                   "read-back verify (error = peer/transport failure the "
                   "ladder must absorb by compiling; latency = a slow "
                   "peer the timeout budget must bound; partial-write = "
                   "a torn payload mid-download that must fail "
                   "verification and never land as a servable entry)",
    "cache.advertise": "clustercache/advertise.py publish_once, after "
                       "the advertisement is encoded and before the "
                       "node-annotation patch (error = a failed publish "
                       "the annotation's own timestamp ages out — "
                       "peers decay to no-signal, never fetch from a "
                       "ghost)",
    "util.fold": "utilization/ledger.py fold entry (the scrape-time "
                 "ledger fold; error = a torn fold the collector must "
                 "flag without blocking /metrics, headroom decays to "
                 "no-signal instead of serving stale claims)",
    "util.rollup": "utilization/rollup.py ClusterRollup.collect entry "
                   "(the monitor's /utilization fan-in; error/latency "
                   "must never reach the /metrics path)",
    "explain.record": "explain/record.py ExplainRecorder.flush, before "
                      "spool I/O (error = spool unavailable, records "
                      "become counted drops; partial-write = a torn "
                      "spool line the doctor must skip). Fires on the "
                      "background flusher only — a wedged explain "
                      "plane must never block a filter pass",
    "explain.rollup": "explain/doctor.py collect entry (the /explain "
                      "fan-in on scheduler and monitor; error/latency "
                      "must hit only that route, never /metrics or a "
                      "scheduling pass)",
    "quota.lease": "quota/market.py grant path, after the ledger "
                   "records the lease and before any config rewrite "
                   "(crash = manager dies holding a grant no shim "
                   "enforces yet — TTL + the restart rule converge it; "
                   "partial-write = a torn lease ledger that must "
                   "recover as empty and reconcile every config to "
                   "base rates)",
    "quota.revoke": "quota/market.py revoke path, after the ledger "
                    "settles and before the reconcile pass rewrites "
                    "configs (crash = plugin restart mid-revoke: the "
                    "start() rule revokes carried leases and restores "
                    "base truth before new market activity)",
    "spill.copy": "overcommit/spill.py SpillPool.spill, after the tmp "
                  "pool file is written and before fsync+rename "
                  "(partial-write = a torn spill mid-copy: only a .tmp "
                  "orphan exists, the pool namespace and the vmem "
                  "ledger are untouched, the reaper deletes it)",
    "spill.budget": "overcommit/spill.py SpillPool.spill, at the "
                    "pre-write budget guard (error = budget exhausted: "
                    "the caller's allocation fails exactly as it would "
                    "have pre-vtovc — the spill arm only ever converts "
                    "failures into successes)",
    "ici.publish": "topology/linkload.py LinkLoadPublisher."
                   "publish_once, after the rollup is encoded and "
                   "before the node-annotation patch (error = a failed "
                   "publish the annotation's own timestamp ages out — "
                   "the scheduler's link_term decays to no-signal, "
                   "never steers on a ghost's contention claim)",
    "autopilot.act": "autopilot/controller.py _act, after every guard "
                     "passed and before the remediation dispatches "
                     "(error = a failed action that must start the "
                     "cooldown like a success — retry storms are the "
                     "flap the guards exist to prevent; crash = leader "
                     "death mid-decision the successor's election "
                     "absorbs)",
    "migrate.freeze": "autopilot/migrate.py migrate, after the intent "
                      "trail lands and before the tenant's configs "
                      "freeze (crash = a dead migrator whose intent "
                      "the token-aware reaper must unfreeze and clear; "
                      "error = a failed freeze that rolls back in "
                      "place)",
    "migrate.refill": "autopilot/migrate.py migrate, after the rebind "
                      "lands and before the unfreeze rewrites (crash = "
                      "the worst window — tenant frozen, pod already "
                      "rebound — the reaper must unfreeze on BOTH "
                      "source and target so the gang never stays "
                      "parked; the shim's VTPU_FREEZE_MAX_S fail-open "
                      "is the last-resort backstop)",
    "health.probe": "manager/device_manager.py HealthWatcher."
                    "check_once per chip AND health/publisher.py "
                    "_probe_chips (error/latency = a probe pass that "
                    "fails or drags — fail-open, no flip, only the "
                    "exec-failure counter; crash = watcher death "
                    "mid-pass the next interval absorbs)",
    "health.flip": "health/publisher.py publish_once, per ladder state "
                   "transition and before the annotation patch (crash "
                   "= the LAST published state stands until the "
                   "stalecodec timestamp ages the cordon out — a torn "
                   "flip can never publish; error = a lost publish "
                   "tick the next interval replays)",
    "health.rescue": "autopilot/actions.py rescue_gang, after the "
                     "guards passed and before the migration "
                     "dispatches (crash = leader death mid-rescue: "
                     "the intent trail + PR 17 reapers unfreeze the "
                     "gang and the successor's next eligible window "
                     "retries; error = a failed rescue that starts "
                     "the cooldown like a success)",
    "frag.publish": "fragmentation/publisher.py FragPublisher."
                    "publish_once, after the rollup is encoded and "
                    "before the node-annotation patch (error = a "
                    "failed publish the annotation's own timestamp "
                    "ages out — the fleet rollup drops the node to "
                    "no-signal, never capacity-plans on a ghost's "
                    "placeability claim)",
    "frag.rollup": "fragmentation/forecast.py what_if entry (the "
                   "monitor's /fragmentation what-if doctor; "
                   "error/latency must 503 only that route, never "
                   "/metrics or a scheduling pass)",
}

ACTIONS = ("error", "latency", "crash", "partial-write")


class CrashFailpoint(BaseException):
    """Simulated process death at a failpoint. BaseException on purpose:
    recovery code that catches ``Exception`` must not be able to survive
    a crash the way it could never survive a real one."""

    def __init__(self, site: str):
        super().__init__(f"crash failpoint fired at {site}")
        self.site = site


@dataclass
class _Spec:
    action: str
    p: float = 1.0
    count: int | None = None          # remaining fires; None = unlimited
    status: int = 503                 # for error action on kube sites
    latency_s: float = 0.001
    retry_after: float | None = None  # Retry-After carried by the KubeError
    exc: type | None = None           # overrides the KubeError default
    match: dict = field(default_factory=dict)   # ctx subset that must match


class _Stats:
    __slots__ = ("fires", "evaluations")

    def __init__(self) -> None:
        self.fires: dict[str, int] = {}
        self.evaluations = 0

    def total(self) -> int:
        return sum(self.fires.values())


# _ARMED is the whole fast-path contract: empty unless enable()+arm()
# ran, and fire()'s disabled path is exactly one .get() on it.
_ARMED: dict[str, _Spec] = {}
_lock = threading.Lock()
_rng = Random(0)
_enabled = False
_stats = _Stats()


def is_enabled() -> bool:
    return _enabled


def enable(seed: int = 0) -> None:
    """Turn the registry on (FaultInjection gate). Resets stats and the
    deterministic RNG; sites still need arm()."""
    global _enabled, _rng, _stats
    with _lock:
        _enabled = True
        _rng = Random(seed)
        _stats = _Stats()
        _ARMED.clear()


def disable() -> None:
    """Back to the fully cold path: clears every armed site and the
    stats (a disabled registry reports zero, matching its cost)."""
    global _enabled, _stats
    with _lock:
        _enabled = False
        _ARMED.clear()
        _stats = _Stats()


def arm(site: str, action: str, p: float = 1.0, count: int | None = None,
        status: int = 503, latency_s: float = 0.001,
        retry_after: float | None = None,
        exc: type | None = None, match: dict | None = None) -> None:
    if site not in SITES:
        raise KeyError(f"unknown failpoint site {site!r} "
                       f"(known: {sorted(SITES)})")
    if action not in ACTIONS:
        raise ValueError(f"unknown failpoint action {action!r}")
    if retry_after is not None and action != "error":
        raise ValueError("retry_after only applies to the error action")
    if not _enabled:
        raise RuntimeError("failpoints disabled: enable() (FaultInjection "
                           "gate) before arm()")
    with _lock:
        _ARMED[site] = _Spec(action=action, p=p, count=count, status=status,
                             latency_s=latency_s, retry_after=retry_after,
                             exc=exc, match=dict(match or {}))


def disarm(site: str) -> None:
    with _lock:
        _ARMED.pop(site, None)


def armed_sites() -> list[str]:
    return sorted(_ARMED)


def stats() -> dict:
    with _lock:
        return {"fires": dict(_stats.fires), "total": _stats.total(),
                "evaluations": _stats.evaluations}


def fire(site: str, **ctx) -> None:
    """The injection point. Disabled/unarmed cost: this one dict lookup."""
    spec = _ARMED.get(site)
    if spec is None:
        return
    _fire_armed(site, spec, ctx)


def _fire_armed(site: str, spec: _Spec, ctx: dict) -> None:
    with _lock:
        _stats.evaluations += 1
        if spec.match:
            for key, want in spec.match.items():
                if ctx.get(key) != want:
                    return
        if spec.count is not None and spec.count <= 0:
            return
        if spec.p < 1.0 and _rng.random() >= spec.p:
            return
        if spec.count is not None:
            spec.count -= 1
        _stats.fires[site] = _stats.fires.get(site, 0) + 1
        frac = 0.1 + 0.8 * _rng.random()     # partial-write cut point
    log.info("failpoint %s fired: %s %s", site, spec.action,
             {k: v for k, v in ctx.items() if k != "data"})
    _record_span(site, spec.action, ctx)
    if spec.action == "latency":
        time.sleep(spec.latency_s)
        return
    if spec.action == "error":
        raise _make_error(site, spec)
    if spec.action == "partial-write":
        _truncate(ctx.get("path"), frac)
        raise CrashFailpoint(site)
    raise CrashFailpoint(site)


def _make_error(site: str, spec: _Spec) -> Exception:
    if spec.exc is not None:
        return spec.exc(f"failpoint {site} injected error")
    # KubeError is the lingua franca of the sites this ships for; import
    # here to keep the module import-light (flock.py imports us).
    # retry_after rides the error like a real Retry-After header would,
    # so injected 429/503s exercise the RetryPolicy floor branch.
    from vtpu_manager_torch.client.kube import KubeError
    return KubeError(spec.status, f"failpoint {site} injected error",
                     retry_after=spec.retry_after)


def _truncate(path, frac: float) -> None:
    if not path:
        return
    try:
        import os
        size = os.path.getsize(path)
        with open(path, "r+b") as f:
            f.truncate(max(1, int(size * frac)))
    except OSError:
        log.warning("partial-write failpoint could not truncate %r", path)


def _record_span(site: str, action: str, ctx: dict) -> None:
    """Injections land in the pod's vtrace timeline so a chaos run (or a
    staging soak with the gate on) shows WHERE the fault hit. Lazy import:
    trace -> recorder -> flock -> this module would otherwise cycle."""
    uid = ctx.get("pod_uid") or ""
    if not uid:
        return
    try:
        from vtpu_manager_torch import trace
        trace.event(trace.context_for_uid(uid), f"failpoint.{site}",
                    action=action)
    except Exception:  # noqa: BLE001 — observability must never add faults
        log.debug("failpoint span emit failed", exc_info=True)


# -- env spec (binaries: FaultInjection gate + VTPU_FAILPOINTS) -------------

def arm_spec(spec: str) -> None:
    """Parse ``site=action(arg,k=v,...);site2=...`` and arm each entry.
    Grammar mirrors gofail's: the one positional arg is the status for
    ``error`` and the seconds for ``latency``; ``p=``/``count=`` bound
    the injection, and ``retry_after=<seconds>`` makes an injected
    KubeError carry the apiserver pacing hint (the RetryPolicy floor
    branch real 429s exercise). Example::

        VTPU_FAILPOINTS='kube.request=error(429,retry_after=2,p=0.01);flock.acquire=latency(0.05)'
    """
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(f"bad failpoint spec {part!r}")
        site, _, rhs = part.partition("=")
        site = site.strip()
        action, _, argstr = rhs.partition("(")
        action = action.strip()
        kwargs: dict = {}
        argstr = argstr.rstrip(")").strip()
        if argstr:
            for raw in argstr.split(","):
                raw = raw.strip()
                if not raw:
                    continue
                if "=" in raw:
                    key, _, val = raw.partition("=")
                    key = key.strip()
                    if key == "p":
                        kwargs["p"] = float(val)
                    elif key == "count":
                        kwargs["count"] = int(val)
                    elif key == "retry_after":
                        kwargs["retry_after"] = float(val)
                    else:
                        raise ValueError(
                            f"unknown failpoint option {key!r} in {part!r}")
                elif action == "error":
                    kwargs["status"] = int(raw)
                elif action == "latency":
                    kwargs["latency_s"] = float(raw)
                else:
                    raise ValueError(
                        f"positional arg {raw!r} invalid for {action!r}")
        arm(site, action, **kwargs)


def render_failpoint_metrics() -> str:
    """Prometheus lines for /metrics (scheduler routes + monitor)."""
    lines = ["# TYPE vtpu_failpoint_fires_total counter"]
    snap = stats()
    for site, count in sorted(snap["fires"].items()):
        lines.append(f'vtpu_failpoint_fires_total{{site="{site}"}} {count}')
    lines.append(f"# TYPE vtpu_failpoint_evaluations_total counter\n"
                 f"vtpu_failpoint_evaluations_total {snap['evaluations']}")
    return "\n".join(lines)


def arm_from_env(environ=None) -> None:
    """What a command does under the FaultInjection gate (the JAX
    commands' `enable(VTPU_FAILPOINTS_SEED)` then
    `arm_spec(VTPU_FAILPOINTS)`). A malformed spec raises ValueError
    naming it; the command exits on it rather than run unarmed."""
    import os
    env = os.environ if environ is None else environ
    spec = env.get("VTPU_FAILPOINTS", "")
    try:
        enable(seed=int(env.get("VTPU_FAILPOINTS_SEED", "0") or 0))
        arm_spec(spec)
    except (KeyError, ValueError) as e:
        disable()
        raise ValueError(f"VTPU_FAILPOINTS={spec!r}: {e}") from e
