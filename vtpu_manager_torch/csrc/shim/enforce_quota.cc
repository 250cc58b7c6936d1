// enforce_quota.cc — the quota market's rewrites of the tenant's config.
//
// Ports library/src/enforce.cc ArmQuotaReloader:1308, AdoptQuotaLocked:1317,
// MaybeAdoptQuota:1386 and FreezePark:2464, with the reloader of
// vtpu_quota_abi.h (library/include/vtpu_quota.h).
//
// Lease. The node's quota market lends a card's idle compute by rewriting
// the tenant's vtpu.config with a signed lease_core per device and a bumped
// quota_epoch (vtpu_manager/quota/market.py _reconcile). The interposer
// re-reads the file at most once per quantum (2 ms, the reference's
// throttle quantum) across threads: from the quota tick, a thread of its
// own that every tenant, metered or not, starts at its first launch once
// the reloader is armed (the reference's controller tick, enforce.cc:1670);
// from each sleep of the bucket's wait loop; and from a parked launch,
// which both still re-read if the tick cannot start. So every tenant adopts a
// lease, a revoke or a freeze within one quantum and one re-read, however
// rarely it launches. The reference re-reads on its executions' path
// (enforce.cc:2519); a launch here only reads the words the re-read
// stores, so a launch never pays the stat. Devices are matched by host
// index and UUID, never by position. Only 4-byte ints are stored, whole
// (SetWord), while other threads read them. A revoke clamps the bucket's
// tokens to one window's grant at the new rate, so borrowed credit does
// not outlive the lease (enforce_rate.cc QuotaMoved).
//
// Freeze. A migration rewrites migration_freeze 1 (and bumps both epochs);
// every new launch of every tenant, metered or not, parks until a rewrite
// clears it. Launches already on the card run on: that is the drain the
// migration waits for. A launch into a capturing stream does not park: it
// runs nothing until its graph is replayed, and the replay parks. The park
// re-reads the file each quantum, fails open after VTPU_FREEZE_MAX_S
// (default 120 s) so a lost unfreeze cannot hold a tenant forever, and its
// wait, the whole park from its start to its release, re-reads included,
// goes to vtpu_freeze_wait_ns_total, never to the throttle wait. A
// freeze that failed open parks no later launch: the reference parks each
// launch again for the whole limit, so a step of many launches would wait
// as many limits; a new freeze (a bumped freeze_epoch) parks again.

#include <pthread.h>
#include <stdlib.h>
#include <string.h>
#include <time.h>

#include <mutex>

#include "shim.h"
#include "vtpu_quota_abi.h"

namespace vtpu_cuda {

using namespace vtpu_abi;

namespace {

constexpr uint64_t kQuantumNs = 2'000'000;  // enforce.cc kTickSleepUs
constexpr int64_t kFreezeMaxS = 120;

QuotaReloader* g_quota = nullptr;
std::mutex g_quota_mu;
std::atomic<uint64_t> g_quota_last_check_ns{0};
std::atomic<bool> g_quota_tick_started{false};
std::atomic<uint64_t> g_quota_reloads{0};
std::atomic<uint64_t> g_freeze_wait_ns{0};
// the freeze epoch that failed open, with bit 32 set (0: none)
std::atomic<uint64_t> g_failed_open{0};
constexpr uint64_t kFailedOpen = 1ull << 32;

// The policy's percent under a lease (enforce.cc:1403 EffectiveLimit),
// before balance mode moves the base.
int EffectivePct(const DeviceLimits& d) {
  return Word(d.core_limit) == kCoreLimitNone
             ? 0
             : EffectiveCorePct(Word(d.hard_core), Word(d.lease_core));
}

void AdoptQuotaLocked(const VtpuConfig& fresh) {
  Config& c = MutableCfg();
  for (int i = 0; i < c.device_count && i < kMaxDevices; i++) {
    DeviceLimits& dev = c.dev[i];
    const VtpuDevice* nd = nullptr;
    for (int j = 0; j < fresh.device_count && j < kMaxDeviceCount; j++) {
      if (fresh.devices[j].host_index == dev.host_index &&
          strncmp(fresh.devices[j].uuid, dev.uuid, kUuidLen) == 0) {
        nd = &fresh.devices[j];
        break;
      }
    }
    if (!nd) continue;
    int old_pct = EffectivePct(dev);
    bool policy_moved = nd->hard_core != Word(dev.hard_core) ||
                        nd->soft_core != Word(dev.soft_core) ||
                        nd->core_limit != Word(dev.core_limit);
    SetWord(&dev.hard_core, nd->hard_core);
    SetWord(&dev.soft_core, nd->soft_core);
    SetWord(&dev.core_limit, nd->core_limit);
    SetWord(&dev.lease_core, nd->lease_core);
    int new_pct = EffectivePct(dev);
    QuotaMoved(i, old_pct, new_pct, policy_moved);
    if (new_pct < old_pct)
      Log(kLogInfo, "quota lease revoked on device %d: eff %d%% -> %d%%",
          dev.host_index, old_pct, new_pct);
    else if (new_pct > old_pct)
      Log(kLogInfo, "quota lease granted on device %d: eff %d%% -> %d%%",
          dev.host_index, old_pct, new_pct);
  }
  SetWord(&c.workload_class, fresh.workload_class);
  __atomic_store_n(&c.quota_epoch, fresh.quota_epoch, __ATOMIC_RELAXED);
  if (fresh.migration_freeze != Word(c.migration_freeze))
    Log(kLogInfo, "migration freeze %s (epoch %u -> %u)",
        fresh.migration_freeze ? "engaged" : "released",
        __atomic_load_n(&c.freeze_epoch, __ATOMIC_RELAXED),
        fresh.freeze_epoch);
  __atomic_store_n(&c.freeze_epoch, fresh.freeze_epoch, __ATOMIC_RELAXED);
  SetWord(&c.migration_freeze, fresh.migration_freeze);
}

}  // namespace

void ArmQuotaReloader(const char* path, uint32_t epoch) {
  if (g_quota) return;
  auto* q = new QuotaReloader(path);
  q->Prime(epoch);
  g_quota = q;
}

void MaybeAdoptQuota() {
  if (!g_quota) return;
  uint64_t now = NowNs();
  uint64_t last = g_quota_last_check_ns.load(std::memory_order_relaxed);
  if (now - last < kQuantumNs) return;
  if (!g_quota_last_check_ns.compare_exchange_strong(
          last, now, std::memory_order_relaxed))
    return;  // another thread has this quantum's check
  VtpuConfig fresh;
  std::lock_guard<std::mutex> lock(g_quota_mu);
  if (g_quota->Check(&fresh)) {
    AdoptQuotaLocked(fresh);
    g_quota_reloads.fetch_add(1, std::memory_order_relaxed);
  }
}

namespace {

void* QuotaTickMain(void*) {
  for (;;) {
    struct timespec ts = {0, (long)kQuantumNs};
    nanosleep(&ts, nullptr);
    MaybeAdoptQuota();
  }
  return nullptr;
}

void StartQuotaTickOnce() {
  if (g_quota_tick_started.load(std::memory_order_relaxed) ||
      g_quota_tick_started.exchange(true))
    return;
  static std::once_flag atfork_once;
  // A forked child has no tick thread, and must not inherit the reloader's
  // lock held by it: the child's first launch starts its own.
  std::call_once(atfork_once, [] {
    pthread_atfork([] { g_quota_mu.lock(); }, [] { g_quota_mu.unlock(); },
                   [] {
                     g_quota_mu.unlock();
                     g_quota_tick_started.store(false);
                   });
  });
  pthread_t tid;
  if (pthread_create(&tid, nullptr, QuotaTickMain, nullptr) == 0) {
    pthread_detach(tid);
  } else {
    Log(kLogWarn, "quota tick thread did not start; the config is re-read "
                  "only by a waiting or parked launch");
  }
}

}  // namespace

void FreezePark(CUstream stream) {
  const Config& c = Cfg();
  if (!g_quota) return;
  StartQuotaTickOnce();
  if (Word(c.migration_freeze) == 0) return;
  uint32_t epoch = __atomic_load_n(&c.freeze_epoch, __ATOMIC_RELAXED);
  if (g_failed_open.load(std::memory_order_relaxed) == (kFailedOpen | epoch) ||
      Capturing(stream))
    return;
  int64_t max_s = kFreezeMaxS;
  const char* env = getenv("VTPU_FREEZE_MAX_S");
  if (env && *env && atoll(env) > 0) max_s = atoll(env);
  uint64_t start = NowNs();
  Log(kLogInfo, "launches parked: migration freeze epoch %u", epoch);
  while (Word(c.migration_freeze) != 0) {
    if (NowNs() - start > (uint64_t)max_s * 1'000'000'000ull) {
      Log(kLogError,
          "migration freeze epoch %u held > %lld s; failing open "
          "(controller dead or unfreeze rewrite lost)",
          epoch, (long long)max_s);
      g_failed_open.store(kFailedOpen | epoch, std::memory_order_relaxed);
      break;
    }
    struct timespec ts = {0, (long)kQuantumNs};
    nanosleep(&ts, nullptr);
    MaybeAdoptQuota();
  }
  uint64_t parked = NowNs() - start;
  g_freeze_wait_ns.fetch_add(parked, std::memory_order_relaxed);
  if (Word(c.migration_freeze) == 0)
    Log(kLogInfo, "launches released: freeze epoch %u cleared after %llu ms",
        epoch, (unsigned long long)(parked / 1'000'000));
}

}  // namespace vtpu_cuda

using namespace vtpu_cuda;

// Generations of the config adopted since the start, and the time
// launches spent parked under a migration freeze.
VTPU_EXPORT uint64_t vtpu_quota_reloads_total() {
  return g_quota_reloads.load(std::memory_order_relaxed);
}

VTPU_EXPORT uint64_t vtpu_freeze_wait_ns_total() {
  return g_freeze_wait_ns.load(std::memory_order_relaxed);
}

// The quota_epoch of the generation in force.
VTPU_EXPORT uint64_t vtpu_quota_epoch() {
  return __atomic_load_n(&Cfg().quota_epoch, __ATOMIC_RELAXED);
}
