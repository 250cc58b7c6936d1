// enforce_rate.cc — the compute-% cap on kernel launches.
//
// Ports library/src/enforce.cc RateLimit:2503, ExecCost:2820, BumpActivity:603,
// EffectiveLimit:1403, MeasuredUtil:1422, ControllerState:1503,
// DeltaStep:1519, AimdStep:1526, WatcherTick:1540, the observation probe
// (ProbeOnce:1849) and the isolated-span discount of OnExecuteDone:2777-2812.
// The bucket is denominated in device-busy nanoseconds: each launch pays
// its kernel's cost up front, and a launch that finds the bucket in debt
// waits until the refill, at the tenant's rate, has paid the debt.
//
// Cost. A TPU program is one executable with a measured duration; a GPU
// step is many kernels. Each CUfunction keeps an exponential moving average
// of its duration (alpha 0.3, as enforce.cc:66). A sample of launches is
// bracketed by two cuEventRecord calls on the launch's stream, and the pair
// is read back later with a non-blocking cuEventQuery, in the launching
// thread, so a launch never waits on the device. A measured sample also
// settles what its launch was charged: the bucket pays back or takes the
// difference.
//
// Isolated samples. A sample whose start event is recorded on an idle
// stream (cuStreamQuery) also times the launch's way to the card: the
// event is stamped at once, the kernel starts later. A throttled tenant's
// launches nearly all land on an idle stream, so without a correction it is
// over-charged and settles below its quota. An idle-time probe measures
// that overhead (two events around a 4-byte cuMemsetD32Async issued through
// the real driver on an idle stream, never charged), min-filtered as the
// reference filters it; an isolated sample is discounted by the estimate,
// capped at half its span (vtpu_obs_overhead_ns). An operator's
// calibration, VTPU_OBS_OVERHEAD_US (enforce.cc:111), replaces the probe;
// 0 turns the discount off.
//
// Refill and the tick. A watcher thread refills every 10 ms window (the
// GPU's kernels are micro- to milliseconds long, where the TPU's 100 ms
// window suits whole programs); a thread waiting on debt also refills for
// the time it has waited. Each tick also reads the node watcher's feed
// (fresh within 5 s; co-tenants from its processes, else from the memory
// ledger) and moves balance mode: a soft tenant climbs +2 per tick from
// hard_core toward soft_core while alone and is pinned to hard_core when a
// co-tenant appears. Every 10 ticks (the reference's 100 ms window) the
// tick judges blindness: a tenant whose own samples account for far less
// than the feed attributes to it (events that complete at submission) is
// charged a per-launch cost learned from the feed instead, reconciled
// against the feed, and its rate is steered by the delta/AIMD controllers.
// NVML averages its utilization over a sample period of up to 1 s, so for
// 1 s after the tenant starts launching (or resumes after an idle gap) and
// after the set of co-tenants in the feed changes, the feed still holds
// the time before: those horizons are not judged (a tenant already judged
// blind stays so). On the card every horizon the test found suspect fell
// in that window: costs still at their default, first spans that hold a
// module's lazy load, NVML's average over a start-up burst.
//
// Each metered launch also bumps this process's activity counter in the
// memory ledger, a relaxed atomic add on the cached entry; the node watcher
// shares the card's utilization by those counters.
//
// Bypass and fail-open. The first launch after more than 200 ms of idle
// goes at once and its cost becomes debt (enforce.cc:2541); a launch that
// has waited 10 s goes unthrottled (enforce.cc:2561-2571).

#include <pthread.h>
#include <time.h>
#include <unistd.h>

#include <algorithm>
#include <cstdlib>
#include <mutex>
#include <unordered_map>
#include <vector>

#include "shim.h"

namespace vtpu_cuda {

using namespace vtpu_abi;

namespace {

constexpr int64_t kWindowNs = 10'000'000;
constexpr int kHorizonTicks = 10;          // blindness and controllers
constexpr uint64_t kGapThresholdNs = 200'000'000;
constexpr uint64_t kFailOpenNs = 10'000'000'000;
constexpr uint64_t kFeedFreshNs = 5'000'000'000;
constexpr uint64_t kFeedLagNs = 1'000'000'000;   // NVML's longest period
constexpr int64_t kDefaultCostNs = 50'000;  // before the first sample
constexpr double kCostEmaAlpha = 0.3;
constexpr int64_t kMinSleepNs = 20'000;
constexpr int64_t kMaxSleepNs = 2'000'000;
constexpr uint64_t kAlwaysSampleFirst = 16;
constexpr uint64_t kSampleEvery = 4;
constexpr size_t kMaxPending = 256;
constexpr int kProbeConverged = 6;
constexpr uint64_t kProbeFastNs = 20'000'000;
constexpr uint64_t kProbeSlowNs = 1'000'000'000;

// Controller tunables, the reference's defaults (enforce.cc:69-74). The
// controller is the reference's "auto": delta while the card has been the
// tenant's alone for 20 horizons, AIMD otherwise.
constexpr double kAimdAi = 0.03;
constexpr double kAimdMd = 1.5;
constexpr int kAimdDeadband = 3;
constexpr int kAimdCooldownTicks = 3;
constexpr double kDeltaGain = 0.5;

struct DeviceBucket {
  std::atomic<int64_t> tokens_ns{0};
  std::atomic<uint64_t> last_refill_ns{0};
  std::atomic<uint64_t> last_submit_ns{0};
  // refill rate in thousandths of a percent; 0 = the policy's limit
  std::atomic<int64_t> rate_mpct{0};
  std::atomic<int> up_limit{0};  // balance mode's limit (0 = hard_core)
  // what the tenant's own samples account for, per tick and per horizon
  std::atomic<int64_t> self_tick_ns{0};
  std::atomic<int64_t> self_horizon_ns{0};
  std::atomic<int64_t> precharged_ns{0};  // launch charges this horizon
  // what the samples settled this horizon measured, and how many: the
  // tenant's observation of its device time, apart from its charges
  std::atomic<int64_t> observed_ns{0};
  std::atomic<int64_t> observed_n{0};
  std::atomic<int64_t> launches{0};       // metered launches this horizon
  // start of the current stretch of activity, or of co-tenancy as the
  // feed shows it
  std::atomic<uint64_t> active_since_ns{0};
  std::atomic<bool> blind{false};
  std::atomic<int64_t> blind_cost_ns{0};
  std::atomic<uint64_t> vmem_retry_ns{0};
  std::atomic<int64_t> obs_overhead_ns{0};
  std::atomic<int> obs_samples{0};
  std::atomic<uint64_t> last_probe_ns{0};
};

// The tick's own state per slot (watcher thread only).
struct ControllerState {
  double rate_frac = 0.0;   // granted fraction of wall time
  double util_ema = -1.0;   // smoothed feed utilization
  double self_util_ema = 0.0;
  int cooldown = 0;
  int exclusive_ticks = 0;
  int blind_ticks = 0;
  int ticks = 0;            // into the current horizon
  int64_t horizon_ns = 0;
  int64_t attributed_ns = 0;
  int64_t used_sum = 0;
  bool external = false;
  bool others = false;
  int feed_others = -1;     // co-tenant processes in the feed, last tick
};

DeviceBucket g_bucket[kMaxDevices];
ControllerState g_ctl[kMaxDevices];
std::atomic<uint64_t> g_launches{0};
std::atomic<uint64_t> g_sampled{0};
std::atomic<uint64_t> g_probes{0};
std::atomic<uint64_t> g_gap_bypass{0};
std::atomic<uint64_t> g_fail_open{0};
std::atomic<uint64_t> g_throttle_wait_ns{0};
std::atomic<int64_t> g_charged_ns{0};  // launch charges plus settlements
std::atomic<uint64_t> g_watcher_external{0};
std::atomic<uint64_t> g_watcher_fallback{0};
std::atomic<uint64_t> g_blind_ticks{0};
std::atomic<bool> g_watcher_started{false};

struct FnCost {
  int64_t ema_ns = 0;
  uint64_t launches = 0;
  bool inflight = false;
};

// A sampled launch, or an observation probe (fn == nullptr).
struct Sample {
  CUfunction fn = nullptr;
  CUevent start = nullptr;
  CUevent end = nullptr;
  int slot = 0;
  int64_t charged_ns = 0;
  bool isolated = false;
};

std::mutex g_cost_mu;
std::unordered_map<CUfunction, FnCost> g_costs;
std::vector<Sample> g_pending;
std::vector<CUevent> g_event_pool;
void* g_probe_word[kMaxDevices] = {};
bool g_probe_off[kMaxDevices] = {};

// The operator's overhead in ns, or -1 when the probe measures it.
int64_t ObsOverrideNs() {
  static const int64_t ns = [] {
    const char* v = getenv("VTPU_OBS_OVERHEAD_US");
    return v && *v ? std::max<int64_t>(0, atoll(v)) * 1000 : int64_t{-1};
  }();
  return ns;
}

int64_t ObsOverheadNs(int slot) {
  int64_t ns = ObsOverrideNs();
  return ns >= 0 ? ns
                 : g_bucket[slot].obs_overhead_ns.load(std::memory_order_relaxed);
}

bool IsMetered(const DeviceLimits* d) {
  if (!d) return false;
  if (d->core_limit == kCoreLimitHard)
    return d->hard_core > 0 && d->hard_core < 100;
  return d->core_limit == kCoreLimitSoft && d->hard_core > 0;
}

// The policy's percent: hard_core, or balance mode's current limit.
int LimitPct(int slot) {
  const DeviceLimits* d = Dev(slot);
  if (!IsMetered(d)) return 0;
  int pct = d->hard_core;
  if (d->core_limit == kCoreLimitSoft) {
    int up = g_bucket[slot].up_limit.load(std::memory_order_relaxed);
    if (up > 0) pct = up;
  }
  return std::clamp(pct, 1, 100);
}

int64_t RateMpct(int slot) {
  int64_t r = g_bucket[slot].rate_mpct.load(std::memory_order_relaxed);
  return r > 0 ? r : (int64_t)LimitPct(slot) * 1000;
}

// Adds the rate's share of the wall time since the last refill, capped at
// one window's grant. The first refill seeds one window, so a new tenant
// does not start empty.
void Refill(int slot, uint64_t now) {
  int64_t rate = RateMpct(slot);
  if (rate <= 0) return;
  DeviceBucket& b = g_bucket[slot];
  uint64_t prev = b.last_refill_ns.load(std::memory_order_relaxed);
  if (now <= prev ||
      !b.last_refill_ns.compare_exchange_strong(prev, now,
                                                std::memory_order_relaxed))
    return;
  int64_t cap = kWindowNs * rate / 100'000;
  int64_t add = prev == 0 ? cap : (int64_t)(now - prev) * rate / 100'000;
  int64_t cur = b.tokens_ns.load(std::memory_order_relaxed);
  int64_t next;
  do {
    next = std::max(cur, std::min(cur + add, cap));
  } while (!b.tokens_ns.compare_exchange_weak(cur, next,
                                              std::memory_order_relaxed));
}

void Charge(int slot, int64_t ns) {
  DeviceBucket& b = g_bucket[slot];
  b.tokens_ns.fetch_sub(ns, std::memory_order_relaxed);
  b.self_tick_ns.fetch_add(ns, std::memory_order_relaxed);
  b.self_horizon_ns.fetch_add(ns, std::memory_order_relaxed);
  g_charged_ns.fetch_add(ns, std::memory_order_relaxed);
}

// The card's utilization for the slot: the node watcher's feed when fresh,
// else this tenant's own estimate (`self_ns` over the window). Also says
// whether a co-tenant is on the card and how much of the window the feed
// attributes to this tenant (enforce.cc:1422-1501).
int MeasuredUtil(int slot, int64_t window_ns, int64_t self_ns, bool* external,
                 bool* others, int64_t* attributed_ns, int* feed_others) {
  const DeviceLimits* d = Dev(slot);
  const TcUtilFile* feed = TcFeed();
  *external = false;
  *others = false;
  *attributed_ns = 0;
  *feed_others = -1;
  if (feed && d->host_index >= 0 && d->host_index < kMaxDeviceCount) {
    const TcDeviceRecord& rec = feed->records[d->host_index];
    uint64_t token = OwnerToken();
    int me = (int)getpid();
    for (int attempt = 0; attempt < 4; attempt++) {
      uint64_t seq1 = __atomic_load_n(&rec.seq, __ATOMIC_ACQUIRE);
      if (seq1 & 1) continue;
      int util = rec.device_util;
      uint64_t ts = rec.timestamp_ns;
      int nproc = std::clamp(rec.proc_count, 0, kMaxProcs);
      int other = 0;
      int self_share = -1, token_share = -1, token_hits = 0;
      for (int i = 0; i < nproc; i++) {
        const TcProcUtil& p = rec.procs[i];
        if (p.pid == 0) continue;
        if (p.owner_token != token) {
          other++;
          continue;
        }
        token_share = p.util;
        token_hits++;
        if (p.pid == me) self_share = p.util;
      }
      uint64_t seq2 = __atomic_load_n(&rec.seq, __ATOMIC_ACQUIRE);
      if (seq1 != seq2) continue;
      uint64_t now = NowNs();
      if (now < ts || now - ts > kFeedFreshNs) break;  // stale: fall back
      *external = true;
      *others = other > 0;
      *feed_others = other;
      // our share: the exact (pid, token) entry, else the only entry with
      // our token; with no residents at all, the whole card when the
      // ledger confirms we are alone
      if (self_share < 0 && token_hits == 1) self_share = token_share;
      if (self_share < 0 && nproc == 0 && ScanLedgerBytes(slot).others == 0)
        self_share = util;
      if (self_share > 0) *attributed_ns = self_share * window_ns / 100;
      g_watcher_external.fetch_add(1, std::memory_order_relaxed);
      return util;
    }
  }
  g_watcher_fallback.fetch_add(1, std::memory_order_relaxed);
  *others = ScanLedgerBytes(slot).others > 0;
  return window_ns > 0 ? (int)std::min<int64_t>(100, 100 * self_ns / window_ns)
                       : 0;
}

// delta: a proportional step toward the target (enforce.cc:1519).
double DeltaStep(double rate, int target, int used) {
  return rate + kDeltaGain * (double)(target - used) / 100.0;
}

// AIMD: additive increase below the band, multiplicative decrease with a
// cooldown above it (enforce.cc:1526).
double AimdStep(ControllerState* cs, double rate, int target, int used) {
  if (cs->cooldown > 0) {
    cs->cooldown--;
    return rate;
  }
  if (used > target + kAimdDeadband) {
    cs->cooldown = kAimdCooldownTicks;
    return rate / kAimdMd;
  }
  if (used < target - kAimdDeadband) return rate + kAimdAi;
  return rate;
}

// Every kHorizonTicks: is the tenant blind to its own device time, and if
// so, what does a launch cost and how fast may it refill (enforce.cc:
// 1562-1661, with the reference's 100 ms window).
void JudgeHorizon(int slot) {
  DeviceBucket& b = g_bucket[slot];
  ControllerState* cs = &g_ctl[slot];
  int64_t horizon = cs->horizon_ns;
  int64_t self_ns = b.self_horizon_ns.exchange(0, std::memory_order_relaxed);
  int64_t precharged = b.precharged_ns.exchange(0, std::memory_order_relaxed);
  int64_t launches = b.launches.exchange(0, std::memory_order_relaxed);
  int64_t attributed = cs->attributed_ns;
  uint64_t since = b.active_since_ns.load(std::memory_order_relaxed);
  bool judged = launches > 0 && NowNs() - since >= kFeedLagNs;
  // what the samples saw, scaled to every launch of the horizon (the
  // reference's observed busy time). Not self_ns: while blind, that holds
  // charges learned from the feed and would clear the flag by itself.
  int64_t obs_n = b.observed_n.exchange(0, std::memory_order_relaxed);
  int64_t obs_ns = b.observed_ns.exchange(0, std::memory_order_relaxed);
  int64_t seen = obs_n > 0 ? obs_ns * std::max(launches, obs_n) / obs_n : 0;
  // blind = self-observation far below reality: nothing observed despite
  // launches, or the feed attributing several times what we saw
  bool undercount = attributed > 4 * seen + horizon / 100;
  bool plausible = seen > 0 && 2 * seen >= precharged;
  if (!judged) {
    // the feed still averages the time before; no evidence either way
  } else if (seen <= 0 || undercount || !plausible) {
    Log(kLogInfo, "device %d horizon suspect:%s%s seen=%lld precharged=%lld "
        "attributed=%lld launches=%lld horizon=%lld used=%lld others=%d",
        slot, undercount ? " undercount" : "", plausible ? "" : " implausible",
        (long long)seen, (long long)precharged, (long long)attributed,
        (long long)launches, (long long)horizon,
        (long long)(cs->used_sum / std::max(cs->ticks, 1)), (int)cs->others);
    if (++cs->blind_ticks >= 2 && !b.blind.exchange(true))
      Log(kLogWarn, "device %d judged blind to its own device time", slot);
  } else if (plausible && !undercount) {
    cs->blind_ticks = 0;
    b.blind.store(false);
  }
  bool blind = b.blind.load();
  if (blind) g_blind_ticks.fetch_add(1, std::memory_order_relaxed);
  // blind cost learning: what the feed attributes, per launch
  if (blind && attributed > 0) {
    int64_t per = attributed / std::max<int64_t>(launches, 1);
    int64_t prev = b.blind_cost_ns.load(std::memory_order_relaxed);
    b.blind_cost_ns.store(prev == 0 ? per : (7 * prev + per) / 8,
                          std::memory_order_relaxed);
  } else if (!blind) {
    b.blind_cost_ns.store(0, std::memory_order_relaxed);
  }
  int target = LimitPct(slot);
  double base = target / 100.0;
  if (!cs->external || !blind) {
    cs->rate_frac = base;
    b.rate_mpct.store(0, std::memory_order_relaxed);
  } else {
    // closed loop on the feed's utilization, smoothed
    int used = (int)(cs->used_sum / std::max(cs->ticks, 1));
    if (cs->rate_frac <= 0) cs->rate_frac = base;
    if (cs->util_ema < 0) cs->util_ema = used;
    cs->util_ema = 0.8 * cs->util_ema + 0.2 * used;
    used = (int)(cs->util_ema + 0.5);
    cs->exclusive_ticks = cs->others ? 0 : std::min(cs->exclusive_ticks + 1,
                                                    50);
    cs->rate_frac = cs->exclusive_ticks < 20
                        ? AimdStep(cs, cs->rate_frac, target, used)
                        : DeltaStep(cs->rate_frac, target, used);
    cs->rate_frac = std::clamp(cs->rate_frac, 0.01, 2.0 * base + 0.05);
    b.rate_mpct.store((int64_t)(cs->rate_frac * 100'000),
                      std::memory_order_relaxed);
  }
  if (blind) {
    // the samples lie, so the feed's attribution settles the horizon
    int64_t correction = std::max(self_ns, attributed) - precharged;
    int64_t cur = b.tokens_ns.load(std::memory_order_relaxed);
    int64_t floor = -kHorizonTicks * 10 * kWindowNs;
    int64_t next = std::max(cur - correction, floor);
    b.tokens_ns.fetch_add(next - cur, std::memory_order_relaxed);
    g_charged_ns.fetch_add(cur - next, std::memory_order_relaxed);
  }
  cs->ticks = 0;
  cs->horizon_ns = 0;
  cs->attributed_ns = 0;
  cs->used_sum = 0;
  cs->external = false;
  cs->others = false;
}

void WatcherTick(uint64_t now, int64_t window_ns) {
  for (int slot = 0; slot < kMaxDevices; slot++) {
    const DeviceLimits* d = Dev(slot);
    if (!IsMetered(d)) continue;
    Refill(slot, now);
    DeviceBucket& b = g_bucket[slot];
    ControllerState* cs = &g_ctl[slot];
    int64_t self_ns = b.self_tick_ns.exchange(0, std::memory_order_relaxed);
    bool external, others;
    int64_t attributed;
    int feed_others;
    int used = MeasuredUtil(slot, window_ns, self_ns, &external, &others,
                            &attributed, &feed_others);
    if (feed_others >= 0 && cs->feed_others >= 0 &&
        feed_others != cs->feed_others)
      b.active_since_ns.store(now, std::memory_order_relaxed);
    if (feed_others >= 0) cs->feed_others = feed_others;
    cs->self_util_ema = 0.8 * cs->self_util_ema +
                        0.2 * (100.0 * self_ns / std::max<int64_t>(window_ns, 1));
    if (d->core_limit == kCoreLimitSoft) {
      // balance mode (enforce.cc:1552-1561); the feed's utilization is
      // averaged over NVML's period, much longer than a tick, so the climb
      // also reads the tenant's own smoothed use
      int up = b.up_limit.load(std::memory_order_relaxed);
      if (up == 0) up = d->hard_core;
      int seen = std::max(used, (int)cs->self_util_ema);
      if (others) {
        up = d->hard_core;
      } else if (seen >= up - 5 && up < d->soft_core) {
        up = std::min(up + 2, d->soft_core);
      }
      b.up_limit.store(up, std::memory_order_relaxed);
    }
    cs->horizon_ns += window_ns;
    cs->attributed_ns += attributed;
    cs->used_sum += used;
    cs->external |= external;
    cs->others |= others;
    if (++cs->ticks >= kHorizonTicks) JudgeHorizon(slot);
  }
}

void* WatcherMain(void*) {
  struct timespec next;
  clock_gettime(CLOCK_MONOTONIC, &next);
  uint64_t prev = NowNs();
  for (;;) {
    next.tv_nsec += kWindowNs;
    while (next.tv_nsec >= 1'000'000'000) {
      next.tv_nsec -= 1'000'000'000;
      next.tv_sec += 1;
    }
    clock_nanosleep(CLOCK_MONOTONIC, TIMER_ABSTIME, &next, nullptr);
    uint64_t now = NowNs();
    WatcherTick(now, (int64_t)(now - prev));
    prev = now;
  }
  return nullptr;
}

void StartWatcherOnce() {
  if (g_watcher_started.exchange(true)) return;
  static std::once_flag atfork_once;
  // A forked child has no watcher thread; let its first launch start one.
  std::call_once(atfork_once, [] {
    pthread_atfork(nullptr, nullptr, [] { g_watcher_started.store(false); });
  });
  pthread_t tid;
  if (pthread_create(&tid, nullptr, WatcherMain, nullptr) == 0) {
    pthread_detach(tid);
  } else {
    Log(kLogWarn, "watcher thread did not start; refill is lazy only");
  }
}

void RateLimit(int slot, int64_t cost_ns) {
  DeviceBucket& b = g_bucket[slot];
  uint64_t now = NowNs();
  uint64_t last = b.last_submit_ns.exchange(now, std::memory_order_relaxed);
  Refill(slot, now);
  Charge(slot, cost_ns);
  b.precharged_ns.fetch_add(cost_ns, std::memory_order_relaxed);
  b.launches.fetch_add(1, std::memory_order_relaxed);
  if (last == 0 || now - last > kGapThresholdNs) {
    g_gap_bypass.fetch_add(1, std::memory_order_relaxed);
    b.active_since_ns.store(now, std::memory_order_relaxed);
    return;
  }
  for (;;) {
    // Charge took the cost already: wait while the debt is more than it
    int64_t cur = b.tokens_ns.load(std::memory_order_relaxed) + cost_ns;
    if (cur >= 0) return;
    uint64_t waited = NowNs() - now;
    if (waited > kFailOpenNs) {
      Log(kLogError, "rate limiter stuck on device %d; failing open", slot);
      g_fail_open.fetch_add(1, std::memory_order_relaxed);
      return;
    }
    int64_t sleep_ns = std::clamp<int64_t>(-cur * 100'000 / RateMpct(slot),
                                           kMinSleepNs, kMaxSleepNs);
    struct timespec ts = {0, (long)sleep_ns};
    uint64_t t0 = NowNs();
    nanosleep(&ts, nullptr);
    uint64_t t1 = NowNs();
    g_throttle_wait_ns.fetch_add(t1 - t0, std::memory_order_relaxed);
    Refill(slot, t1);
  }
}

// One relaxed add on this process's cached ledger entry; the claim (under
// the ledger lock) happens once, and a missing or full ledger is retried
// only after a second.
void BumpActivity(int slot) {
  DeviceBucket& b = g_bucket[slot];
  uint64_t now = NowNs();
  if (now < b.vmem_retry_ns.load(std::memory_order_relaxed)) return;
  VmemEntry* e = OwnLedgerEntry(slot);
  if (!e) {
    b.vmem_retry_ns.store(now + 1'000'000'000, std::memory_order_relaxed);
    return;
  }
  __atomic_fetch_add(&e->activity, 1, __ATOMIC_RELAXED);
  __atomic_store_n(&e->last_update_ns, now, __ATOMIC_RELAXED);
}

CUevent TakeEvent() {
  if (!g_event_pool.empty()) {
    CUevent ev = g_event_pool.back();
    g_event_pool.pop_back();
    return ev;
  }
  auto create = VTPU_REAL_AS(PFN_cuEventCreate, "cuEventCreate");
  CUevent ev = nullptr;
  if (!create || create(&ev, CU_EVENT_DEFAULT) != CUDA_SUCCESS) return nullptr;
  return ev;
}

void GiveEvents(const Sample& s) {
  if (s.start) g_event_pool.push_back(s.start);
  if (s.end) g_event_pool.push_back(s.end);
}

// A probe's span: the min-filtered estimate follows a lower span at once
// (no span is below the true floor) and a higher one by 1/16.
void AdoptProbe(int slot, int64_t span_ns) {
  DeviceBucket& b = g_bucket[slot];
  int n = b.obs_samples.load(std::memory_order_relaxed);
  int64_t est = b.obs_overhead_ns.load(std::memory_order_relaxed);
  est = (n == 0 || span_ns < est) ? span_ns : est + (span_ns - est) / 16;
  b.obs_overhead_ns.store(est, std::memory_order_relaxed);
  b.obs_samples.store(std::min(n + 1, 1 << 20), std::memory_order_relaxed);
  g_probes.fetch_add(1, std::memory_order_relaxed);
}

// Reads back finished samples without waiting: the EMA learns the kernel's
// duration and the bucket settles the difference from what was charged.
// Caller holds g_cost_mu.
void DrainLocked() {
  auto query = VTPU_REAL_AS(PFN_cuEventQuery, "cuEventQuery");
  auto elapsed = VTPU_REAL_AS(PFN_cuEventElapsedTime, "cuEventElapsedTime");
  if (!query || !elapsed) return;
  size_t keep = 0;
  for (size_t i = 0; i < g_pending.size(); i++) {
    Sample& s = g_pending[i];
    CUresult rc = query(s.end);
    if (rc == CUDA_ERROR_NOT_READY) {
      g_pending[keep++] = s;
      continue;
    }
    float ms = 0.f;
    bool ok = rc == CUDA_SUCCESS &&
              elapsed(&ms, s.start, s.end) == CUDA_SUCCESS;
    int64_t dur = (int64_t)(ms * 1e6);
    if (!s.fn) {
      if (ok) AdoptProbe(s.slot, dur);
    } else {
      FnCost& c = g_costs[s.fn];
      c.inflight = false;
      if (ok) {
        DeviceBucket& b = g_bucket[s.slot];
        if (s.isolated) {
          dur -= std::min(ObsOverheadNs(s.slot), dur / 2);
        }
        b.observed_ns.fetch_add(dur, std::memory_order_relaxed);
        b.observed_n.fetch_add(1, std::memory_order_relaxed);
        c.ema_ns = c.ema_ns == 0
                       ? dur
                       : (int64_t)(kCostEmaAlpha * dur +
                                   (1 - kCostEmaAlpha) * c.ema_ns);
        // a blind tenant's samples lie; the tick settles against the feed
        if (!b.blind.load(std::memory_order_relaxed))
          Charge(s.slot, dur - s.charged_ns);
      }
    }
    GiveEvents(s);
  }
  g_pending.resize(keep);
}

// Two events around a 4-byte memset on an idle stream: the time from an
// event's stamp to the next operation's start. The word is pinned host
// memory, written through its mapped address, so the probe holds no
// device memory. Caller holds g_cost_mu.
void ProbeLocked(int slot, CUstream stream, PFN_cuEventRecord record) {
  auto memset32 = VTPU_REAL_AS(PFN_cuMemsetD32Async, "cuMemsetD32Async");
  if (!g_probe_word[slot]) {
    auto alloc_host = VTPU_REAL_AS(PFN_cuMemAllocHost, "cuMemAllocHost_v2");
    if (!memset32 || !alloc_host ||
        alloc_host(&g_probe_word[slot], 4) != CUDA_SUCCESS) {
      g_probe_word[slot] = nullptr;
      g_probe_off[slot] = true;
      Log(kLogWarn, "device %d: no observation probe; isolated samples are "
          "not discounted", slot);
      return;
    }
  }
  Sample s;
  s.slot = slot;
  s.start = TakeEvent();
  s.end = TakeEvent();
  bool ok = s.start && s.end && record(s.start, stream) == CUDA_SUCCESS;
  if (ok && memset32((CUdeviceptr)g_probe_word[slot], 0, 1, stream) !=
                CUDA_SUCCESS) {
    g_probe_off[slot] = true;
    Log(kLogWarn, "device %d: the probe's memset failed; isolated samples "
        "are not discounted", slot);
    ok = false;
  }
  ok = ok && record(s.end, stream) == CUDA_SUCCESS;
  if (ok && g_pending.size() < kMaxPending)
    g_pending.push_back(s);
  else
    GiveEvents(s);
}

struct Ticket {
  bool sampled = false;
  Sample sample;
  CUstream stream = nullptr;
};

// Charges the launch to its device's bucket (waiting out any debt) and,
// for a sampled launch, records the start event; a launch on an idle
// stream may carry the observation probe instead.
void BeforeLaunch(CUfunction fn, CUstream stream, Ticket* t) {
  g_launches.fetch_add(1, std::memory_order_relaxed);
  int slot = CurrentSlot();
  if (!IsMetered(Dev(slot))) return;
  StartWatcherOnce();
  DeviceBucket& b = g_bucket[slot];
  uint64_t now = NowNs();
  int64_t cost;
  bool sample, probe;
  {
    std::lock_guard<std::mutex> lock(g_cost_mu);
    DrainLocked();
    FnCost& c = g_costs[fn];
    cost = c.ema_ns > 0 ? c.ema_ns : kDefaultCostNs;
    if (b.blind.load(std::memory_order_relaxed))
      cost = std::max(cost, b.blind_cost_ns.load(std::memory_order_relaxed));
    c.launches++;
    sample = !c.inflight && g_pending.size() < kMaxPending &&
             (c.launches <= kAlwaysSampleFirst || c.launches % kSampleEvery == 0);
    if (sample) c.inflight = true;
    uint64_t since = now - b.last_probe_ns.load(std::memory_order_relaxed);
    probe = !g_probe_off[slot] && ObsOverrideNs() < 0 &&
            since >= (b.obs_samples.load(std::memory_order_relaxed) <
                              kProbeConverged
                          ? kProbeFastNs
                          : kProbeSlowNs);
  }
  RateLimit(slot, cost);
  BumpActivity(slot);
  if (!sample && !probe) return;
  auto capturing = VTPU_REAL_AS(PFN_cuStreamIsCapturing, "cuStreamIsCapturing");
  auto record = VTPU_REAL_AS(PFN_cuEventRecord, "cuEventRecord");
  auto query = VTPU_REAL_AS(PFN_cuStreamQuery, "cuStreamQuery");
  CUstreamCaptureStatus status = CU_STREAM_CAPTURE_STATUS_NONE;
  bool ok = record && query &&
            (!capturing || (capturing(stream, &status) == CUDA_SUCCESS &&
                            status == CU_STREAM_CAPTURE_STATUS_NONE));
  // idle: nothing of this tenant pending on the stream
  bool idle = ok && query(stream) == CUDA_SUCCESS;
  std::lock_guard<std::mutex> lock(g_cost_mu);
  if (probe && idle) {
    b.last_probe_ns.store(NowNs(), std::memory_order_relaxed);
    ProbeLocked(slot, stream, record);
    ok = false;  // this launch goes unsampled behind the probe
  }
  if (!sample) return;
  Sample s;
  s.fn = fn;
  s.slot = slot;
  s.charged_ns = cost;
  s.isolated = idle;
  if (ok) {
    s.start = TakeEvent();
    s.end = TakeEvent();
    ok = s.start && s.end && record(s.start, stream) == CUDA_SUCCESS;
  }
  if (!ok) {
    GiveEvents(s);
    g_costs[fn].inflight = false;
    return;
  }
  t->sampled = true;
  t->sample = s;
  t->stream = stream;
}

void AfterLaunch(CUresult rc, Ticket* t) {
  if (!t->sampled) return;
  auto record = VTPU_REAL_AS(PFN_cuEventRecord, "cuEventRecord");
  std::lock_guard<std::mutex> lock(g_cost_mu);
  if (rc == CUDA_SUCCESS && record(t->sample.end, t->stream) == CUDA_SUCCESS) {
    g_pending.push_back(t->sample);
    g_sampled.fetch_add(1, std::memory_order_relaxed);
    return;
  }
  GiveEvents(t->sample);
  g_costs[t->sample.fn].inflight = false;
}

template <typename Launch>
CUresult Metered(CUfunction fn, CUstream stream, bool ptsz, Launch launch) {
  // A null stream in a _ptsz launch is the per-thread default stream, and
  // the events must go on that stream too.
  CUstream ev_stream = (ptsz && stream == nullptr) ? CU_STREAM_PER_THREAD
                                                   : stream;
  Ticket t;
  BeforeLaunch(fn, ev_stream, &t);
  CUresult rc = launch();
  AfterLaunch(rc, &t);
  return rc;
}

}  // namespace

}  // namespace vtpu_cuda

using namespace vtpu_cuda;

VTPU_EXPORT CUresult cuLaunchKernel(CUfunction f, unsigned gx, unsigned gy,
                                    unsigned gz, unsigned bx, unsigned by,
                                    unsigned bz, unsigned smem,
                                    CUstream stream, void** params,
                                    void** extra) {
  auto real = VTPU_REAL(cuLaunchKernel);
  if (!real) return CUDA_ERROR_NOT_INITIALIZED;
  return Metered(f, stream, false, [&] {
    return real(f, gx, gy, gz, bx, by, bz, smem, stream, params, extra);
  });
}

VTPU_EXPORT CUresult cuLaunchKernel_ptsz(CUfunction f, unsigned gx,
                                         unsigned gy, unsigned gz,
                                         unsigned bx, unsigned by,
                                         unsigned bz, unsigned smem,
                                         CUstream stream, void** params,
                                         void** extra) {
  auto real = VTPU_REAL(cuLaunchKernel_ptsz);
  if (!real) return CUDA_ERROR_NOT_INITIALIZED;
  return Metered(f, stream, true, [&] {
    return real(f, gx, gy, gz, bx, by, bz, smem, stream, params, extra);
  });
}

VTPU_EXPORT CUresult cuLaunchKernelEx(const CUlaunchConfig* config,
                                      CUfunction f, void** params,
                                      void** extra) {
  auto real = VTPU_REAL(cuLaunchKernelEx);
  if (!real) return CUDA_ERROR_NOT_INITIALIZED;
  CUstream stream = config ? config->hStream : nullptr;
  return Metered(f, stream, false,
                 [&] { return real(config, f, params, extra); });
}

VTPU_EXPORT CUresult cuLaunchKernelEx_ptsz(const CUlaunchConfig* config,
                                           CUfunction f, void** params,
                                           void** extra) {
  auto real = VTPU_REAL(cuLaunchKernelEx_ptsz);
  if (!real) return CUDA_ERROR_NOT_INITIALIZED;
  CUstream stream = config ? config->hStream : nullptr;
  return Metered(f, stream, true,
                 [&] { return real(config, f, params, extra); });
}

// Counters a tenant reads over ctypes.
VTPU_EXPORT uint64_t vtpu_launches_total() {
  return g_launches.load(std::memory_order_relaxed);
}

VTPU_EXPORT uint64_t vtpu_sampled_launches_total() {
  return g_sampled.load(std::memory_order_relaxed);
}

VTPU_EXPORT uint64_t vtpu_probes_total() {
  return g_probes.load(std::memory_order_relaxed);
}

VTPU_EXPORT uint64_t vtpu_gap_bypass_total() {
  return g_gap_bypass.load(std::memory_order_relaxed);
}

VTPU_EXPORT uint64_t vtpu_fail_open_total() {
  return g_fail_open.load(std::memory_order_relaxed);
}

// Device time charged to the buckets, as settled so far.
VTPU_EXPORT int64_t vtpu_charged_ns_total() {
  return g_charged_ns.load(std::memory_order_relaxed);
}

VTPU_EXPORT uint64_t vtpu_throttle_wait_ns_total() {
  return g_throttle_wait_ns.load(std::memory_order_relaxed);
}

// The probe's estimate of an isolated sample's overhead on device 0.
VTPU_EXPORT int64_t vtpu_obs_overhead_ns() {
  return ObsOverheadNs(0);
}

VTPU_EXPORT uint64_t vtpu_watcher_external_total() {
  return g_watcher_external.load(std::memory_order_relaxed);
}

VTPU_EXPORT uint64_t vtpu_watcher_fallback_total() {
  return g_watcher_fallback.load(std::memory_order_relaxed);
}

// Balance mode's current limit on a device (0 before its first tick).
VTPU_EXPORT int vtpu_up_limit(int slot) {
  return slot >= 0 && slot < kMaxDevices
             ? g_bucket[slot].up_limit.load(std::memory_order_relaxed)
             : 0;
}

// 100 ms horizons during which a device was judged blind to its own
// device time.
VTPU_EXPORT uint64_t vtpu_blind_ticks_total() {
  return g_blind_ticks.load(std::memory_order_relaxed);
}
