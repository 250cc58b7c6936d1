// enforce_rate.cc — the compute-% cap on kernel launches.
//
// Ports library/src/enforce.cc RateLimit:2503, WatcherTick:1540 (with the
// DeltaStep:1519 self-estimate path) and ExecCost:2820. The bucket is
// denominated in device-busy nanoseconds: each launch pays its kernel's
// cost up front, and a launch that finds the bucket in debt waits until the
// refill, at VTPU_CORE_LIMIT_<i> percent of wall time, has paid the debt.
//
// Cost. A TPU program is one executable with a measured duration; a GPU
// step is many kernels. Each CUfunction keeps an exponential moving average
// of its duration (alpha 0.3, as enforce.cc:66). A sample of launches is
// bracketed by two cuEventRecord calls on the launch's stream, and the pair
// is read back later with a non-blocking cuEventQuery, in the launching
// thread, so a launch never waits on the device. A measured sample also
// settles what its launch was charged: the bucket pays back or takes the
// difference, the reconciliation WatcherTick does against busy time.
//
// Refill. A watcher thread refills every 10 ms window (the GPU's kernels
// are micro- to milliseconds long, where the TPU's 100 ms window suits
// whole programs); a thread waiting on debt also refills for the time it
// has waited, so the wait ends on time rather than on the next tick.
//
// Bypass and fail-open. The first launch after more than 200 ms of idle
// goes at once and its cost becomes debt (enforce.cc:2541); a launch that
// has waited 10 s goes unthrottled (enforce.cc:2561-2571).

#include <pthread.h>
#include <time.h>
#include <unistd.h>

#include <algorithm>
#include <mutex>
#include <unordered_map>
#include <vector>

#include "shim.h"

namespace vtpu_cuda {

namespace {

constexpr int64_t kWindowNs = 10'000'000;
constexpr uint64_t kGapThresholdNs = 200'000'000;
constexpr uint64_t kFailOpenNs = 10'000'000'000;
constexpr int64_t kDefaultCostNs = 50'000;  // before the first sample
constexpr double kCostEmaAlpha = 0.3;
constexpr int64_t kMinSleepNs = 20'000;
constexpr int64_t kMaxSleepNs = 2'000'000;
constexpr uint64_t kAlwaysSampleFirst = 16;
constexpr uint64_t kSampleEvery = 4;
constexpr size_t kMaxPending = 256;

struct DeviceBucket {
  std::atomic<int64_t> tokens_ns{0};
  std::atomic<uint64_t> last_refill_ns{0};
  std::atomic<uint64_t> last_submit_ns{0};
};

DeviceBucket g_bucket[kMaxDevices];
std::atomic<uint64_t> g_launches{0};
std::atomic<uint64_t> g_sampled{0};
std::atomic<uint64_t> g_gap_bypass{0};
std::atomic<uint64_t> g_fail_open{0};
std::atomic<uint64_t> g_throttle_wait_ns{0};
std::atomic<int64_t> g_charged_ns{0};  // launch charges plus settlements
std::atomic<bool> g_watcher_started{false};

struct FnCost {
  int64_t ema_ns = 0;
  uint64_t launches = 0;
  bool inflight = false;
};

struct Sample {
  CUfunction fn = nullptr;
  CUevent start = nullptr;
  CUevent end = nullptr;
  int slot = 0;
  int64_t charged_ns = 0;
};

std::mutex g_cost_mu;
std::unordered_map<CUfunction, FnCost> g_costs;
std::vector<Sample> g_pending;
std::vector<CUevent> g_event_pool;

int Quota(int slot) {
  const Config& c = Cfg();
  return c.disabled ? 0 : c.core_limit[slot];
}

int64_t BurstCapNs(int quota) { return kWindowNs * quota / 100; }

// Adds the quota's share of the wall time since the last refill. The first
// refill seeds one window's grant, so a new tenant does not start empty.
void Refill(int slot, uint64_t now) {
  int quota = Quota(slot);
  if (quota == 0) return;
  DeviceBucket& b = g_bucket[slot];
  uint64_t prev = b.last_refill_ns.load(std::memory_order_relaxed);
  if (now <= prev ||
      !b.last_refill_ns.compare_exchange_strong(prev, now,
                                                std::memory_order_relaxed))
    return;
  int64_t cap = BurstCapNs(quota);
  int64_t add = prev == 0 ? cap : (int64_t)(now - prev) * quota / 100;
  int64_t cur = b.tokens_ns.load(std::memory_order_relaxed);
  int64_t next;
  do {
    next = std::max(cur, std::min(cur + add, cap));
  } while (!b.tokens_ns.compare_exchange_weak(cur, next,
                                              std::memory_order_relaxed));
}

void* WatcherMain(void*) {
  struct timespec next;
  clock_gettime(CLOCK_MONOTONIC, &next);
  for (;;) {
    next.tv_nsec += kWindowNs;
    while (next.tv_nsec >= 1'000'000'000) {
      next.tv_nsec -= 1'000'000'000;
      next.tv_sec += 1;
    }
    clock_nanosleep(CLOCK_MONOTONIC, TIMER_ABSTIME, &next, nullptr);
    uint64_t now = NowNs();
    for (int slot = 0; slot < kMaxDevices; slot++) Refill(slot, now);
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
  int quota = Quota(slot);
  DeviceBucket& b = g_bucket[slot];
  uint64_t now = NowNs();
  uint64_t last = b.last_submit_ns.exchange(now, std::memory_order_relaxed);
  Refill(slot, now);
  g_charged_ns.fetch_add(cost_ns, std::memory_order_relaxed);
  if (last == 0 || now - last > kGapThresholdNs) {
    b.tokens_ns.fetch_sub(cost_ns, std::memory_order_relaxed);
    g_gap_bypass.fetch_add(1, std::memory_order_relaxed);
    return;
  }
  for (;;) {
    int64_t cur = b.tokens_ns.load(std::memory_order_relaxed);
    if (cur >= 0) {
      if (b.tokens_ns.compare_exchange_weak(cur, cur - cost_ns,
                                            std::memory_order_relaxed))
        return;
      continue;
    }
    uint64_t waited = NowNs() - now;
    if (waited > kFailOpenNs) {
      Log(kLogError, "rate limiter stuck on device %d; failing open", slot);
      b.tokens_ns.fetch_sub(cost_ns, std::memory_order_relaxed);
      g_fail_open.fetch_add(1, std::memory_order_relaxed);
      return;
    }
    int64_t sleep_ns =
        std::clamp<int64_t>(-cur * 100 / quota, kMinSleepNs, kMaxSleepNs);
    struct timespec ts = {0, (long)sleep_ns};
    uint64_t t0 = NowNs();
    nanosleep(&ts, nullptr);
    uint64_t t1 = NowNs();
    g_throttle_wait_ns.fetch_add(t1 - t0, std::memory_order_relaxed);
    Refill(slot, t1);
  }
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
    FnCost& c = g_costs[s.fn];
    c.inflight = false;
    float ms = 0.f;
    if (rc == CUDA_SUCCESS && elapsed(&ms, s.start, s.end) == CUDA_SUCCESS) {
      int64_t dur = (int64_t)(ms * 1e6);
      c.ema_ns = c.ema_ns == 0
                     ? dur
                     : (int64_t)(kCostEmaAlpha * dur +
                                 (1 - kCostEmaAlpha) * c.ema_ns);
      g_bucket[s.slot].tokens_ns.fetch_sub(dur - s.charged_ns,
                                           std::memory_order_relaxed);
      g_charged_ns.fetch_add(dur - s.charged_ns, std::memory_order_relaxed);
    }
    GiveEvents(s);
  }
  g_pending.resize(keep);
}

struct Ticket {
  bool sampled = false;
  Sample sample;
  CUstream stream = nullptr;
};

// Charges the launch to its device's bucket (waiting out any debt) and,
// for a sampled launch, records the start event.
void BeforeLaunch(CUfunction fn, CUstream stream, Ticket* t) {
  g_launches.fetch_add(1, std::memory_order_relaxed);
  int slot = CurrentSlot();
  if (Quota(slot) == 0) return;
  StartWatcherOnce();
  int64_t cost;
  bool sample;
  {
    std::lock_guard<std::mutex> lock(g_cost_mu);
    DrainLocked();
    FnCost& c = g_costs[fn];
    cost = c.ema_ns > 0 ? c.ema_ns : kDefaultCostNs;
    c.launches++;
    sample = !c.inflight && g_pending.size() < kMaxPending &&
             (c.launches <= kAlwaysSampleFirst || c.launches % kSampleEvery == 0);
    if (sample) c.inflight = true;
  }
  RateLimit(slot, cost);
  if (!sample) return;
  auto capturing = VTPU_REAL_AS(PFN_cuStreamIsCapturing, "cuStreamIsCapturing");
  auto record = VTPU_REAL_AS(PFN_cuEventRecord, "cuEventRecord");
  CUstreamCaptureStatus status = CU_STREAM_CAPTURE_STATUS_NONE;
  bool ok = record && (!capturing || (capturing(stream, &status) ==
                                          CUDA_SUCCESS &&
                                      status == CU_STREAM_CAPTURE_STATUS_NONE));
  std::lock_guard<std::mutex> lock(g_cost_mu);
  Sample s;
  s.fn = fn;
  s.slot = slot;
  s.charged_ns = cost;
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
