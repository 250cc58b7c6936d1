// enforce_rate.cc — the compute-% cap on kernel launches.
//
// Ports library/src/enforce.cc RateLimit:2503, ExecCost:2820, BumpActivity:603,
// EffectiveLimit:1403 (a quota-market lease on the policy's base; the
// lease itself is adopted in enforce_quota.cc), MeasuredUtil:1422,
// ControllerState:1503,
// DeltaStep:1519, AimdStep:1526, WatcherTick:1540, the observation probe
// (ProbeOnce:1849) and the isolated-span discount of OnExecuteDone:2777-2812.
// The bucket is denominated in device-busy nanoseconds: each launch pays
// its kernel's cost up front, and a launch that finds the bucket in debt
// waits until the refill, at the tenant's rate, has paid the debt.
//
// What is metered. A PJRT tenant runs work one way (WrappedExecute,
// enforce.cc:3045); a CUDA tenant has three, and each goes through the
// bucket: kernel launches (cuLaunchKernel*, keyed by CUfunction),
// cooperative launches (the same, a multi-device list charged entry by
// entry to each stream's device) and CUDA-graph replays (cuGraphLaunch,
// keyed by CUgraphExec: one replay is one charge for the whole graph).
//
// Capture. A launch into a stream that is being captured runs nothing; it
// becomes a node of a graph that runs, and is charged, when replayed. So
// the stream's capture status is asked first, and a capturing stream's
// launch is neither charged nor sampled, and nothing else is done on its
// behalf: recording an event on, or querying, a capturing stream
// invalidates the capture, and in the global capture mode so does any use
// of the legacy stream (which cuStreamIsCapturing then reports as an
// error, taken as capturing). A launch from another thread into another
// stream may meet a global-mode capture it cannot see, where the sample
// drain's event queries would invalidate that capture (an unsafe call from
// a thread in the global mode); so everything the interposer does on a
// launch's behalf runs with the thread in the relaxed capture mode
// (cuThreadExchangeStreamCaptureMode), and the caller's mode is restored
// before the launch returns.
//
// Cost. A TPU program is one executable with a measured duration; a GPU
// step is many kernels. Each CUfunction (and each CUgraphExec) keeps an
// exponential moving average of its duration (alpha 0.3, as
// enforce.cc:66); beside a co-tenant it is learned otherwise (below). A
// sample of launches is
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
// that overhead (two events around an empty kernel launched through the
// real driver on an idle stream, never charged: a kernel's way to the
// card, as the sample's kernel takes it, where the reference times a
// transfer, its executions' way), min-filtered as the
// reference filters it; an isolated sample is discounted by the estimate,
// capped at half its span (vtpu_obs_overhead_ns). An operator's
// calibration, VTPU_OBS_OVERHEAD_US (enforce.cc:111), replaces the probe;
// 0 turns the discount off. The node's calibration replaces both
// (manager/obs_calibrate.py; enforce.cc:87-240, 2773-2810): an excess
// table of (idle gap, excess) points, from VTPU_OBS_EXCESS_TABLE (sorted,
// kMaxExcessPoints kept with the last, parsing stops with a warning at a
// malformed point) or from the feed's calibration block, which the tick
// adopts under a local seqlock and which takes precedence. With a table
// the probe does not run, and an isolated sample is discounted by the
// table's excess at its gap plus the discount the previous sample got
// (that sample's own inflation, which the gap observed from it lacks),
// still capped at half its span. A sample's gap is the time from the
// tenant's last return from a synchronisation (the device's last
// completion it observed) to the sample's start, as the reference's
// high-water of observed ends.
//
// Co-tenancy. Two contexts on a card without MPS take turns in time
// slices, so the span of a kernel that ran beside a co-tenant's also holds
// the co-tenant's slices (a PJRT execution, which the reference times at
// enforce.cc:2684 OnExecuteDone, is never preempted). While the feed or
// the ledger shows a co-tenant on the card, the tenants measure long
// kernels (a millisecond or more, sampled at every launch) in windows of
// their own: such a kernel's sample claims the device's sampling window (a
// small file beside the device lock, <VTPU_LOCK_DIR>/vtpu_<host>.window),
// during which every other tenant holds its launches back (StandAside),
// waits until the co-tenants' queued kernels have drained (WaitIdleCard:
// an empty kernel finishes within kIdleHostNs of its launch only on an
// idle card), launches alone, and closes the window when its kernel ends.
// A launch is then charged, and its sample settles to, the EMA of the
// kernel's windowed samples. The first sample does this, and then every
// kGateEvery-th while the spans sampled outside windows disagree with that
// EMA by more than kDisagree (a co-tenant's slices in them), else every
// kGateRefresh-th, which follows a kernel whose own time drifts. A short
// kernel, and a tenant alone, are charged the EMA of the samples outside
// windows, as before. A window that finds no idle card within twice the
// kernel's cost is given up and the next kGateBackoff chances skipped; a
// window longer than kSampleWindowMaxNs, or one whose owner has no entry
// on the card in the ledger, is neither honoured nor respected. Beside a
// co-tenant the observation probe runs only in a window of the tenant's
// own, so the isolated discount stays the launch latency, not a slice.
// What this costs: a co-tenant's launch waits while a window is open
// (vtpu_stand_aside_ns_total), and the card idles while a window waits for
// the drain to show.
//
// A co-tenant outside the ledger. A process that no interposer meters
// never stands aside, so beside one no window can find the card idle. The
// node watcher writes such a process into the feed as a resident without
// a token, with its utilization where NVML reads it per process and -1
// where it cannot; one that PidIsSelf does not claim and that no ledger
// entry of the card explains (LedgerHoldsPid) is outside: busy (util > 0),
// idle (0: taken for a co-tenant that stands aside, as before) or of
// unknown use (-1, not counted as a co-tenant). Beside one that is busy,
// or one of unknown use while no ledger co-tenant is there, a long
// kernel's gated samples are taken by the slice clock instead of a window:
// a one-thread kernel (vtpu_slice_watch) on a stream of the interposer's
// own reads %globaltimer in a loop while the tenant's kernel runs, between
// two one-thread stamps on the tenant's stream (vtpu_slice_stamp), and
// adds up the gaps longer than kClockGapNs between its reads: the times
// the card ran another context, since a time slice takes the whole
// context off the card, the watch with it. The kernel's own time is the
// span between the stamps less those gaps. The watch sleeps between reads
// (nanosleep) so that it takes next to nothing from the SM it shares with
// the kernel. A clocked sample with gaps over 1/kSlicedFrac of its span
// marks the card sliced for kSlicedHoldNs; while sliced the tenant is
// charged, and its samples settle to, the EMA of its clocked samples, as
// beside a ledger co-tenant to its windowed ones, and balance mode stays
// at hard_core. Beside co-tenants in the ledger the windows above are
// unchanged, whatever else is on the card: a window that finds no idle
// card there is a busy card, given up as any other, even beside a context
// of unknown use (on the card machine, where NVML reads no process's use,
// every phase's own idle context is one). Taking such a window for that
// context's slices put the tenant on the clock, and the clock's samples
// beside a busy ledger co-tenant hold the switches' cost (about 10 %: a
// kernel runs slower beside another busy context, F4), which the windows
// leave out (F5). Cooperative launches are not clocked (the watch takes a
// block's room on one SM).
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
// A horizon in which no sample finished is not judged (a kernel of tens of
// milliseconds may be sampled less often than every horizon).
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
//
// Steps. Every tenant whose container has StepTelemetry writes one step
// ring record per step (InitStepRingOnce:2395, RecordStepRing:2413), armed
// at its first launch from VTPU_STEP_TELEMETRY=true, VTPU_STEP_RING_PATH
// and VTPU_TRACE_ID. A PJRT Execute is one step; the driver API has none,
// so here a step is:
//   - opened by the first launch the interposer sees run (not captured)
//     after the last boundary, and timed from that launch's call;
//   - closed when the tenant's thread returns, successfully, from a
//     host-blocking synchronisation (cuStreamSynchronize and its _ptsz,
//     cuCtxSynchronize, cuEventSynchronize): loss.item() and
//     torch.cuda.synchronize() reach one. A synchronisation with no launch
//     since the last boundary writes nothing, and one that fails (as on a
//     capturing stream) is no boundary;
//   - closed at a launch, which opens the next, when the step already holds
//     a graph replay and the launch is another (one replay is one step), or
//     when the step is kStepCapNs old (a tenant that never synchronises
//     still writes a record a second).
// The interposer's own calls go through the real driver, never a boundary.
// A record holds the step's start and duration, its wait, the slot's HBM
// high-water (the most the cap granted at once) and `compiled` when the
// step launched a CUfunction or CUgraphExec seen for the first time (a
// kernel Triton or Inductor just loaded; the reference's first_execute).
// The wait of a step the bucket charged (a metered tenant's) is its time
// off the card: its duration less the device time charged since the last
// record. The bucket's own wait (vtpu_throttle_wait_ns_total) would not
// do: a launch waits while the tenant's earlier kernels still run, and a
// kernel waits behind co-tenants' time slices inside the step, so duration
// less the bucket's wait read a throttled tenant as nearly idle and a
// time-sliced one as busier than the card time it took. Such a record
// carries the bucket's wait apart (kStepFlagBucketWait, bucket_wait_us):
// what says whether the bucket binds, which the quota market asks of a
// borrower. An unmetered step keeps the bucket's wait (none).
// vtpu_step_wait_ns_total sums the waits the records took.
// One writer per ring: a Python writer arms after the interposer's on many
// tenants (bench_steps launches before it calls step_telemetry()), so
// runtime/client.py first calls vtpu_step_ring_release(), which closes this
// writer and keeps it closed, and continues the ring's index; a writer that
// finds the ring's lock held yields. Unarmed, a launch's ring check is
// one load and a branch (a synchronisation's also asks whether a table is
// active); armed, a launch takes a mutex and a set lookup, and a record is
// mmap stores.

#include <fcntl.h>
#include <pthread.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <time.h>
#include <unistd.h>

#include <algorithm>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <unordered_map>
#include <unordered_set>
#include <vector>

#include "shim.h"
#include "vtpu_quota_abi.h"
#include "vtpu_telemetry_abi.h"

namespace vtpu_cuda {

using namespace vtpu_abi;

bool Capturing(CUstream stream) {
  auto capturing = VTPU_REAL_AS(PFN_cuStreamIsCapturing, "cuStreamIsCapturing");
  if (!capturing) return false;
  CUstreamCaptureStatus status = CU_STREAM_CAPTURE_STATUS_NONE;
  return capturing(stream, &status) != CUDA_SUCCESS ||
         status != CU_STREAM_CAPTURE_STATUS_NONE;
}

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
constexpr int64_t kSampleAllNs = 1'000'000;  // a cost this long: every launch
constexpr int64_t kIdleHostNs = 300'000;  // the idle probe on an idle card
constexpr int64_t kIdlePollNs = 20'000;
constexpr int kGateBackoff = 4;
constexpr int kVoidsForSlices = 3;
constexpr uint64_t kGateEvery = 8;
constexpr uint64_t kGateRefresh = 64;
constexpr double kDisagree = 0.1;
constexpr int64_t kSampleWindowMaxNs = 50'000'000;
constexpr size_t kMaxPending = 256;
constexpr int kProbeConverged = 6;
constexpr uint64_t kProbeFastNs = 20'000'000;
constexpr uint64_t kProbeSlowNs = 1'000'000'000;
constexpr int64_t kClockGapNs = 20'000;  // the watch off the card
constexpr int64_t kClockMaxNs = 2'000'000'000;  // a watch ends by then
constexpr int64_t kSlicedFrac = 32;
constexpr uint64_t kSlicedHoldNs = 2'000'000'000;

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
  // a quota-market rewrite moved the limit: the tick restarts its
  // controller at the new one
  std::atomic<bool> limit_moved{false};
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
  std::atomic<bool> shared{false};  // a co-tenant on the card, last tick
  std::atomic<bool> ticked{false};  // a tick has judged `shared`
  std::atomic<bool> outside{false};  // a busy one outside the ledger
  std::atomic<bool> unseen{false};   // one outside it of unknown use
  // until when another context's slices are in the tenant's spans
  std::atomic<uint64_t> sliced_until_ns{0};
  std::atomic<int64_t> blind_cost_ns{0};
  std::atomic<uint64_t> vmem_retry_ns{0};
  std::atomic<int64_t> obs_overhead_ns{0};
  std::atomic<int64_t> last_discount_us{0};  // the table's, last sample
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
std::atomic<uint64_t> g_graph_launches{0};
std::atomic<uint64_t> g_captured{0};
std::atomic<uint64_t> g_sampled{0};
std::atomic<uint64_t> g_probes{0};
std::atomic<uint64_t> g_gap_bypass{0};
std::atomic<uint64_t> g_fail_open{0};
std::atomic<uint64_t> g_throttle_wait_ns{0};
std::atomic<int64_t> g_charged_ns{0};  // launch charges plus settlements
std::atomic<uint64_t> g_watcher_external{0};
std::atomic<uint64_t> g_watcher_fallback{0};
std::atomic<uint64_t> g_blind_ticks{0};
std::atomic<uint64_t> g_windows{0};          // samples taken in a window
std::atomic<uint64_t> g_stand_aside_ns{0};   // held for others' windows
std::atomic<bool> g_watcher_started{false};

struct FnCost {
  int64_t ema_ns = 0;    // EMA of the samples taken alone
  int64_t low_ns = 0;    // shared spans outside windows, min-filtered
  int64_t clean_ns = 0;  // EMA of the samples taken in windows of its own
                         // or by the slice clock
  bool clean_clocked = false;  // clean_ns is the clock's
  uint64_t launches = 0;
  bool inflight = false;
  bool agree = false;    // the last shared span outside a window ~ clean_ns
  int gate_backoff = 0;  // window chances to skip after a drain timed out
  int voids = 0;         // windows in a row whose drain timed out
};

// What a launch is charged. Beside a co-tenant: the windowed EMA, else
// (a short kernel, or before its first window) the min-filtered spans,
// which follow a lower span at once and a higher one by 1/16, as the
// probe's estimate does (a span is never shorter than the kernel's own
// time). Alone: the EMA of the samples taken alone.
int64_t CostOf(const FnCost& c, bool shared) {
  int64_t beside = c.clean_ns > 0 ? c.clean_ns : c.low_ns;
  if (shared && beside > 0) return beside;
  if (c.ema_ns > 0) return c.ema_ns;
  return beside > 0 ? beside : kDefaultCostNs;
}

// What a cost is kept for: a CUfunction or a CUgraphExec.
using CostKey = const void*;

// A sampled launch, or an observation probe (key == nullptr).
struct Sample {
  CostKey key = nullptr;
  CUevent start = nullptr;
  CUevent end = nullptr;
  int slot = 0;
  int64_t charged_ns = 0;
  bool isolated = false;
  int64_t gap_us = 0;     // isolated: idle time before it, as observed
  bool shared = false;
  bool windowed = false;  // taken in a window the co-tenants stood aside for
  bool clocked = false;   // taken by the slice clock
  uint64_t tag = 0;       // the slice clock's tag of this sample
  uint64_t deadline_ns = 0;  // the clock's record comes by then or never
};

std::mutex g_cost_mu;
std::unordered_map<CostKey, FnCost> g_costs;
std::vector<Sample> g_pending;
std::vector<CUevent> g_event_pool;
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

// --- The excess table (see "Isolated samples" above) --------------------

struct ExcessTable {
  int n = 0;
  int64_t gap_us[kMaxExcessPoints];
  int64_t excess_us[kMaxExcessPoints];
};

// VTPU_OBS_EXCESS_TABLE, parsed once (enforce.cc:115-145).
const ExcessTable& EnvExcessTable() {
  static const ExcessTable table = [] {
    ExcessTable t;
    const char* v = getenv("VTPU_OBS_EXCESS_TABLE");
    if (!v || !*v) return t;
    std::vector<std::pair<int64_t, int64_t>> pts;
    for (const char* p = v; *p;) {
      char* end = nullptr;
      long long gap = strtoll(p, &end, 10);
      long long excess = 0;
      bool ok = end != p && *end == ':';
      if (ok) {
        const char* q = end + 1;
        excess = strtoll(q, &end, 10);
        ok = end != q && (*end == ',' || *end == '\0');
      }
      if (!ok) {
        Log(kLogWarn, "VTPU_OBS_EXCESS_TABLE malformed at \"%s\"; the points "
            "from there on are ignored", p);
        break;
      }
      pts.emplace_back(gap, excess);
      p = *end == ',' ? end + 1 : end;
    }
    std::sort(pts.begin(), pts.end());
    if ((int)pts.size() > kMaxExcessPoints) {
      // the largest gap's point is the plateau long gaps clamp to
      Log(kLogWarn, "excess table has %zu points; keeping the first %d and "
          "the last", pts.size(), kMaxExcessPoints - 1);
      auto last = pts.back();
      pts.resize(kMaxExcessPoints - 1);
      pts.push_back(last);
    }
    for (const auto& pt : pts) {
      t.gap_us[t.n] = pt.first;
      t.excess_us[t.n++] = pt.second;
    }
    return t;
  }();
  return table;
}

// The feed's table, copied by the tick under a local seqlock (even =
// stable) and read by the drain.
std::atomic<uint64_t> g_feed_cal_gen{0};
std::atomic<int> g_feed_cal_n{0};
int64_t g_feed_cal_gap[kMaxExcessPoints];
int64_t g_feed_cal_excess[kMaxExcessPoints];
uint64_t g_feed_cal_seen_seq = 0;  // the tick's own

// The tick adopts a new calibration block (AdoptFeedCalibration:183).
void AdoptFeedCalibration() {
  const TcCalibration* cal = TcFeedCalibration();
  if (!cal) return;
  for (int r = 0; r < 4; r++) {
    uint64_t s1 = __atomic_load_n(&cal->seq, __ATOMIC_ACQUIRE);
    if (s1 & 1) continue;
    int n = std::clamp(cal->n_points, 0, kMaxExcessPoints);
    int64_t gap[kMaxExcessPoints], exc[kMaxExcessPoints];
    for (int i = 0; i < n; i++) {
      gap[i] = cal->gap_us[i];
      exc[i] = cal->excess_us[i];
    }
    if (__atomic_load_n(&cal->seq, __ATOMIC_ACQUIRE) != s1) continue;
    if (n == 0 || s1 == g_feed_cal_seen_seq) return;
    g_feed_cal_seen_seq = s1;
    g_feed_cal_gen.fetch_add(1, std::memory_order_acq_rel);  // odd
    for (int i = 0; i < n; i++) {
      g_feed_cal_gap[i] = gap[i];
      g_feed_cal_excess[i] = exc[i];
    }
    g_feed_cal_n.store(n, std::memory_order_relaxed);
    g_feed_cal_gen.fetch_add(1, std::memory_order_acq_rel);  // even
    Log(kLogInfo, "feed calibration adopted: %d point(s), max %lld us", n,
        (long long)exc[n - 1]);
    return;
  }
}

// Linear interpolation, clamped at the last point and anchored at an
// implicit (0, 0) below the first (InterpExcess, enforce.cc:154).
int64_t InterpExcess(const int64_t* gaps, const int64_t* excesses, int n,
                     int64_t gap_us) {
  if (n <= 0) return 0;
  if (gap_us <= gaps[0]) {
    if (gaps[0] <= 0 || gap_us <= 0) return gap_us >= gaps[0] ? excesses[0] : 0;
    return excesses[0] * gap_us / gaps[0];
  }
  if (gap_us >= gaps[n - 1]) return excesses[n - 1];
  for (int i = 1; i < n; i++) {
    if (gap_us <= gaps[i]) {
      int64_t g0 = gaps[i - 1], g1 = gaps[i];
      return excesses[i - 1] + (excesses[i] - excesses[i - 1]) *
                                   (gap_us - g0) / (g1 - g0 ? g1 - g0 : 1);
    }
  }
  return excesses[n - 1];
}

bool HasActiveExcessTable() {
  return g_feed_cal_n.load(std::memory_order_relaxed) > 0 ||
         EnvExcessTable().n > 0;
}

// The active table's excess at `gap_us`: the feed's, else the
// environment's (ActiveExcessAt:216).
int64_t ActiveExcessAt(int64_t gap_us) {
  for (int r = 0; r < 4; r++) {
    uint64_t g1 = g_feed_cal_gen.load(std::memory_order_acquire);
    if (g1 & 1) continue;
    int n = g_feed_cal_n.load(std::memory_order_relaxed);
    if (n == 0) break;
    int64_t gap[kMaxExcessPoints], exc[kMaxExcessPoints];
    for (int i = 0; i < n; i++) {
      gap[i] = g_feed_cal_gap[i];
      exc[i] = g_feed_cal_excess[i];
    }
    if (g_feed_cal_gen.load(std::memory_order_acquire) != g1) continue;
    return InterpExcess(gap, exc, n, gap_us);
  }
  const ExcessTable& t = EnvExcessTable();
  return InterpExcess(t.gap_us, t.excess_us, t.n, gap_us);
}

// When the tenant last returned from a synchronisation (the device's last
// completion it observed); kept only while a table is active.
std::atomic<uint64_t> g_last_done_ns{0};

// A hard tenant at 100 % runs unmetered, unless it lends under a lease; one
// below 100 stays metered when a lease lifts it to 100 (it is paced at 100,
// as the reference's EffectiveLimit returns 100, not 0).
bool IsMetered(const DeviceLimits* d) {
  if (!d) return false;
  int hard = Word(d->hard_core);
  int policy = Word(d->core_limit);
  if (policy == kCoreLimitHard)
    return hard > 0 &&
           (hard < 100 || EffectiveCorePct(hard, Word(d->lease_core)) < 100);
  return policy == kCoreLimitSoft && hard > 0;
}

// The policy's percent, hard_core or balance mode's current limit, with the
// quota market's lease on it (enforce.cc:1403-1416 EffectiveLimit).
int LimitPct(int slot) {
  const DeviceLimits* d = Dev(slot);
  if (!IsMetered(d)) return 0;
  int pct = Word(d->hard_core);
  if (Word(d->core_limit) == kCoreLimitSoft) {
    int up = g_bucket[slot].up_limit.load(std::memory_order_relaxed);
    if (up > 0) pct = up;
  }
  return std::clamp(EffectiveCorePct(pct, Word(d->lease_core)), 1, 100);
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
// whether a co-tenant is on the card, whether one of them is outside the
// ledger, and how much of the window the feed attributes to this tenant
// (enforce.cc:1422-1501).
int MeasuredUtil(int slot, int64_t window_ns, int64_t self_ns, bool* external,
                 bool* others, bool* outside, bool* unseen,
                 int64_t* attributed_ns, int* feed_others) {
  const DeviceLimits* d = Dev(slot);
  const TcUtilFile* feed = TcFeed();
  *external = false;
  *others = false;
  *outside = false;
  *unseen = false;
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
      int other = 0, tokenless = 0, unknown = 0;
      int tokenless_pids[kMaxProcs], unknown_pids[kMaxProcs];
      int self_share = -1, token_share = -1, token_hits = 0;
      for (int i = 0; i < nproc; i++) {
        const TcProcUtil& p = rec.procs[i];
        if (p.pid == 0) continue;
        // a resident without a token is ours when the registry-attested
        // pid set names it (enforce.cc:1444-1446)
        if (p.owner_token == 0 ? !PidIsSelf(p.pid) : p.owner_token != token) {
          if (p.owner_token == 0 && p.util < 0) {
            unknown_pids[unknown++] = p.pid;  // no co-tenant by itself
            continue;
          }
          other++;
          if (p.owner_token == 0 && p.util > 0)
            tokenless_pids[tokenless++] = p.pid;
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
      for (int i = 0; i < tokenless && !*outside; i++)
        *outside = !LedgerHoldsPid(slot, tokenless_pids[i]);
      for (int i = 0; i < unknown && !*unseen; i++)
        *unseen = !LedgerHoldsPid(slot, unknown_pids[i]);
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
  int64_t obs_n = b.observed_n.exchange(0, std::memory_order_relaxed);
  int64_t obs_ns = b.observed_ns.exchange(0, std::memory_order_relaxed);
  // a horizon in which no sample finished (a long kernel is sampled every
  // few launches) holds no evidence either
  bool judged = launches > 0 && obs_n > 0 && NowNs() - since >= kFeedLagNs;
  // what the samples saw, scaled to every launch of the horizon (the
  // reference's observed busy time). Not self_ns: while blind, that holds
  // charges learned from the feed and would clear the flag by itself.
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
  AdoptFeedCalibration();
  for (int slot = 0; slot < kMaxDevices; slot++) {
    const DeviceLimits* d = Dev(slot);
    if (!IsMetered(d)) continue;
    Refill(slot, now);
    DeviceBucket& b = g_bucket[slot];
    ControllerState* cs = &g_ctl[slot];
    if (b.limit_moved.exchange(false, std::memory_order_relaxed)) {
      cs->rate_frac = 0.0;
      cs->util_ema = -1.0;
      cs->cooldown = 0;
    }
    int64_t self_ns = b.self_tick_ns.exchange(0, std::memory_order_relaxed);
    bool external, others, outside, unseen;
    int64_t attributed;
    int feed_others;
    int used = MeasuredUtil(slot, window_ns, self_ns, &external, &others,
                            &outside, &unseen, &attributed, &feed_others);
    bool sliced = now < b.sliced_until_ns.load(std::memory_order_relaxed);
    if (feed_others >= 0 && cs->feed_others >= 0 &&
        feed_others != cs->feed_others)
      b.active_since_ns.store(now, std::memory_order_relaxed);
    if (feed_others >= 0) cs->feed_others = feed_others;
    cs->self_util_ema = 0.8 * cs->self_util_ema +
                        0.2 * (100.0 * self_ns / std::max<int64_t>(window_ns, 1));
    if (Word(d->core_limit) == kCoreLimitSoft) {
      // balance mode (enforce.cc:1552-1561); the feed's utilization is
      // averaged over NVML's period, much longer than a tick, so the climb
      // also reads the tenant's own smoothed use
      int hard = Word(d->hard_core), soft = Word(d->soft_core);
      int up = b.up_limit.load(std::memory_order_relaxed);
      if (up == 0) up = hard;
      int seen = std::max(used, (int)cs->self_util_ema);
      if (others || sliced) {
        up = hard;
      } else if (seen >= up - 5 && up < soft) {
        up = std::min(up + 2, soft);
      }
      b.up_limit.store(up, std::memory_order_relaxed);
    }
    cs->horizon_ns += window_ns;
    cs->attributed_ns += attributed;
    cs->used_sum += used;
    cs->external |= external;
    cs->others |= others;
    b.shared.store(others, std::memory_order_relaxed);
    b.ticked.store(true, std::memory_order_relaxed);
    b.outside.store(outside, std::memory_order_relaxed);
    b.unseen.store(unseen, std::memory_order_relaxed);
    if (++cs->ticks >= kHorizonTicks) JudgeHorizon(slot);
  }
  RefreshClientPids();  // enforce.cc:1664
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
    // a revoke lands before the next spend, a grant shortens this wait
    // (enforce.cc:2580); the gate stats the config once per quantum
    MaybeAdoptQuota();
    Refill(slot, t1);
  }
}

}  // namespace

void QuotaMoved(int slot, int old_pct, int new_pct, bool policy_moved) {
  if (slot < 0 || slot >= kMaxDevices) return;
  DeviceBucket& b = g_bucket[slot];
  b.rate_mpct.store(0, std::memory_order_relaxed);
  if (policy_moved) b.up_limit.store(0, std::memory_order_relaxed);
  b.limit_moved.store(true, std::memory_order_relaxed);
  if (new_pct >= old_pct) return;
  // a revoke: borrowed credit does not outlive the lease (enforce.cc:
  // 1346-1361), so the next launch pays at the new rate
  int64_t cap = kWindowNs * std::max(new_pct, 1) / 100;
  int64_t cur = b.tokens_ns.load(std::memory_order_relaxed);
  while (cur > cap && !b.tokens_ns.compare_exchange_weak(
                          cur, cap, std::memory_order_relaxed)) {
  }
}

namespace {

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

// The slice clock (see "A co-tenant outside the ledger" above). The
// watch's record, at word 8 of the clock's buffer: the tag, the watch's
// first read, the gaps' sum, the start and stop stamps' times, the number
// of gaps and whether it gave up waiting for the stop stamp. The stamps
// write [tag, time] at words 0 and 2; the watch writes its tag at word 4
// when it starts, and the start stamp waits up to 1 ms for it (the card
// may run the two streams' kernels in either order when the context
// comes back from another's slice).
constexpr char kSliceClockPtx[] =
    ".version 7.0\n.target sm_70\n.address_size 64\n"
    ".visible .entry vtpu_slice_watch(.param .u64 p_dev, .param .u64 p_rec,\n"
    "    .param .u64 p_tag, .param .u64 p_gap, .param .u64 p_max)\n{\n"
    "  .reg .pred %p<4>;\n  .reg .b64 %rd<20>;\n"
    "  ld.param.u64 %rd1, [p_dev];\n  ld.param.u64 %rd2, [p_rec];\n"
    "  ld.param.u64 %rd3, [p_tag];\n  ld.param.u64 %rd4, [p_gap];\n"
    "  ld.param.u64 %rd5, [p_max];\n"
    "  cvta.to.global.u64 %rd1, %rd1;\n  cvta.to.global.u64 %rd2, %rd2;\n"
    "  mov.u64 %rd6, %globaltimer;\n  mov.u64 %rd7, %rd6;\n"
    "  st.volatile.global.u64 [%rd1+32], %rd3;\n  membar.sys;\n"
    "  mov.u64 %rd8, 0;\n  mov.u64 %rd9, 0;\n  mov.u64 %rd10, 0;\n"
    "  mov.u64 %rd15, 0;\n"
    "LOOP:\n"
    "  mov.u64 %rd11, %globaltimer;\n  sub.u64 %rd12, %rd11, %rd7;\n"
    "  setp.gt.u64 %p1, %rd12, %rd4;\n  setp.ne.u64 %p2, %rd10, 0;\n"
    "  and.pred %p3, %p1, %p2;\n"
    "  @%p3 add.u64 %rd8, %rd8, %rd12;\n  @%p3 add.u64 %rd9, %rd9, 1;\n"
    "  mov.u64 %rd7, %rd11;\n"
    "  ld.volatile.global.u64 %rd13, [%rd1];\n"
    "  setp.eq.u64 %p1, %rd13, %rd3;\n  selp.u64 %rd10, 1, 0, %p1;\n"
    "  ld.volatile.global.u64 %rd14, [%rd1+16];\n"
    "  setp.eq.u64 %p1, %rd14, %rd3;\n  @%p1 bra DONE;\n"
    "  sub.u64 %rd12, %rd11, %rd6;\n  setp.lt.u64 %p1, %rd12, %rd5;\n"
    "  nanosleep.u32 2000;\n"
    "  @%p1 bra LOOP;\n  mov.u64 %rd15, 1;\n"
    "DONE:\n"
    "  ld.volatile.global.u64 %rd16, [%rd1+8];\n"
    "  ld.volatile.global.u64 %rd17, [%rd1+24];\n"
    "  st.volatile.global.u64 [%rd2+8], %rd6;\n"
    "  st.volatile.global.u64 [%rd2+16], %rd8;\n"
    "  st.volatile.global.u64 [%rd2+24], %rd16;\n"
    "  st.volatile.global.u64 [%rd2+32], %rd17;\n"
    "  st.volatile.global.u64 [%rd2+40], %rd9;\n"
    "  st.volatile.global.u64 [%rd2+48], %rd15;\n"
    "  membar.sys;\n  st.volatile.global.u64 [%rd2], %rd3;\n  ret;\n}\n"
    ".visible .entry vtpu_slice_stamp(.param .u64 p_word, .param .u64 p_tag,"
    "\n    .param .u64 p_wait)\n{\n"
    "  .reg .pred %p<3>;\n  .reg .b64 %rd<8>;\n"
    "  ld.param.u64 %rd1, [p_word];\n  ld.param.u64 %rd2, [p_tag];\n"
    "  ld.param.u64 %rd3, [p_wait];\n  cvta.to.global.u64 %rd1, %rd1;\n"
    "  setp.eq.u64 %p1, %rd3, 0;\n  @%p1 bra STAMP;\n"
    "  cvta.to.global.u64 %rd3, %rd3;\n  mov.u64 %rd4, %globaltimer;\n"
    "WAIT:\n"
    "  ld.volatile.global.u64 %rd5, [%rd3];\n"
    "  setp.eq.u64 %p1, %rd5, %rd2;\n  @%p1 bra STAMP;\n"
    "  mov.u64 %rd6, %globaltimer;\n  sub.u64 %rd6, %rd6, %rd4;\n"
    "  setp.lt.u64 %p2, %rd6, 1000000;\n  @%p2 bra WAIT;\n"
    "STAMP:\n"
    "  mov.u64 %rd7, %globaltimer;\n"
    "  st.volatile.global.u64 [%rd1+8], %rd7;\n  membar.sys;\n"
    "  st.volatile.global.u64 [%rd1], %rd2;\n  ret;\n}\n";
constexpr unsigned kStreamNonBlocking = 0x1;
constexpr size_t kClockBufBytes = 128;

struct SliceClock {
  CUfunction watch = nullptr;
  CUfunction stamp = nullptr;
  CUstream side = nullptr;  // the watch's own stream
  uint64_t* buf = nullptr;  // pinned host memory the card writes through
  uint64_t tag = 0;
  bool off = false;
  bool busy = false;        // a clocked sample in flight
};
SliceClock g_clock[kMaxDevices];
std::atomic<uint64_t> g_clocked{0};  // samples the slice clock settled

// Claims the slot's slice clock for a sample, loading it into the calling
// thread's context at first use. False when it is unavailable or already
// measuring. Caller holds g_cost_mu.
bool TakeClockLocked(int slot) {
  SliceClock& k = g_clock[slot];
  if (k.off || k.busy) return false;
  if (!k.buf) {
    auto load = VTPU_REAL_AS(PFN_cuModuleLoadData, "cuModuleLoadData");
    auto get = VTPU_REAL_AS(PFN_cuModuleGetFunction, "cuModuleGetFunction");
    auto create = VTPU_REAL_AS(PFN_cuStreamCreate, "cuStreamCreate");
    auto alloc_host = VTPU_REAL_AS(PFN_cuMemAllocHost, "cuMemAllocHost_v2");
    CUmodule mod = nullptr;
    void* buf = nullptr;
    if (!load || !get || !create || !alloc_host ||
        load(&mod, kSliceClockPtx) != CUDA_SUCCESS ||
        get(&k.watch, mod, "vtpu_slice_watch") != CUDA_SUCCESS ||
        get(&k.stamp, mod, "vtpu_slice_stamp") != CUDA_SUCCESS ||
        create(&k.side, kStreamNonBlocking) != CUDA_SUCCESS ||
        alloc_host(&buf, kClockBufBytes) != CUDA_SUCCESS) {
      k.off = true;
      Log(kLogWarn, "device %d: the slice clock did not load; beside a "
          "process outside the ledger the spans hold its slices", slot);
      return false;
    }
    memset(buf, 0, kClockBufBytes);
    k.buf = static_cast<uint64_t*>(buf);
  }
  k.busy = true;
  return true;
}

// Launches the watch on the clock's stream, then the start stamp on the
// tenant's; the sample carries the tag. False (the clock released) when
// a launch failed. Caller holds g_cost_mu and the clock.
bool StartClockLocked(Sample* s, CUstream stream, int64_t cost) {
  SliceClock& k = g_clock[s->slot];
  auto launch = VTPU_REAL(cuLaunchKernel);
  uint64_t tag = ++k.tag;
  uint64_t dev = (uint64_t)(uintptr_t)k.buf, rec = dev + 64;
  uint64_t gap = kClockGapNs;
  uint64_t max = (uint64_t)std::clamp<int64_t>(16 * cost, 100'000'000,
                                               kClockMaxNs);
  uint64_t started = dev + 32;
  void* watch_args[] = {&dev, &rec, &tag, &gap, &max};
  void* stamp_args[] = {&dev, &tag, &started};
  if (!launch ||
      launch(k.watch, 1, 1, 1, 1, 1, 1, 0, k.side, watch_args, nullptr) !=
          CUDA_SUCCESS ||
      launch(k.stamp, 1, 1, 1, 1, 1, 1, 0, stream, stamp_args, nullptr) !=
          CUDA_SUCCESS) {
    k.busy = false;
    return false;
  }
  s->tag = tag;
  s->deadline_ns = NowNs() + max + kSampleWindowMaxNs;
  return true;
}

// The stop stamp, after the tenant's launch; the watch ends when it runs.
void StopClockLocked(const Sample& s, CUstream stream) {
  SliceClock& k = g_clock[s.slot];
  auto launch = VTPU_REAL(cuLaunchKernel);
  uint64_t word = (uint64_t)(uintptr_t)(k.buf + 2), tag = s.tag, wait = 0;
  void* args[] = {&word, &tag, &wait};
  if (launch) launch(k.stamp, 1, 1, 1, 1, 1, 1, 0, stream, args, nullptr);
}

// A clocked sample whose end event has been reached (`ran`: without an
// error): false while the watch's record has yet to come. The kernel's
// own time is the stamps' span less the gaps; gaps over 1/kSlicedFrac of
// it mark the card sliced. Caller holds g_cost_mu.
bool SettleClockedLocked(const Sample& s, bool ran) {
  SliceClock& k = g_clock[s.slot];
  const uint64_t* rec = k.buf + 8;
  bool ready = __atomic_load_n(&rec[0], __ATOMIC_ACQUIRE) == s.tag;
  if (!ready && ran && NowNs() < s.deadline_ns) return false;
  k.busy = false;
  FnCost& c = g_costs[s.key];
  c.inflight = false;
  uint64_t start = rec[1], gap = rec[2], t0 = rec[3], t1 = rec[4];
  // the watch ran from before the start stamp to the stop stamp
  if (!ready || !ran || rec[6] != 0 || start > t0 || t1 <= t0 ||
      gap > t1 - t0) {
    Log(kLogDebug, "clocked %p void: ready=%d ran=%d timed_out=%llu "
        "late=%lld span=%lld gaps=%llu", s.key, (int)ready, (int)ran,
        (unsigned long long)rec[6], (long long)(start - t0),
        (long long)(t1 - t0), (unsigned long long)gap);
    return true;
  }
  DeviceBucket& b = g_bucket[s.slot];
  int64_t span = (int64_t)(t1 - t0), own = span - (int64_t)gap;
  // beside ledger co-tenants the gaps may be theirs, and their windows
  // measure the kernel alone: the card is sliced by something else only
  // where none is there, or a busy process outside the ledger is (F5)
  if ((int64_t)gap * kSlicedFrac > span &&
      (!b.shared.load(std::memory_order_relaxed) ||
       b.outside.load(std::memory_order_relaxed)))
    b.sliced_until_ns.store(NowNs() + kSlicedHoldNs,
                            std::memory_order_relaxed);
  b.observed_ns.fetch_add(own, std::memory_order_relaxed);
  b.observed_n.fetch_add(1, std::memory_order_relaxed);
  // a window beside a process outside the ledger may have held its
  // slices (it can start during the window): the clock's first sample
  // replaces what windows learned
  c.clean_ns = (c.clean_ns == 0 || !c.clean_clocked)
                   ? own
                   : (int64_t)(kCostEmaAlpha * own +
                               (1 - kCostEmaAlpha) * c.clean_ns);
  c.clean_clocked = true;
  g_clocked.fetch_add(1, std::memory_order_relaxed);
  bool beside = s.shared || NowNs() < b.sliced_until_ns.load(
                                          std::memory_order_relaxed);
  Log(kLogDebug, "clocked %p span=%lld gaps=%lld n=%llu own=%lld charged=%lld",
      s.key, (long long)span, (long long)gap, (unsigned long long)rec[5],
      (long long)own, (long long)s.charged_ns);
  if (!b.blind.load(std::memory_order_relaxed))
    Charge(s.slot, (beside ? CostOf(c, true) : own) - s.charged_ns);
  return true;
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
    if (s.clocked) {
      if (!SettleClockedLocked(s, rc == CUDA_SUCCESS)) {
        g_pending[keep++] = s;
        continue;
      }
      GiveEvents(s);
      continue;
    }
    float ms = 0.f;
    bool ok = rc == CUDA_SUCCESS &&
              elapsed(&ms, s.start, s.end) == CUDA_SUCCESS;
    int64_t dur = (int64_t)(ms * 1e6);
    if (!s.key) {
      // beside a co-tenant, a span longer than an idle card's launch
      // latency waited for the co-tenant's slice; the tick may have seen
      // the co-tenant only after the probe was launched (C1)
      bool beside =
          s.shared || g_bucket[s.slot].shared.load(std::memory_order_relaxed);
      if (ok && !(beside && dur > kIdleHostNs)) AdoptProbe(s.slot, dur);
    } else {
      FnCost& c = g_costs[s.key];
      c.inflight = false;
      if (ok) {
        DeviceBucket& b = g_bucket[s.slot];
        if (s.isolated) {
          int64_t disc = ObsOverheadNs(s.slot);
          if (HasActiveExcessTable())
            disc = 1000 * std::max<int64_t>(
                0, ActiveExcessAt(s.gap_us + b.last_discount_us.load(
                                                 std::memory_order_relaxed)));
          disc = std::min(disc, dur / 2);
          dur -= disc;
          b.last_discount_us.store(disc / 1000, std::memory_order_relaxed);
        } else {
          b.last_discount_us.store(0, std::memory_order_relaxed);
        }
        b.observed_ns.fetch_add(dur, std::memory_order_relaxed);
        b.observed_n.fetch_add(1, std::memory_order_relaxed);
        Log(kLogDebug, "sample %p dur=%lld isolated=%d shared=%d windowed=%d "
            "charged=%lld", s.key, (long long)dur, (int)s.isolated,
            (int)s.shared, (int)s.windowed, (long long)s.charged_ns);
        if (s.shared && !s.windowed) {
          c.low_ns = (c.low_ns == 0 || dur < c.low_ns)
                         ? dur
                         : c.low_ns + (dur - c.low_ns) / 16;
        } else {
          int64_t& ema = s.windowed ? c.clean_ns : c.ema_ns;
          // a window's sample replaces what the clock learned, as the
          // clock's first replaces the windows': the kernel ran alone in
          // it, where the clock's ran beside a busy context (F5)
          ema = (ema == 0 || (s.windowed && c.clean_clocked))
                    ? dur
                    : (int64_t)(kCostEmaAlpha * dur +
                                (1 - kCostEmaAlpha) * ema);
          if (s.windowed) c.clean_clocked = false;
        }
        if (!s.windowed && c.clean_ns > 0)
          c.agree = std::abs(dur - c.clean_ns) <= kDisagree * c.clean_ns;
        // a blind tenant's samples lie; the tick settles against the feed
        if (!b.blind.load(std::memory_order_relaxed))
          Charge(s.slot, (s.shared ? CostOf(c, true) : dur) - s.charged_ns);
      }
    }
    GiveEvents(s);
  }
  g_pending.resize(keep);
}

// The idle probe: an empty kernel, work for the compute engine, which a
// co-tenant's time slice holds back (a memset may run on a copy engine
// beside it).
constexpr char kIdleKernelPtx[] =
    ".version 6.0\n.target sm_50\n.address_size 64\n"
    ".visible .entry vtpu_idle_probe()\n{\n\tret;\n}\n";
CUfunction g_idle_fn[kMaxDevices] = {};
bool g_idle_fn_off[kMaxDevices] = {};

// The empty kernel, loaded into the calling thread's context at first use
// (nullptr when that fails). Caller holds g_cost_mu.
CUfunction IdleKernelLocked(int slot) {
  if (!g_idle_fn[slot] && !g_idle_fn_off[slot]) {
    auto load = VTPU_REAL_AS(PFN_cuModuleLoadData, "cuModuleLoadData");
    auto get = VTPU_REAL_AS(PFN_cuModuleGetFunction, "cuModuleGetFunction");
    CUmodule mod = nullptr;
    if (!load || !get || load(&mod, kIdleKernelPtx) != CUDA_SUCCESS ||
        get(&g_idle_fn[slot], mod, "vtpu_idle_probe") != CUDA_SUCCESS) {
      g_idle_fn[slot] = nullptr;
      g_idle_fn_off[slot] = true;
      Log(kLogWarn, "device %d: the idle probe's kernel did not load; "
          "co-tenant samples wait for no idle card and isolated samples "
          "are not discounted", slot);
    }
  }
  return g_idle_fn[slot];
}

// Two events around the empty kernel on an idle stream: the time from an
// event's stamp to a kernel's start, the way every isolated sample's
// kernel takes. A memset, which the card may run on a copy engine, takes
// 5-10 us less than a kernel launch on an H100, and a throttled step of 8
// kernels was over-charged by that much a launch (F6). Caller holds
// g_cost_mu.
void ProbeLocked(int slot, CUstream stream, PFN_cuEventRecord record) {
  CUfunction fn = IdleKernelLocked(slot);
  auto launch = VTPU_REAL(cuLaunchKernel);
  if (!fn || !launch) {
    g_probe_off[slot] = true;
    return;
  }
  Sample s;
  s.slot = slot;
  // before the first tick nobody has looked for a co-tenant: a probe
  // then is taken as one beside a co-tenant, whose long span is not
  // adopted (C1: such a span, a co-tenant's slice, halved every isolated
  // sample until the next probe, the windowed ones that seed the cost
  // beside a co-tenant among them)
  s.shared = g_bucket[slot].shared.load(std::memory_order_relaxed) ||
             !g_bucket[slot].ticked.load(std::memory_order_relaxed);
  s.start = TakeEvent();
  s.end = TakeEvent();
  bool ok = s.start && s.end && record(s.start, stream) == CUDA_SUCCESS &&
            launch(fn, 1, 1, 1, 1, 1, 1, 0, stream, nullptr, nullptr) ==
                CUDA_SUCCESS &&
            record(s.end, stream) == CUDA_SUCCESS;
  if (ok && g_pending.size() < kMaxPending)
    g_pending.push_back(s);
  else
    GiveEvents(s);
}

// Launches the empty kernel on `stream` until two in a row finish within
// kIdleHostNs of being launched, as the host sees it: the card is idle, no
// co-tenant holds it. Under time-slicing a busy card runs the kernel only
// at the co-tenant's slice's end, and the events around it would run in
// the same slice, so the host's clock, not the events', tells the two
// apart. One fast kernel may have been launched just before a slice ended
// while the co-tenant still has work queued; the card then goes back to
// the co-tenant, and the second kernel waits a slice. False when
// `budget_ns` ran out or the kernel is unavailable.
bool WaitIdleCard(int slot, CUstream stream, int64_t budget_ns) {
  auto record = VTPU_REAL_AS(PFN_cuEventRecord, "cuEventRecord");
  auto query = VTPU_REAL_AS(PFN_cuEventQuery, "cuEventQuery");
  auto launch = VTPU_REAL(cuLaunchKernel);
  if (!record || !query || !launch) return -1;
  CUfunction fn;
  CUevent done;
  {
    std::lock_guard<std::mutex> lock(g_cost_mu);
    fn = IdleKernelLocked(slot);
    done = TakeEvent();
  }
  uint64_t deadline = NowNs() + budget_ns;
  int fast = 0;
  while (fn && done && fast < 2) {
    uint64_t t0 = NowNs();
    if (launch(fn, 1, 1, 1, 1, 1, 1, 0, stream, nullptr, nullptr) !=
            CUDA_SUCCESS ||
        record(done, stream) != CUDA_SUCCESS)
      break;
    CUresult rc;
    while ((rc = query(done)) == CUDA_ERROR_NOT_READY && NowNs() < deadline) {
      struct timespec ts = {0, (long)kIdlePollNs};
      nanosleep(&ts, nullptr);
    }
    if (rc != CUDA_SUCCESS) break;
    fast = NowNs() - t0 <= (uint64_t)kIdleHostNs ? fast + 1 : 0;
    if (fast < 2 && NowNs() >= deadline) break;
  }
  std::lock_guard<std::mutex> lock(g_cost_mu);
  if (done) g_event_pool.push_back(done);
  return fast == 2;
}

// A device's sampling window, shared by the tenants of the node in
// <VTPU_LOCK_DIR>/vtpu_<host>.window: until when, and for which tenant,
// the others hold their launches back, so that the kernel it samples then
// runs alone. Not part of the JAX package's layouts.
struct SampleWindow {
  std::atomic<uint64_t> until_ns;
  std::atomic<uint64_t> owner;
};
static_assert(sizeof(SampleWindow) == 16, "layout");

SampleWindow* g_window[kMaxDevices] = {};
std::once_flag g_window_once[kMaxDevices];

SampleWindow* Window(int slot) {
  std::call_once(g_window_once[slot], [slot] {
    const char* dir = getenv("VTPU_LOCK_DIR");
    if (!dir || !*dir) dir = "/tmp/.vtpu_lock";
    mkdir(dir, 0777);
    char path[512];
    snprintf(path, sizeof(path), "%s/vtpu_%d.window", dir,
             Dev(slot)->host_index);
    int fd = open(path, O_CREAT | O_RDWR | O_CLOEXEC, 0666);
    if (fd < 0) return;
    struct stat st;
    if (fstat(fd, &st) == 0 && st.st_size < (off_t)sizeof(SampleWindow) &&
        ftruncate(fd, sizeof(SampleWindow)) != 0) {
      close(fd);
      return;
    }
    void* mem = mmap(nullptr, sizeof(SampleWindow), PROT_READ | PROT_WRITE,
                     MAP_SHARED, fd, 0);
    close(fd);
    if (mem != MAP_FAILED) g_window[slot] = static_cast<SampleWindow*>(mem);
  });
  return g_window[slot];
}

// Whether a window another tenant set is one a tenant of this card would
// open: no longer than kSampleWindowMaxNs from `now`, its owner on the card
// in the ledger. Any other window (a dead tenant's, a planted one) is void.
bool WindowValid(int slot, uint64_t until, uint64_t owner, uint64_t now) {
  return until - now <= (uint64_t)kSampleWindowMaxNs &&
         TenantOnCard(slot, owner);
}

// Claims the window until `until`: expired, already ours, or void.
bool OpenWindow(int slot, uint64_t until) {
  SampleWindow* w = Window(slot);
  if (!w) return false;
  uint64_t cur = w->until_ns.load(std::memory_order_acquire);
  uint64_t owner = w->owner.load(std::memory_order_relaxed);
  uint64_t now = NowNs();
  if (cur > now && owner != OwnerToken() && WindowValid(slot, cur, owner, now))
    return false;
  if (!w->until_ns.compare_exchange_strong(cur, until,
                                           std::memory_order_acq_rel))
    return false;
  w->owner.store(OwnerToken(), std::memory_order_release);
  return true;
}

// Moves our window's end (0 closes it).
void SetWindow(int slot, uint64_t until) {
  SampleWindow* w = Window(slot);
  if (w && w->owner.load(std::memory_order_acquire) == OwnerToken())
    w->until_ns.store(until, std::memory_order_release);
}

// Holds a launch while another tenant samples in a valid window, polling
// every kIdlePollNs, since the window closes when its kernel ends.
void StandAside(int slot) {
  SampleWindow* w = Window(slot);
  if (!w) return;
  uint64_t start = NowNs(), valid_owner = 0;
  for (;;) {
    uint64_t until = w->until_ns.load(std::memory_order_acquire);
    uint64_t owner = w->owner.load(std::memory_order_relaxed);
    uint64_t now = NowNs();
    if (until <= now || owner == OwnerToken() ||
        now - start > (uint64_t)kSampleWindowMaxNs)
      break;
    if (owner != valid_owner) {
      if (!WindowValid(slot, until, owner, now)) break;
      valid_owner = owner;
    }
    struct timespec ts = {0, (long)std::min<uint64_t>(until - now,
                                                      kIdlePollNs)};
    nanosleep(&ts, nullptr);
  }
  if (valid_owner)
    g_stand_aside_ns.fetch_add(NowNs() - start, std::memory_order_relaxed);
}

// Closes our window once the kernel sampled in it has ended (its end
// event), or at `until` at the latest.
void CloseWindowAfter(int slot, CUevent end, uint64_t until) {
  auto query = VTPU_REAL_AS(PFN_cuEventQuery, "cuEventQuery");
  while (end && query && query(end) == CUDA_ERROR_NOT_READY &&
         NowNs() < until) {
    struct timespec ts = {0, (long)kIdlePollNs};
    nanosleep(&ts, nullptr);
  }
  SetWindow(slot, 0);
}

struct Ticket {
  bool sampled = false;
  Sample sample;
  CUstream stream = nullptr;
  uint64_t window_until = 0;  // a windowed sample: when its window ends
};

// --- The step ring (see "Steps" above) ----------------------------------

constexpr uint64_t kStepCapNs = 1'000'000'000;

enum RingState : int { kRingUnknown = 0, kRingArmed = 1, kRingOff = 2 };
std::atomic<int> g_ring_state{kRingUnknown};
std::mutex g_ring_mu;  // the writer and the open step
StepRingWriter* g_ring = nullptr;
uint64_t g_step_start_ns = 0;  // 0: no launch since the last boundary
int g_step_slot = 0;
bool g_step_compiled = false;
bool g_step_replay = false;
uint64_t g_step_wait_ns = 0;  // the throttle wait at the last record
int64_t g_step_charged_ns = 0;  // the charged device time at the last record
std::atomic<uint64_t> g_step_wait_total_ns{0};  // the waits the records took
std::unordered_set<CostKey> g_step_keys;
std::atomic<uint64_t> g_step_records{0};

int ArmRing() {
  std::lock_guard<std::mutex> lock(g_ring_mu);
  int state = g_ring_state.load(std::memory_order_relaxed);
  if (state != kRingUnknown) return state;
  state = kRingOff;
  const char* armed = getenv("VTPU_STEP_TELEMETRY");
  const char* path = getenv("VTPU_STEP_RING_PATH");
  if (armed && strcmp(armed, "true") == 0 && path && *path) {
    auto* w = new StepRingWriter(path, getenv("VTPU_TRACE_ID"));
    if (w->ok()) {
      g_ring = w;
      g_step_wait_ns = g_throttle_wait_ns.load(std::memory_order_relaxed);
      g_step_charged_ns = g_charged_ns.load(std::memory_order_relaxed);
      state = kRingArmed;
      Log(kLogInfo, "step ring %s: this process writes it from index %llu",
          path, (unsigned long long)w->writes());
    } else {
      delete w;
      Log(kLogInfo, "step ring %s: another writer holds it", path);
    }
  }
  g_ring_state.store(state, std::memory_order_release);
  return state;
}

// Publishes the open step as ending at `end_ns`. Caller holds g_ring_mu.
void CloseStepLocked(uint64_t end_ns) {
  if (!g_ring || g_step_start_ns == 0) return;
  uint64_t wait = g_throttle_wait_ns.load(std::memory_order_relaxed);
  uint64_t wait_delta = wait >= g_step_wait_ns ? wait - g_step_wait_ns : 0;
  g_step_wait_ns = wait;
  uint64_t dur = end_ns > g_step_start_ns ? end_ns - g_step_start_ns : 0;
  int64_t charged = g_charged_ns.load(std::memory_order_relaxed);
  uint64_t on_card = charged > g_step_charged_ns
                         ? (uint64_t)(charged - g_step_charged_ns) : 0;
  g_step_charged_ns = charged;
  // the bucket's own wait goes apart when the wait is the time off the card
  int64_t bucket_wait = -1;
  if (on_card > 0) {
    bucket_wait = (int64_t)wait_delta;
    wait_delta = dur > on_card ? dur - on_card : 0;
  }
  g_step_wait_total_ns.fetch_add(wait_delta, std::memory_order_relaxed);
  int64_t peak = PeakBytes(g_step_slot);
  // the comm block: what was moved since the last record (zeros unarmed)
  CommWindow comm = TakeCommWindow();
  // the spill block: the overflow tier's bytes now, its grants and time
  SpillWindow spill = TakeSpillWindow();
  g_ring->Record(g_step_start_ns, dur, wait_delta,
                 peak > 0 ? (uint64_t)peak : 0, g_step_compiled,
                 comm.time_ns, comm.bytes, comm.collectives,
                 spill.spilled_bytes, spill.spill_events, spill.time_ns,
                 bucket_wait);
  g_step_records.fetch_add(1, std::memory_order_relaxed);
  g_step_start_ns = 0;
  g_step_compiled = false;
  g_step_replay = false;
}

// A launch the interposer sees run: opens a step, or closes the open one
// at this launch first (a second replay, or the cap).
void StepLaunch(CostKey key, int slot, bool replay) {
  int state = g_ring_state.load(std::memory_order_acquire);
  if (state == kRingUnknown) state = ArmRing();
  if (state != kRingArmed) return;
  uint64_t now = NowNs();
  std::lock_guard<std::mutex> lock(g_ring_mu);
  if (g_step_start_ns != 0 &&
      ((replay && g_step_replay) || now - g_step_start_ns >= kStepCapNs))
    CloseStepLocked(now);
  if (g_step_start_ns == 0) {
    g_step_start_ns = now;
    g_step_slot = slot;
  }
  g_step_compiled |= g_step_keys.insert(key).second;
  g_step_replay |= replay;
}

// The return of a host-blocking synchronisation on the tenant's thread:
// the device's last observed completion, and a step's end.
CUresult StepBoundary(CUresult rc) {
  if (rc != CUDA_SUCCESS) return rc;
  if (HasActiveExcessTable())
    g_last_done_ns.store(NowNs(), std::memory_order_relaxed);
  if (g_ring_state.load(std::memory_order_acquire) != kRingArmed) return rc;
  uint64_t now = NowNs();
  std::lock_guard<std::mutex> lock(g_ring_mu);
  CloseStepLocked(now);
  return rc;
}

// Charges the launch to the bucket of `slot` (the current device when -1),
// waiting out any debt, and, for a sampled launch, records the start
// event; a launch on an idle stream may carry the observation probe
// instead. A captured launch is counted and nothing more.
void BeforeLaunch(CostKey key, CUstream stream, int slot, bool may_sample,
                  bool may_clock, Ticket* t, bool replay = false) {
  g_launches.fetch_add(1, std::memory_order_relaxed);
  if (slot < 0) slot = CurrentSlot();
  // before the unmetered return: a freeze parks every tenant, and a lease
  // may make this one metered (enforce.cc:2508-2513)
  FreezePark(stream);
  if (!IsMetered(Dev(slot))) {
    // an unthrottled tenant's steps are recorded too
    if (g_ring_state.load(std::memory_order_relaxed) != kRingOff &&
        !Capturing(stream))
      StepLaunch(key, slot, replay);
    return;
  }
  if (Capturing(stream)) {
    g_captured.fetch_add(1, std::memory_order_relaxed);
    return;
  }
  StepLaunch(key, slot, replay);
  RelaxedCaptureMode relaxed;
  StartWatcherOnce();
  DeviceBucket& b = g_bucket[slot];
  uint64_t now = NowNs();
  int64_t cost;
  bool sample, probe, shared, unseen, gate = false, clock = false;
  {
    std::lock_guard<std::mutex> lock(g_cost_mu);
    DrainLocked();
    FnCost& c = g_costs[key];
    bool tenants = b.shared.load(std::memory_order_relaxed);
    bool outside = b.outside.load(std::memory_order_relaxed);
    bool sliced = now < b.sliced_until_ns.load(std::memory_order_relaxed);
    unseen = b.unseen.load(std::memory_order_relaxed);
    // the spans may hold another context's slices
    shared = tenants || sliced;
    cost = CostOf(c, shared);
    if (b.blind.load(std::memory_order_relaxed))
      cost = std::max(cost, b.blind_cost_ns.load(std::memory_order_relaxed));
    c.launches++;
    sample = may_sample && !c.inflight && g_pending.size() < kMaxPending &&
             (c.launches <= kAlwaysSampleFirst ||
              c.launches % kSampleEvery == 0 || cost >= kSampleAllNs);
    if (sample) c.inflight = true;
    // beside another context a long kernel's first sample, and then every
    // kGateEvery-th while its spans disagree with its clean cost (else
    // every kGateRefresh-th), is taken in a window of its own beside
    // co-tenants that are all in the ledger, else by the slice clock (at
    // once when its clean cost is still a window's)
    bool windows = tenants && !outside && !sliced;
    if (sample && (shared || outside || unseen) && cost >= kSampleAllNs &&
        (c.clean_ns == 0 || (!windows && !c.clean_clocked) ||
         c.launches % (c.agree ? kGateRefresh : kGateEvery) == 0)) {
      if (windows) {
        gate = c.gate_backoff == 0;
        if (!gate) c.gate_backoff--;
      } else {
        clock = may_clock && TakeClockLocked(slot);
      }
    }
    uint64_t since = now - b.last_probe_ns.load(std::memory_order_relaxed);
    // a kernel with no cost yet is sampled, not displaced by the probe
    probe = may_sample &&
            (c.ema_ns > 0 || c.low_ns > 0 || c.clean_ns > 0) &&
            !g_probe_off[slot] &&
            ObsOverrideNs() < 0 && !HasActiveExcessTable() &&
            since >= (b.obs_samples.load(std::memory_order_relaxed) <
                              kProbeConverged
                          ? kProbeFastNs
                          : kProbeSlowNs);
  }
  RateLimit(slot, cost);
  // not only while shared: the tick may not have seen the co-tenant yet
  StandAside(slot);
  BumpActivity(slot);
  if (!sample && !probe) return;
  auto record = VTPU_REAL_AS(PFN_cuEventRecord, "cuEventRecord");
  auto query = VTPU_REAL_AS(PFN_cuStreamQuery, "cuStreamQuery");
  bool ok = record && query;
  bool windowed = false;
  if (gate && ok) {
    // the co-tenants hold their launches in our window; once their kernels
    // have drained (an idle card), ours runs alone, and AfterLaunch closes
    // the window when it ends. Failing that, the launch goes unsampled and
    // the next chances are skipped.
    bool opened = OpenWindow(slot, NowNs() + kSampleWindowMaxNs);
    windowed = opened && WaitIdleCard(slot, stream,
                                      std::min(2 * cost,
                                               kSampleWindowMaxNs / 2));
    if (windowed) {
      t->window_until =
          NowNs() + std::min(cost + cost / 4, kSampleWindowMaxNs);
      SetWindow(slot, t->window_until);
    } else if (opened) {
      SetWindow(slot, 0);
    }
    std::lock_guard<std::mutex> lock(g_cost_mu);
    FnCost& c = g_costs[key];
    if (!windowed) {
      // another tenant's window is no reason to wait; a busy card is
      if (opened) c.gate_backoff = kGateBackoff;
      // beside a context of unknown use the drains that keep not coming
      // are its work: its slices are in the spans, and the clock takes
      // the sample. One that does not come may be a ledger co-tenant's
      // queued work, which its windows leave out (F5)
      c.voids = opened ? c.voids + 1 : c.voids;
      if (opened && unseen && c.voids >= kVoidsForSlices) {
        b.sliced_until_ns.store(NowNs() + kSlicedHoldNs,
                                std::memory_order_relaxed);
        shared = true;
        clock = may_clock && TakeClockLocked(slot);
      }
      if (!clock) {
        c.inflight = false;
        sample = false;
      }
    } else {
      c.voids = 0;
    }
  }
  if (!sample && !probe) return;
  // idle: nothing of this tenant pending on the stream
  bool idle = ok && query(stream) == CUDA_SUCCESS;
  std::lock_guard<std::mutex> lock(g_cost_mu);
  if (probe && idle) {
    b.last_probe_ns.store(NowNs(), std::memory_order_relaxed);
    ProbeLocked(slot, stream, record);
    // this launch goes unsampled behind the probe, or in a window or by
    // the clock sampled behind it
    if (windowed || clock)
      idle = false;
    else
      ok = false;
  }
  if (!sample) return;
  Sample s;
  s.key = key;
  s.slot = slot;
  s.charged_ns = cost;
  s.isolated = idle && !clock;
  if (s.isolated) {
    uint64_t done = g_last_done_ns.load(std::memory_order_relaxed);
    uint64_t at = NowNs();
    s.gap_us = done && at > done ? (int64_t)((at - done) / 1000) : 0;
  }
  s.shared = shared;
  s.windowed = windowed;
  s.clocked = clock;
  if (ok && clock) {
    s.end = TakeEvent();
    ok = s.end && StartClockLocked(&s, stream, cost);
  } else if (ok) {
    s.start = TakeEvent();
    s.end = TakeEvent();
    ok = s.start && s.end && record(s.start, stream) == CUDA_SUCCESS;
  }
  if (!ok) {
    GiveEvents(s);
    g_costs[key].inflight = false;
    if (windowed) SetWindow(slot, 0);
    if (clock) g_clock[slot].busy = false;
    return;
  }
  t->sampled = true;
  t->sample = s;
  t->stream = stream;
}

void AfterLaunch(CUresult rc, Ticket* t) {
  if (!t->sampled) return;
  RelaxedCaptureMode relaxed;
  auto record = VTPU_REAL_AS(PFN_cuEventRecord, "cuEventRecord");
  CUevent end = nullptr;
  {
    std::lock_guard<std::mutex> lock(g_cost_mu);
    // the watch ends at the stop stamp whether or not the launch went
    if (t->sample.clocked) StopClockLocked(t->sample, t->stream);
    if (rc == CUDA_SUCCESS &&
        record(t->sample.end, t->stream) == CUDA_SUCCESS) {
      g_pending.push_back(t->sample);
      g_sampled.fetch_add(1, std::memory_order_relaxed);
      g_windows.fetch_add(t->sample.windowed, std::memory_order_relaxed);
      end = t->sample.end;
    } else {
      GiveEvents(t->sample);
      g_costs[t->sample.key].inflight = false;
      if (t->sample.clocked) g_clock[t->sample.slot].busy = false;
    }
  }
  if (t->sample.windowed)
    CloseWindowAfter(t->sample.slot, end, t->window_until);
}

// Whether a cuLaunchKernelEx asks for a cooperative launch, which the
// slice clock's watch could keep from being co-resident.
bool Cooperative(const CUlaunchConfig* config) {
  for (unsigned i = 0; config && config->attrs && i < config->numAttrs; i++) {
    const CUlaunchAttribute_st& a = config->attrs[i];
    int on = 0;
    memcpy(&on, a.value, sizeof(on));
    if (a.id == CU_LAUNCH_ATTRIBUTE_COOPERATIVE && on) return true;
  }
  return false;
}

template <typename Launch>
CUresult Metered(CostKey key, CUstream stream, bool ptsz, bool may_clock,
                 Launch launch, bool replay = false) {
  // A null stream in a _ptsz launch is the per-thread default stream, and
  // the events must go on that stream too.
  CUstream ev_stream = (ptsz && stream == nullptr) ? CU_STREAM_PER_THREAD
                                                   : stream;
  Ticket t;
  BeforeLaunch(key, ev_stream, -1, /*may_sample=*/true, may_clock, &t,
               replay);
  // a collective's span starts after the bucket's wait, as its kernel,
  // and ends before AfterLaunch, which waits out a window's kernel
  bool collective = !replay && IsCollective(key);
  CommBracket comm = collective ? OpenComm(ev_stream) : CommBracket{};
  CUresult rc = launch();
  if (collective) CloseComm(comm, rc == CUDA_SUCCESS, 0, true);
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
  return Metered(f, stream, false, true, [&] {
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
  return Metered(f, stream, true, true, [&] {
    return real(f, gx, gy, gz, bx, by, bz, smem, stream, params, extra);
  });
}

VTPU_EXPORT CUresult cuLaunchKernelEx(const CUlaunchConfig* config,
                                      CUfunction f, void** params,
                                      void** extra) {
  auto real = VTPU_REAL(cuLaunchKernelEx);
  if (!real) return CUDA_ERROR_NOT_INITIALIZED;
  CUstream stream = config ? config->hStream : nullptr;
  return Metered(f, stream, false, !Cooperative(config),
                 [&] { return real(config, f, params, extra); });
}

VTPU_EXPORT CUresult cuLaunchKernelEx_ptsz(const CUlaunchConfig* config,
                                           CUfunction f, void** params,
                                           void** extra) {
  auto real = VTPU_REAL(cuLaunchKernelEx_ptsz);
  if (!real) return CUDA_ERROR_NOT_INITIALIZED;
  CUstream stream = config ? config->hStream : nullptr;
  return Metered(f, stream, true, !Cooperative(config),
                 [&] { return real(config, f, params, extra); });
}

VTPU_EXPORT CUresult cuLaunchCooperativeKernel(CUfunction f, unsigned gx,
                                               unsigned gy, unsigned gz,
                                               unsigned bx, unsigned by,
                                               unsigned bz, unsigned smem,
                                               CUstream stream,
                                               void** params) {
  auto real = VTPU_REAL(cuLaunchCooperativeKernel);
  if (!real) return CUDA_ERROR_NOT_INITIALIZED;
  return Metered(f, stream, false, false, [&] {
    return real(f, gx, gy, gz, bx, by, bz, smem, stream, params);
  });
}

VTPU_EXPORT CUresult cuLaunchCooperativeKernel_ptsz(
    CUfunction f, unsigned gx, unsigned gy, unsigned gz, unsigned bx,
    unsigned by, unsigned bz, unsigned smem, CUstream stream,
    void** params) {
  auto real = VTPU_REAL(cuLaunchCooperativeKernel_ptsz);
  if (!real) return CUDA_ERROR_NOT_INITIALIZED;
  return Metered(f, stream, true, false, [&] {
    return real(f, gx, gy, gz, bx, by, bz, smem, stream, params);
  });
}

// Each entry is charged to its stream's device. Entries are not sampled:
// the interposer's events belong to the calling thread's context, and an
// entry's stream may lie in another one.
VTPU_EXPORT CUresult cuLaunchCooperativeKernelMultiDevice(
    CUDA_LAUNCH_PARAMS* list, unsigned num_devices, unsigned flags) {
  auto real = VTPU_REAL(cuLaunchCooperativeKernelMultiDevice);
  if (!real) return CUDA_ERROR_NOT_INITIALIZED;
  auto stream_ctx = VTPU_REAL_AS(PFN_cuStreamGetCtx, "cuStreamGetCtx");
  auto push = VTPU_REAL_AS(PFN_cuCtxPushCurrent, "cuCtxPushCurrent_v2");
  auto pop = VTPU_REAL_AS(PFN_cuCtxPopCurrent, "cuCtxPopCurrent_v2");
  auto get_device = VTPU_REAL_AS(PFN_cuCtxGetDevice, "cuCtxGetDevice");
  for (unsigned i = 0; list && i < num_devices; i++) {
    int slot = -1;
    CUcontext ctx = nullptr;
    CUdevice dev = 0;
    if (stream_ctx && push && pop && get_device &&
        stream_ctx(list[i].hStream, &ctx) == CUDA_SUCCESS &&
        push(ctx) == CUDA_SUCCESS) {
      if (get_device(&dev) == CUDA_SUCCESS && dev >= 0 && dev < kMaxDevices)
        slot = dev;
      pop(&ctx);
    }
    Ticket t;
    BeforeLaunch(list[i].function, list[i].hStream, slot,
                 /*may_sample=*/false, /*may_clock=*/false, &t);
  }
  return real(list, num_devices, flags);
}

VTPU_EXPORT CUresult cuGraphLaunch(CUgraphExec exec, CUstream stream) {
  auto real = VTPU_REAL(cuGraphLaunch);
  if (!real) return CUDA_ERROR_NOT_INITIALIZED;
  g_graph_launches.fetch_add(1, std::memory_order_relaxed);
  return Metered(
      exec, stream, false, true, [&] { return real(exec, stream); }, true);
}

VTPU_EXPORT CUresult cuGraphLaunch_ptsz(CUgraphExec exec, CUstream stream) {
  auto real = VTPU_REAL(cuGraphLaunch_ptsz);
  if (!real) return CUDA_ERROR_NOT_INITIALIZED;
  g_graph_launches.fetch_add(1, std::memory_order_relaxed);
  return Metered(
      exec, stream, true, true, [&] { return real(exec, stream); }, true);
}

// The synchronisations that close a step (see "Steps" above).
VTPU_EXPORT CUresult cuStreamSynchronize(CUstream stream) {
  auto real = VTPU_REAL(cuStreamSynchronize);
  if (!real) return CUDA_ERROR_NOT_INITIALIZED;
  return StepBoundary(real(stream));
}

VTPU_EXPORT CUresult cuStreamSynchronize_ptsz(CUstream stream) {
  auto real = VTPU_REAL(cuStreamSynchronize_ptsz);
  if (!real) return CUDA_ERROR_NOT_INITIALIZED;
  return StepBoundary(real(stream));
}

VTPU_EXPORT CUresult cuCtxSynchronize() {
  auto real = VTPU_REAL(cuCtxSynchronize);
  if (!real) return CUDA_ERROR_NOT_INITIALIZED;
  return StepBoundary(real());
}

VTPU_EXPORT CUresult cuEventSynchronize(CUevent event) {
  auto real = VTPU_REAL(cuEventSynchronize);
  if (!real) return CUDA_ERROR_NOT_INITIALIZED;
  return StepBoundary(real(event));
}

// Counters a tenant reads over ctypes. Every launch the hooks saw, graph
// replays and captured launches included.
VTPU_EXPORT uint64_t vtpu_launches_total() {
  return g_launches.load(std::memory_order_relaxed);
}

VTPU_EXPORT uint64_t vtpu_graph_launches_total() {
  return g_graph_launches.load(std::memory_order_relaxed);
}

// Launches of a metered tenant into a capturing stream: not charged.
VTPU_EXPORT uint64_t vtpu_captured_launches_total() {
  return g_captured.load(std::memory_order_relaxed);
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

// The waits the interposer's ring records took: a metered step's time off
// the card, an unmetered step's bucket wait (see "Steps").
VTPU_EXPORT uint64_t vtpu_step_wait_ns_total() {
  return g_step_wait_total_ns.load(std::memory_order_relaxed);
}

// Samples taken in a sampling window of this tenant's own, and the time
// its launches stood aside for other tenants' windows.
VTPU_EXPORT uint64_t vtpu_windows_total() {
  return g_windows.load(std::memory_order_relaxed);
}

VTPU_EXPORT uint64_t vtpu_stand_aside_ns_total() {
  return g_stand_aside_ns.load(std::memory_order_relaxed);
}

// Samples the slice clock measured (beside a context outside the ledger).
VTPU_EXPORT uint64_t vtpu_clocked_total() {
  return g_clocked.load(std::memory_order_relaxed);
}

// The step ring: records this process wrote, and the handover to a Python
// writer (runtime/client.py step_telemetry): closes the interposer's
// writer, which drops the ring's lock, and keeps it closed. 1 when it had
// the ring.
VTPU_EXPORT uint64_t vtpu_step_records_total() {
  return g_step_records.load(std::memory_order_relaxed);
}

VTPU_EXPORT int vtpu_step_ring_release() {
  std::lock_guard<std::mutex> lock(g_ring_mu);
  int had = g_ring != nullptr;
  delete g_ring;
  g_ring = nullptr;
  g_step_start_ns = 0;
  g_ring_state.store(kRingOff, std::memory_order_release);
  return had;
}

// The active excess table at `gap_us` (the feed's, else the
// environment's), or -1 with none: what an isolated sample after that gap
// is discounted, before the half-span cap.
VTPU_EXPORT int64_t vtpu_obs_excess_at_us(int64_t gap_us) {
  return HasActiveExcessTable() ? ActiveExcessAt(gap_us) : -1;
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

// The limit a device's bucket paces to, in percent, the quota market's
// lease included (0 when the device is not metered).
VTPU_EXPORT int vtpu_core_limit(int slot) {
  return slot >= 0 && slot < kMaxDevices ? LimitPct(slot) : 0;
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
