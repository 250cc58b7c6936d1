// fake_cuda_driver.cc — a stand-in libcuda.so.1 for testing the interposer
// on a host with no GPU (the counterpart of library/test/fake_pjrt_plugin.cc).
//
// It models one device with an in-order timeline: a launch starts when the
// device is free and occupies it for FAKE_EXEC_US microseconds; an event
// completes when the device reaches it; a synchronize sleeps until the
// device is free. Memory is bookkeeping only, against FAKE_TOTAL_MEM bytes.
// Link with -Wl,-Bsymbolic so its own addresses stay its own when the
// interposer, preloaded ahead of it, exports the same names.
//
// Knobs (the counterparts of library/test/fake_pjrt_plugin.cc:91-168, 403):
//   FAKE_SUBMIT_LATENCY_US  work issued to an idle device starts this much
//                           after the call; an event recorded on an idle
//                           stream is stamped at once (a card's way from
//                           the launch call to the kernel's start)
//   FAKE_SHARED_STATE=path  one device for every process naming the path:
//                           an flock on <path>.lock guards a shared timeline
//                           (kernels of all processes run one at a time, in
//                           launch order) and the file counts busy ns (u64
//                           at offset 0) for a test playing the watcher
//   FAKE_LYING_EVENTS=1     events complete when recorded: the process
//                           cannot see its own device time
//   FAKE_TIMESLICE_US=n     with FAKE_SHARED_STATE: the card time-slices
//                           between processes, as two CUDA contexts without
//                           MPS do. While several processes have work
//                           queued, execution alternates between them in
//                           slices of n microseconds (round robin); a
//                           kernel's events then bracket the co-tenants'
//                           slices too. Alone, a process runs as in FIFO.
//                           Each process's queue counts the busy ns its own
//                           work took (SliceProc.busy_ns), beside the
//                           card's total: NVML's per-process utilization
//                           for a test playing the watcher, which finds
//                           the layout through fake_slice_layout().
//
// Stream capture follows the driver's rules as far as the interposer meets
// them: a launch into a capturing stream becomes a node of the graph and
// runs nothing; a graph replay runs each node for FAKE_EXEC_US. Recording
// an event on, or querying, a capturing stream invalidates its capture, as
// does touching the legacy stream during a global-mode capture, or querying
// an event from a thread whose capture mode prohibits it: a thread in the
// global mode (the default) while any global-mode capture is underway, a
// thread in the thread-local mode while its own capture is; a thread in the
// relaxed mode (cuThreadExchangeStreamCaptureMode) never. cuStreamEndCapture
// then fails. A stream's device is
// bits 12-15 of its handle (cuStreamGetCtx), for multi-device launches.
// cuModuleLoadData and cuModuleGetFunction give, for any image and name, a
// kernel that runs no time (the interposer's idle probe loads one), except
// the interposer's slice clock (vtpu_slice_watch, vtpu_slice_stamp): a
// stamp writes, once the card has run it, the time it ran and its tag into
// the two words it names, and a watch, once the stop stamp of its tag has
// run, writes its record as the card's kernel would. On the sliced card
// the record's gap is the time between the two stamps that the process's
// own work did not run (what the card gave the co-tenants); elsewhere it
// is 0.

#include <fcntl.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <sys/file.h>
#include <sys/mman.h>
#include <time.h>
#include <unistd.h>

#include <algorithm>
#include <cstddef>
#include <map>
#include <mutex>
#include <thread>
#include <vector>

#include "../cuda_subset.h"

#define FAKE_EXPORT extern "C" __attribute__((visibility("default")))

namespace {

struct FakeEvent {
  uint64_t at_ns = 0;
  bool recorded = false;
  uint64_t seq = 0;  // sliced card: the item it waits for (0 = stamped)
};

std::mutex g_mu;
uint64_t g_free_at_ns = 0;  // when this process's queue drains
uint64_t g_launches = 0;
uint64_t g_used = 0;
uint64_t g_next_ptr = 0x10000000;
unsigned long long g_next_handle = 1;
std::map<CUdeviceptr, uint64_t> g_ptrs;
std::map<CUmemGenericAllocationHandle, uint64_t> g_handles;
std::map<uintptr_t, uint64_t> g_arrays;  // arrays and mipmapped arrays
uintptr_t g_next_array = 0x7000;
uint64_t g_graph_launches = 0;
uint64_t g_coop_launches = 0;

// The process's one capture (enough for the harness and the interposer).
struct FakeCapture {
  CUstream stream = nullptr;
  int mode = CU_STREAM_CAPTURE_MODE_GLOBAL;
  bool active = false;
  bool invalidated = false;
  uint64_t nodes = 0;
  std::thread::id owner;  // the thread that began it
};
FakeCapture g_capture;
// The calling thread's capture mode (cuThreadExchangeStreamCaptureMode).
thread_local int t_capture_mode = CU_STREAM_CAPTURE_MODE_GLOBAL;

struct FakeGraph {
  uint64_t nodes = 0;
};

uint64_t NowNs() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return (uint64_t)ts.tv_sec * 1000000000ull + (uint64_t)ts.tv_nsec;
}

uint64_t EnvU64(const char* name, uint64_t fallback) {
  const char* raw = getenv(name);
  return (raw && *raw) ? strtoull(raw, nullptr, 10) : fallback;
}

uint64_t ExecNs() { return EnvU64("FAKE_EXEC_US", 1000) * 1000; }
uint64_t TotalMem() { return EnvU64("FAKE_TOTAL_MEM", 16ull << 30); }
uint64_t LatencyNs() { return EnvU64("FAKE_SUBMIT_LATENCY_US", 0) * 1000; }
bool LyingEvents() { return EnvU64("FAKE_LYING_EVENTS", 0) != 0; }

// The time-sliced card's per-process queue: work items by sequence
// number, each with its execution time, the time it may start (submission
// latency) and, once run, when it finished.
constexpr int kSliceProcs = 8;
constexpr uint64_t kSliceRing = 256;

struct SliceProc {
  int32_t pid;  // 0 = free
  int32_t pad_;
  uint64_t busy_ns;       // what this process's work has run
  uint64_t next_seq;      // items submitted
  uint64_t done_seq;      // items finished
  uint64_t head_left_ns;  // what the oldest unfinished item has left to run
  uint64_t exec_ns[kSliceRing];
  uint64_t ready_ns[kSliceRing];
  uint64_t done_at_ns[kSliceRing];
  uint64_t done_busy_ns[kSliceRing];  // busy_ns when the item finished
};

struct SharedChip {
  uint64_t busy_ns;
  uint64_t free_at_ns;
  // time-slicing: the card is simulated up to sim_ns, slice owner current
  uint64_t sim_ns;
  int32_t current;
  int32_t pad_;
  uint64_t slice_end_ns;
  SliceProc procs[kSliceProcs];
};
SharedChip* g_shared = nullptr;
int g_shared_lock_fd = -1;
int g_slice_slot = -1;  // this process's queue on the sliced card

void InitSharedChip() {
  const char* path = getenv("FAKE_SHARED_STATE");
  if (!path || !*path) return;
  int fd = open(path, O_CREAT | O_RDWR, 0666);
  if (fd < 0) return;
  if (ftruncate(fd, sizeof(SharedChip)) != 0) {
    close(fd);
    return;
  }
  void* mem = mmap(nullptr, sizeof(SharedChip), PROT_READ | PROT_WRITE,
                   MAP_SHARED, fd, 0);
  close(fd);
  if (mem == MAP_FAILED) return;
  char lock_path[512];
  snprintf(lock_path, sizeof(lock_path), "%s.lock", path);
  g_shared_lock_fd = open(lock_path, O_CREAT | O_RDWR, 0666);
  g_shared = static_cast<SharedChip*>(mem);
}

uint64_t SliceNs() { return EnvU64("FAKE_TIMESLICE_US", 0) * 1000; }

bool Sliced() {
  static std::once_flag once;
  std::call_once(once, InitSharedChip);
  return g_shared && SliceNs() > 0;
}

// Holds the shared card's flock for a scope.
struct ChipLock {
  ChipLock() { flock(g_shared_lock_fd, LOCK_EX); }
  ~ChipLock() { flock(g_shared_lock_fd, LOCK_UN); }
};

uint64_t Pending(const SliceProc& p) { return p.next_seq - p.done_seq; }

// Whether a process has work that may run at `t`.
bool Runnable(const SliceProc& p, uint64_t t) {
  return p.pid != 0 && Pending(p) > 0 &&
         p.ready_ns[(p.done_seq + 1) % kSliceRing] <= t;
}

// Runs the sliced card's simulation up to `now`: the slice's owner runs
// its oldest item until the item ends (then its next one) or the slice
// ends; then the next process with runnable work takes a slice. Caller
// holds the chip lock.
void AdvanceLocked(uint64_t now) {
  SharedChip& c = *g_shared;
  if (c.sim_ns == 0) c.sim_ns = now;
  while (c.sim_ns < now) {
    uint64_t t = c.sim_ns;
    bool keep = c.current >= 0 && Runnable(c.procs[c.current], t) &&
                t < c.slice_end_ns;
    if (!keep) {
      int pick = -1;
      for (int i = 1; i <= kSliceProcs; i++) {
        int cand = ((c.current < 0 ? -1 : c.current) + i + kSliceProcs) %
                   kSliceProcs;
        if (Runnable(c.procs[cand], t)) {
          pick = cand;
          break;
        }
      }
      if (pick < 0) {
        // idle until the earliest submitted item may start
        uint64_t next = now;
        for (const SliceProc& p : c.procs)
          if (p.pid != 0 && Pending(p) > 0)
            next = std::min(next, p.ready_ns[(p.done_seq + 1) % kSliceRing]);
        c.current = -1;
        c.sim_ns = std::max(next, t);
        continue;
      }
      c.current = pick;
      c.slice_end_ns = t + SliceNs();
    }
    SliceProc& p = c.procs[c.current];
    uint64_t run = std::min({p.head_left_ns, c.slice_end_ns - t, now - t});
    p.head_left_ns -= run;
    c.sim_ns = t + run;
    c.busy_ns += run;
    p.busy_ns += run;
    if (p.head_left_ns == 0) {
      p.done_seq++;
      p.done_at_ns[p.done_seq % kSliceRing] = c.sim_ns;
      p.done_busy_ns[p.done_seq % kSliceRing] = p.busy_ns;
      if (Pending(p) > 0)
        p.head_left_ns = p.exec_ns[(p.done_seq + 1) % kSliceRing];
    }
  }
}

// This process's queue on the sliced card, claimed at first use. Caller
// holds the chip lock.
SliceProc& OwnSliceLocked() {
  if (g_slice_slot < 0) {
    int pid = (int)getpid();
    for (int i = 0; i < kSliceProcs && g_slice_slot < 0; i++)
      if (g_shared->procs[i].pid == 0) {
        memset(&g_shared->procs[i], 0, sizeof(SliceProc));
        g_shared->procs[i].pid = pid;
        g_slice_slot = i;
      }
    if (g_slice_slot < 0) {
      fprintf(stderr, "fake driver: more than %d processes on the sliced "
              "card\n", kSliceProcs);
      abort();
    }
  }
  return g_shared->procs[g_slice_slot];
}

// A process that exits leaves the card, as NVML stops listing it.
__attribute__((destructor)) void LeaveSlicedCard() {
  if (g_slice_slot < 0) return;
  ChipLock lock;
  AdvanceLocked(NowNs());
  g_shared->procs[g_slice_slot].pid = 0;
}

CUresult SubmitSliced(uint64_t exec_ns, uint64_t* seq_out = nullptr) {
  for (;;) {
    {
      ChipLock lock;
      uint64_t now = NowNs();
      AdvanceLocked(now);
      SliceProc& p = OwnSliceLocked();
      if (Pending(p) < kSliceRing) {
        uint64_t seq = ++p.next_seq;
        p.exec_ns[seq % kSliceRing] = exec_ns;
        p.ready_ns[seq % kSliceRing] =
            Pending(p) == 1 ? now + LatencyNs() : now;
        if (Pending(p) == 1) p.head_left_ns = exec_ns;
        if (seq_out) *seq_out = seq;
        return CUDA_SUCCESS;
      }
    }
    usleep(100);  // the queue is full: wait for the card
  }
}

bool SeqDoneSliced(uint64_t seq, uint64_t* at_ns,
                   uint64_t* busy_ns = nullptr) {
  ChipLock lock;
  AdvanceLocked(NowNs());
  SliceProc& p = OwnSliceLocked();
  if (p.done_seq < seq) return false;
  *at_ns = p.done_at_ns[seq % kSliceRing];
  if (busy_ns) *busy_ns = p.done_busy_ns[seq % kSliceRing];
  return true;
}

bool IdleSliced() {
  ChipLock lock;
  AdvanceLocked(NowNs());
  return Pending(OwnSliceLocked()) == 0;
}

// Sleeps to just short of `t`, then spins: a host wake-up late by a
// scheduler tick would read as device time the interposer never metered.
void SleepUntil(uint64_t t) {
  constexpr uint64_t kSpinNs = 200000;
  uint64_t now = NowNs();
  if (t > now + kSpinNs) {
    uint64_t d = t - now - kSpinNs;
    struct timespec ts = {(time_t)(d / 1000000000ull),
                          (long)(d % 1000000000ull)};
    nanosleep(&ts, nullptr);
  }
  while (NowNs() < t) {
  }
}

// Queues `exec_ns` of work: on an idle device it starts after the
// submission latency, else when the device frees up.
CUresult Submit(uint64_t exec_ns) {
  if (Sliced()) return SubmitSliced(exec_ns);
  std::lock_guard<std::mutex> lock(g_mu);
  if (g_shared) flock(g_shared_lock_fd, LOCK_EX);
  uint64_t now = NowNs();
  uint64_t device_free = g_shared ? g_shared->free_at_ns : g_free_at_ns;
  uint64_t start = device_free > now ? device_free : now + LatencyNs();
  g_free_at_ns = start + exec_ns;
  if (g_shared) {
    g_shared->free_at_ns = g_free_at_ns;
    g_shared->busy_ns += exec_ns;
    flock(g_shared_lock_fd, LOCK_UN);
  }
  return CUDA_SUCCESS;
}

// The capture a call on `stream` meets: its own capture (`captured`), or
// the legacy stream during a global-mode capture (`implicit`). Caller holds
// g_mu.
bool CapturedLocked(CUstream stream) {
  return g_capture.active && stream != nullptr && stream == g_capture.stream;
}

bool ImplicitLocked(CUstream stream) {
  return g_capture.active && stream == nullptr &&
         g_capture.mode == CU_STREAM_CAPTURE_MODE_GLOBAL;
}

// Whether the calling thread may not make a potentially unsafe call (an
// event query) now, by its own capture mode. Caller holds g_mu.
bool UnsafeProhibitedLocked() {
  if (!g_capture.active || t_capture_mode == CU_STREAM_CAPTURE_MODE_RELAXED)
    return false;
  bool mine = g_capture.owner == std::this_thread::get_id() &&
              g_capture.mode != CU_STREAM_CAPTURE_MODE_RELAXED;
  if (t_capture_mode == CU_STREAM_CAPTURE_MODE_THREAD_LOCAL) return mine;
  return mine || g_capture.mode == CU_STREAM_CAPTURE_MODE_GLOBAL;
}

// The function cuModuleGetFunction gives for any name: a kernel that runs
// no time (the interposer's idle probe loads such a module); the slice
// clock's two kernels are told apart by name.
CUfunction const kEmptyKernel = reinterpret_cast<CUfunction>(0xE0);
CUfunction const kWatchKernel = reinterpret_cast<CUfunction>(0xE1);
CUfunction const kStampKernel = reinterpret_cast<CUfunction>(0xE2);

// The slice clock's kernels, as the process sees their effects: a stamp
// waits for the card to reach it (its item, or the timeline's end), then
// writes [time, tag] into its words; a watch waits for the stop stamp of
// its tag. Guarded by g_mu.
struct ClockStamp {
  uint64_t seq = 0;  // sliced card: its item
  uint64_t at_ns = 0;  // FIFO timeline: when the card reaches it
  uint64_t* word = nullptr;
  uint64_t tag = 0;
};
struct ClockWatch {
  uint64_t* dev = nullptr;  // start stamp [tag, t], stop stamp [tag, t]
  uint64_t* rec = nullptr;  // [tag, start, gap, t0, t1, gaps, timed out]
  uint64_t tag = 0;
  uint64_t max_ns = 0;
  uint64_t start_ns = 0;
  bool active = false;
};
std::vector<ClockStamp> g_stamps;
std::map<uint64_t*, uint64_t> g_stamp_busy;  // a stamp's words -> busy ns
ClockWatch g_watch;

uint64_t Param(void** params, int i) {
  return params && params[i] ? *static_cast<uint64_t*>(params[i]) : 0;
}

// Writes what the card has reached of the slice clock's kernels. Caller
// holds g_mu.
void ApplyClockLocked() {
  size_t keep = 0;
  for (size_t i = 0; i < g_stamps.size(); i++) {
    ClockStamp& s = g_stamps[i];
    uint64_t at = s.at_ns, busy = 0;
    bool done = s.seq ? SeqDoneSliced(s.seq, &at, &busy) : NowNs() >= at;
    if (!done) {
      g_stamps[keep++] = s;
      continue;
    }
    // off the sliced card nothing else runs between two of a process's
    // items: the process's own time is the whole span
    g_stamp_busy[s.word] = s.seq ? busy : at;
    s.word[1] = at;
    __atomic_store_n(&s.word[0], s.tag, __ATOMIC_RELEASE);
  }
  g_stamps.resize(keep);
  ClockWatch& w = g_watch;
  if (!w.active) return;
  uint64_t* start = w.dev;
  uint64_t* stop = w.dev + 2;
  if (stop[0] == w.tag && start[0] == w.tag) {
    uint64_t t0 = start[1], t1 = stop[1];
    uint64_t own = std::min(g_stamp_busy[stop] - g_stamp_busy[start],
                            t1 - t0);
    uint64_t gap = t1 - t0 - own;
    w.rec[1] = w.start_ns;
    w.rec[2] = gap;
    w.rec[3] = t0;
    w.rec[4] = t1;
    w.rec[5] = gap > 0;
    w.rec[6] = 0;
  } else if (NowNs() - w.start_ns > w.max_ns) {
    w.rec[1] = w.start_ns;
    w.rec[6] = 1;
  } else {
    return;
  }
  __atomic_store_n(&w.rec[0], w.tag, __ATOMIC_RELEASE);
  w.active = false;
}

// A launch of the slice clock's kernels: not counted among the process's
// launches, and the watch takes no time of the card.
CUresult ClockLaunch(CUfunction f, void** params) {
  if (f == kWatchKernel) {
    std::lock_guard<std::mutex> lock(g_mu);
    g_watch = ClockWatch{reinterpret_cast<uint64_t*>(Param(params, 0)),
                         reinterpret_cast<uint64_t*>(Param(params, 1)),
                         Param(params, 2), Param(params, 4), NowNs(), true};
    return CUDA_SUCCESS;
  }
  ClockStamp s;
  s.word = reinterpret_cast<uint64_t*>(Param(params, 0));
  s.tag = Param(params, 1);
  if (!s.word) return CUDA_ERROR_INVALID_VALUE;
  if (Sliced()) {
    CUresult rc = SubmitSliced(0, &s.seq);
    if (rc != CUDA_SUCCESS) return rc;
  }
  std::lock_guard<std::mutex> lock(g_mu);
  if (!s.seq) s.at_ns = std::max(NowNs(), g_free_at_ns);
  g_stamps.push_back(s);
  return CUDA_SUCCESS;
}

CUresult Launch(CUstream stream, uint64_t nodes = 1,
                uint64_t exec_ns = ExecNs()) {
  {
    std::lock_guard<std::mutex> lock(g_mu);
    if (ImplicitLocked(stream)) {
      g_capture.invalidated = true;
      return CUDA_ERROR_STREAM_CAPTURE_IMPLICIT;
    }
    if (CapturedLocked(stream)) {
      g_capture.nodes += nodes;
      return CUDA_SUCCESS;
    }
    g_launches++;
  }
  return Submit(nodes * exec_ns);
}

// Allocations the fake does not tell apart from cuMemAlloc_v2.
CUresult AllocArray(uintptr_t* handle, uint64_t bytes) {
  if (!handle) return CUDA_ERROR_INVALID_VALUE;
  std::lock_guard<std::mutex> lock(g_mu);
  if (g_used + bytes > TotalMem()) return CUDA_ERROR_OUT_OF_MEMORY;
  *handle = g_next_array;
  g_next_array += 0x10;
  g_used += bytes;
  g_arrays[*handle] = bytes;
  return CUDA_SUCCESS;
}

CUresult FreeArray(uintptr_t handle) {
  std::lock_guard<std::mutex> lock(g_mu);
  auto it = g_arrays.find(handle);
  if (it == g_arrays.end()) return CUDA_ERROR_INVALID_VALUE;
  g_used -= it->second;
  g_arrays.erase(it);
  return CUDA_SUCCESS;
}

uint64_t FormatBytes(int format) {
  switch (format) {
    case CU_AD_FORMAT_UNSIGNED_INT8:
    case CU_AD_FORMAT_SIGNED_INT8:
      return 1;
    case CU_AD_FORMAT_UNSIGNED_INT16:
    case CU_AD_FORMAT_SIGNED_INT16:
    case CU_AD_FORMAT_HALF:
      return 2;
    default:
      return 4;
  }
}

uint64_t Extent(size_t n) { return n ? n : 1; }

thread_local int t_ctx_stack[8];
thread_local int t_ctx_depth = 0;

CUresult Alloc(CUdeviceptr* dptr, size_t bytes) {
  if (!dptr) return CUDA_ERROR_INVALID_VALUE;
  std::lock_guard<std::mutex> lock(g_mu);
  if (g_used + bytes > TotalMem()) return CUDA_ERROR_OUT_OF_MEMORY;
  *dptr = g_next_ptr;
  g_next_ptr += ((bytes + 255) / 256 + 1) * 256;
  g_used += bytes;
  g_ptrs[*dptr] = bytes;
  return CUDA_SUCCESS;
}

CUresult Free(CUdeviceptr dptr) {
  std::lock_guard<std::mutex> lock(g_mu);
  auto it = g_ptrs.find(dptr);
  if (it == g_ptrs.end()) return CUDA_ERROR_INVALID_VALUE;
  g_used -= it->second;
  g_ptrs.erase(it);
  return CUDA_SUCCESS;
}

}  // namespace

FAKE_EXPORT CUresult cuInit(unsigned) { return CUDA_SUCCESS; }

FAKE_EXPORT CUresult cuCtxGetDevice(CUdevice* dev) {
  *dev = t_ctx_depth > 0 ? t_ctx_stack[t_ctx_depth - 1] : 0;
  return CUDA_SUCCESS;
}

FAKE_EXPORT CUresult cuStreamGetCtx(CUstream stream, CUcontext* ctx) {
  *ctx = reinterpret_cast<CUcontext>(0x100 +
                                     (((uintptr_t)stream >> 12) & 0xF));
  return CUDA_SUCCESS;
}

FAKE_EXPORT CUresult cuCtxPushCurrent_v2(CUcontext ctx) {
  if (t_ctx_depth >= 8) return CUDA_ERROR_INVALID_VALUE;
  t_ctx_stack[t_ctx_depth++] = (int)((uintptr_t)ctx - 0x100);
  return CUDA_SUCCESS;
}

FAKE_EXPORT CUresult cuCtxPopCurrent_v2(CUcontext* ctx) {
  if (t_ctx_depth == 0) return CUDA_ERROR_INVALID_VALUE;
  int dev = t_ctx_stack[--t_ctx_depth];
  if (ctx) *ctx = reinterpret_cast<CUcontext>(0x100 + dev);
  return CUDA_SUCCESS;
}

FAKE_EXPORT CUresult cuLaunchKernel(CUfunction f, unsigned, unsigned,
                                    unsigned, unsigned, unsigned, unsigned,
                                    unsigned, CUstream stream, void** params,
                                    void**) {
  if (f == kWatchKernel || f == kStampKernel) return ClockLaunch(f, params);
  return Launch(stream, 1, f == kEmptyKernel ? 0 : ExecNs());
}

FAKE_EXPORT CUresult cuModuleLoadData(CUmodule* module, const void* image) {
  if (!module || !image) return CUDA_ERROR_INVALID_VALUE;
  *module = reinterpret_cast<CUmodule>(0xD0);
  return CUDA_SUCCESS;
}

FAKE_EXPORT CUresult cuModuleGetFunction(CUfunction* f, CUmodule module,
                                         const char* name) {
  if (!f || !module) return CUDA_ERROR_INVALID_VALUE;
  *f = !name                                   ? kEmptyKernel
       : strcmp(name, "vtpu_slice_watch") == 0 ? kWatchKernel
       : strcmp(name, "vtpu_slice_stamp") == 0 ? kStampKernel
                                               : kEmptyKernel;
  return CUDA_SUCCESS;
}

FAKE_EXPORT CUresult cuStreamCreate(CUstream* stream, unsigned) {
  if (!stream) return CUDA_ERROR_INVALID_VALUE;
  std::lock_guard<std::mutex> lock(g_mu);
  static uintptr_t next = 0x800;  // device 0 (bits 12-15)
  *stream = reinterpret_cast<CUstream>(next);
  next += 0x10;
  return CUDA_SUCCESS;
}

// The shared card's layout, for a test that reads the state file itself:
// sizeof(SharedChip), offsetof(SharedChip, busy_ns), offsetof(SharedChip,
// procs), sizeof(SliceProc), offsetof(SliceProc, pid), offsetof(SliceProc,
// busy_ns), kSliceProcs. Returns how many there are.
FAKE_EXPORT int fake_slice_layout(uint64_t* out, int n) {
  const uint64_t v[] = {sizeof(SharedChip), offsetof(SharedChip, busy_ns),
                        offsetof(SharedChip, procs), sizeof(SliceProc),
                        offsetof(SliceProc, pid), offsetof(SliceProc, busy_ns),
                        kSliceProcs};
  const int count = (int)(sizeof(v) / sizeof(v[0]));
  for (int i = 0; out && i < n && i < count; i++) out[i] = v[i];
  return count;
}

FAKE_EXPORT CUresult cuLaunchKernel_ptsz(CUfunction, unsigned, unsigned,
                                         unsigned, unsigned, unsigned,
                                         unsigned, unsigned, CUstream stream,
                                         void**, void**) {
  return Launch(stream);
}

FAKE_EXPORT CUresult cuLaunchKernelEx(const CUlaunchConfig* config,
                                      CUfunction, void**, void**) {
  return Launch(config ? config->hStream : nullptr);
}

FAKE_EXPORT CUresult cuLaunchKernelEx_ptsz(const CUlaunchConfig* config,
                                           CUfunction, void**, void**) {
  return Launch(config ? config->hStream : nullptr);
}

FAKE_EXPORT CUresult cuLaunchCooperativeKernel(CUfunction, unsigned, unsigned,
                                               unsigned, unsigned, unsigned,
                                               unsigned, unsigned,
                                               CUstream stream, void**) {
  {
    std::lock_guard<std::mutex> lock(g_mu);
    g_coop_launches++;
  }
  return Launch(stream);
}

FAKE_EXPORT CUresult cuLaunchCooperativeKernel_ptsz(
    CUfunction, unsigned, unsigned, unsigned, unsigned, unsigned, unsigned,
    unsigned, CUstream stream, void**) {
  {
    std::lock_guard<std::mutex> lock(g_mu);
    g_coop_launches++;
  }
  return Launch(stream);
}

FAKE_EXPORT CUresult cuLaunchCooperativeKernelMultiDevice(
    CUDA_LAUNCH_PARAMS* list, unsigned n, unsigned) {
  for (unsigned i = 0; i < n; i++) {
    {
      std::lock_guard<std::mutex> lock(g_mu);
      g_coop_launches++;
    }
    CUresult rc = Launch(list[i].hStream);
    if (rc != CUDA_SUCCESS) return rc;
  }
  return CUDA_SUCCESS;
}

FAKE_EXPORT CUresult cuStreamBeginCapture_v2(CUstream stream,
                                             CUstreamCaptureMode mode) {
  std::lock_guard<std::mutex> lock(g_mu);
  if (stream == nullptr || g_capture.active)
    return CUDA_ERROR_STREAM_CAPTURE_UNSUPPORTED;
  g_capture = FakeCapture{stream, mode, true, false, 0,
                          std::this_thread::get_id()};
  return CUDA_SUCCESS;
}

FAKE_EXPORT CUresult cuThreadExchangeStreamCaptureMode(
    CUstreamCaptureMode* mode) {
  int prev = t_capture_mode;
  t_capture_mode = *mode;
  *mode = (CUstreamCaptureMode)prev;
  return CUDA_SUCCESS;
}

FAKE_EXPORT CUresult cuStreamEndCapture(CUstream stream, CUgraph* graph) {
  std::lock_guard<std::mutex> lock(g_mu);
  if (!CapturedLocked(stream)) return CUDA_ERROR_INVALID_VALUE;
  bool bad = g_capture.invalidated;
  uint64_t nodes = g_capture.nodes;
  g_capture = FakeCapture{};
  if (bad) {
    *graph = nullptr;
    return CUDA_ERROR_STREAM_CAPTURE_INVALIDATED;
  }
  *graph = reinterpret_cast<CUgraph>(new FakeGraph{nodes});
  return CUDA_SUCCESS;
}

FAKE_EXPORT CUresult cuGraphInstantiateWithFlags(CUgraphExec* exec,
                                                 CUgraph graph,
                                                 unsigned long long) {
  if (!graph) return CUDA_ERROR_INVALID_VALUE;
  *exec = reinterpret_cast<CUgraphExec>(
      new FakeGraph{reinterpret_cast<FakeGraph*>(graph)->nodes});
  return CUDA_SUCCESS;
}

FAKE_EXPORT CUresult cuGraphDestroy(CUgraph graph) {
  delete reinterpret_cast<FakeGraph*>(graph);
  return CUDA_SUCCESS;
}

FAKE_EXPORT CUresult cuGraphExecDestroy(CUgraphExec exec) {
  delete reinterpret_cast<FakeGraph*>(exec);
  return CUDA_SUCCESS;
}

CUresult GraphLaunch(CUgraphExec exec, CUstream stream) {
  if (!exec) return CUDA_ERROR_INVALID_VALUE;
  {
    std::lock_guard<std::mutex> lock(g_mu);
    g_graph_launches++;
  }
  return Launch(stream, reinterpret_cast<FakeGraph*>(exec)->nodes);
}

FAKE_EXPORT CUresult cuGraphLaunch(CUgraphExec exec, CUstream stream) {
  return GraphLaunch(exec, stream);
}

FAKE_EXPORT CUresult cuGraphLaunch_ptsz(CUgraphExec exec, CUstream stream) {
  return GraphLaunch(exec, stream);
}

FAKE_EXPORT CUresult cuStreamSynchronize(CUstream) {
  if (Sliced()) {
    while (!IdleSliced()) usleep(50);
  } else {
    uint64_t t;
    {
      std::lock_guard<std::mutex> lock(g_mu);
      t = g_free_at_ns;
    }
    SleepUntil(t);
  }
  std::lock_guard<std::mutex> lock(g_mu);
  ApplyClockLocked();
  return CUDA_SUCCESS;
}

FAKE_EXPORT CUresult cuCtxSynchronize() { return cuStreamSynchronize(nullptr); }

FAKE_EXPORT CUresult cuStreamQuery(CUstream stream) {
  std::lock_guard<std::mutex> lock(g_mu);
  if (CapturedLocked(stream) || ImplicitLocked(stream)) {
    g_capture.invalidated = true;
    return CapturedLocked(stream) ? CUDA_ERROR_STREAM_CAPTURE_UNSUPPORTED
                                  : CUDA_ERROR_STREAM_CAPTURE_IMPLICIT;
  }
  if (Sliced()) return IdleSliced() ? CUDA_SUCCESS : CUDA_ERROR_NOT_READY;
  return NowNs() >= g_free_at_ns ? CUDA_SUCCESS : CUDA_ERROR_NOT_READY;
}

FAKE_EXPORT CUresult cuMemAllocHost_v2(void** pp, size_t bytes) {
  *pp = calloc(1, bytes ? bytes : 1);
  return *pp ? CUDA_SUCCESS : CUDA_ERROR_OUT_OF_MEMORY;
}

FAKE_EXPORT CUresult cuMemsetD32Async(CUdeviceptr, unsigned, size_t,
                                      CUstream) {
  return Submit(0);
}

FAKE_EXPORT CUresult cuStreamIsCapturing(CUstream stream,
                                         CUstreamCaptureStatus* s) {
  std::lock_guard<std::mutex> lock(g_mu);
  if (ImplicitLocked(stream)) {
    g_capture.invalidated = true;
    return CUDA_ERROR_STREAM_CAPTURE_IMPLICIT;
  }
  *s = !CapturedLocked(stream) ? CU_STREAM_CAPTURE_STATUS_NONE
       : g_capture.invalidated ? CU_STREAM_CAPTURE_STATUS_INVALIDATED
                               : CU_STREAM_CAPTURE_STATUS_ACTIVE;
  return CUDA_SUCCESS;
}

FAKE_EXPORT CUresult cuEventCreate(CUevent* ev, unsigned) {
  *ev = reinterpret_cast<CUevent>(new FakeEvent());
  return CUDA_SUCCESS;
}

FAKE_EXPORT CUresult cuEventDestroy_v2(CUevent ev) {
  delete reinterpret_cast<FakeEvent*>(ev);
  return CUDA_SUCCESS;
}

FAKE_EXPORT CUresult cuEventRecord(CUevent ev, CUstream stream) {
  std::lock_guard<std::mutex> lock(g_mu);
  if (CapturedLocked(stream) || ImplicitLocked(stream)) {
    g_capture.invalidated = true;
    return CUDA_ERROR_STREAM_CAPTURE_UNSUPPORTED;
  }
  auto* e = reinterpret_cast<FakeEvent*>(ev);
  e->recorded = true;
  e->seq = 0;
  if (Sliced() && !LyingEvents()) {
    // stamped when the process's work queued so far has run
    ChipLock chip;
    uint64_t now = NowNs();
    AdvanceLocked(now);
    SliceProc& p = OwnSliceLocked();
    e->at_ns = now;
    if (Pending(p) > 0) e->seq = p.next_seq;
    return CUDA_SUCCESS;
  }
  e->at_ns = LyingEvents() ? NowNs() : std::max(NowNs(), g_free_at_ns);
  return CUDA_SUCCESS;
}

// Whether the event has its time stamp; a sliced card's pending event
// takes its item's finish time once that has run.
bool EventDone(FakeEvent* e) {
  if (e->seq != 0) {
    if (!SeqDoneSliced(e->seq, &e->at_ns)) return false;
    e->seq = 0;
  }
  return NowNs() >= e->at_ns;
}

FAKE_EXPORT CUresult cuEventQuery(CUevent ev) {
  {
    // a potentially unsafe call the thread's capture mode prohibits
    std::lock_guard<std::mutex> lock(g_mu);
    if (UnsafeProhibitedLocked()) {
      g_capture.invalidated = true;
      return CUDA_ERROR_STREAM_CAPTURE_UNSUPPORTED;
    }
  }
  bool done = EventDone(reinterpret_cast<FakeEvent*>(ev));
  {
    std::lock_guard<std::mutex> lock(g_mu);
    ApplyClockLocked();
  }
  return done ? CUDA_SUCCESS : CUDA_ERROR_NOT_READY;
}

FAKE_EXPORT CUresult cuEventElapsedTime(float* ms, CUevent a, CUevent b) {
  auto* ea = reinterpret_cast<FakeEvent*>(a);
  auto* eb = reinterpret_cast<FakeEvent*>(b);
  if (!ea->recorded || !eb->recorded) return CUDA_ERROR_INVALID_VALUE;
  if ((ea->seq && !EventDone(ea)) || (eb->seq && !EventDone(eb)))
    return CUDA_ERROR_NOT_READY;
  *ms = (float)((double)(eb->at_ns - ea->at_ns) / 1e6);
  return CUDA_SUCCESS;
}

FAKE_EXPORT CUresult cuMemAlloc_v2(CUdeviceptr* dptr, size_t bytes) {
  return Alloc(dptr, bytes);
}

FAKE_EXPORT CUresult cuMemAllocAsync(CUdeviceptr* dptr, size_t bytes,
                                     CUstream) {
  return Alloc(dptr, bytes);
}

FAKE_EXPORT CUresult cuMemAllocAsync_ptsz(CUdeviceptr* dptr, size_t bytes,
                                          CUstream) {
  return Alloc(dptr, bytes);
}

FAKE_EXPORT CUresult cuMemAllocPitch_v2(CUdeviceptr* dptr, size_t* pitch,
                                        size_t width, size_t height,
                                        unsigned) {
  if (!pitch) return CUDA_ERROR_INVALID_VALUE;
  *pitch = (width + 511) / 512 * 512;
  return Alloc(dptr, *pitch * height);
}

FAKE_EXPORT CUresult cuMemAllocManaged(CUdeviceptr* dptr, size_t bytes,
                                       unsigned) {
  return Alloc(dptr, bytes);
}

FAKE_EXPORT CUresult cuDeviceGetDefaultMemPool(CUmemoryPool* pool,
                                               CUdevice dev) {
  *pool = reinterpret_cast<CUmemoryPool>(0x5000 + dev);
  return CUDA_SUCCESS;
}

FAKE_EXPORT CUresult cuMemAllocFromPoolAsync(CUdeviceptr* dptr, size_t bytes,
                                             CUmemoryPool, CUstream) {
  return Alloc(dptr, bytes);
}

FAKE_EXPORT CUresult cuMemAllocFromPoolAsync_ptsz(CUdeviceptr* dptr,
                                                  size_t bytes, CUmemoryPool,
                                                  CUstream) {
  return Alloc(dptr, bytes);
}

FAKE_EXPORT CUresult cuArrayCreate_v2(CUarray* array,
                                      const CUDA_ARRAY_DESCRIPTOR* d) {
  return AllocArray(reinterpret_cast<uintptr_t*>(array),
                    d->Width * Extent(d->Height) * d->NumChannels *
                        FormatBytes(d->Format));
}

FAKE_EXPORT CUresult cuArray3DCreate_v2(CUarray* array,
                                        const CUDA_ARRAY3D_DESCRIPTOR* d) {
  return AllocArray(reinterpret_cast<uintptr_t*>(array),
                    d->Width * Extent(d->Height) * Extent(d->Depth) *
                        d->NumChannels * FormatBytes(d->Format));
}

FAKE_EXPORT CUresult cuMipmappedArrayCreate(CUmipmappedArray* array,
                                            const CUDA_ARRAY3D_DESCRIPTOR* d,
                                            unsigned levels) {
  uint64_t bytes = 0;
  for (unsigned l = 0; l < levels; l++) {
    auto at = [l](size_t n) { return n ? std::max<size_t>(1, n >> l) : 0; };
    bytes += at(d->Width) * Extent(at(d->Height)) * Extent(at(d->Depth)) *
             d->NumChannels * FormatBytes(d->Format);
  }
  return AllocArray(reinterpret_cast<uintptr_t*>(array), bytes);
}

FAKE_EXPORT CUresult cuArrayDestroy(CUarray array) {
  return FreeArray(reinterpret_cast<uintptr_t>(array));
}

FAKE_EXPORT CUresult cuMipmappedArrayDestroy(CUmipmappedArray array) {
  return FreeArray(reinterpret_cast<uintptr_t>(array));
}

FAKE_EXPORT CUresult cuMemFree_v2(CUdeviceptr dptr) { return Free(dptr); }

FAKE_EXPORT CUresult cuMemFreeAsync(CUdeviceptr dptr, CUstream) {
  return Free(dptr);
}

FAKE_EXPORT CUresult cuMemFreeAsync_ptsz(CUdeviceptr dptr, CUstream) {
  return Free(dptr);
}

FAKE_EXPORT CUresult cuMemCreate(CUmemGenericAllocationHandle* handle,
                                 size_t bytes, const CUmemAllocationProp*,
                                 unsigned long long) {
  std::lock_guard<std::mutex> lock(g_mu);
  if (g_used + bytes > TotalMem()) return CUDA_ERROR_OUT_OF_MEMORY;
  *handle = g_next_handle++;
  g_used += bytes;
  g_handles[*handle] = bytes;
  return CUDA_SUCCESS;
}

FAKE_EXPORT CUresult cuMemRelease(CUmemGenericAllocationHandle handle) {
  std::lock_guard<std::mutex> lock(g_mu);
  auto it = g_handles.find(handle);
  if (it == g_handles.end()) return CUDA_ERROR_INVALID_VALUE;
  g_used -= it->second;
  g_handles.erase(it);
  return CUDA_SUCCESS;
}

FAKE_EXPORT CUresult cuMemGetInfo_v2(size_t* free_bytes, size_t* total) {
  std::lock_guard<std::mutex> lock(g_mu);
  *total = TotalMem();
  *free_bytes = TotalMem() - g_used;
  return CUDA_SUCCESS;
}

FAKE_EXPORT CUresult cuDeviceTotalMem_v2(size_t* bytes, CUdevice) {
  *bytes = TotalMem();
  return CUDA_SUCCESS;
}

FAKE_EXPORT CUresult cuGetProcAddress(const char* symbol, void** pfn,
                                      int version, cuuint64_t flags);

FAKE_EXPORT CUresult cuGetProcAddress_v2(const char* symbol, void** pfn,
                                         int version, cuuint64_t flags,
                                         CUdriverProcAddressQueryResult* st);

// The fake's own address for `name`, and the one cuGetProcAddress gives for
// a (name, version, flags) query, following the CUDA 12 variant rules.
FAKE_EXPORT void* fake_real_address(const char* name) {
  struct Entry {
    const char* name;
    void* fn;
  };
  static const Entry kTable[] = {
      {"cuInit", (void*)&cuInit},
      {"cuCtxGetDevice", (void*)&cuCtxGetDevice},
      {"cuStreamGetCtx", (void*)&cuStreamGetCtx},
      {"cuCtxPushCurrent_v2", (void*)&cuCtxPushCurrent_v2},
      {"cuCtxPopCurrent_v2", (void*)&cuCtxPopCurrent_v2},
      {"cuLaunchCooperativeKernel", (void*)&cuLaunchCooperativeKernel},
      {"cuLaunchCooperativeKernel_ptsz",
       (void*)&cuLaunchCooperativeKernel_ptsz},
      {"cuLaunchCooperativeKernelMultiDevice",
       (void*)&cuLaunchCooperativeKernelMultiDevice},
      {"cuStreamBeginCapture_v2", (void*)&cuStreamBeginCapture_v2},
      {"cuStreamEndCapture", (void*)&cuStreamEndCapture},
      {"cuThreadExchangeStreamCaptureMode",
       (void*)&cuThreadExchangeStreamCaptureMode},
      {"cuGraphInstantiateWithFlags", (void*)&cuGraphInstantiateWithFlags},
      {"cuGraphDestroy", (void*)&cuGraphDestroy},
      {"cuGraphExecDestroy", (void*)&cuGraphExecDestroy},
      {"cuGraphLaunch", (void*)&cuGraphLaunch},
      {"cuGraphLaunch_ptsz", (void*)&cuGraphLaunch_ptsz},
      {"cuMemAllocPitch_v2", (void*)&cuMemAllocPitch_v2},
      {"cuMemAllocManaged", (void*)&cuMemAllocManaged},
      {"cuDeviceGetDefaultMemPool", (void*)&cuDeviceGetDefaultMemPool},
      {"cuMemAllocFromPoolAsync", (void*)&cuMemAllocFromPoolAsync},
      {"cuMemAllocFromPoolAsync_ptsz", (void*)&cuMemAllocFromPoolAsync_ptsz},
      {"cuArrayCreate_v2", (void*)&cuArrayCreate_v2},
      {"cuArray3DCreate_v2", (void*)&cuArray3DCreate_v2},
      {"cuMipmappedArrayCreate", (void*)&cuMipmappedArrayCreate},
      {"cuArrayDestroy", (void*)&cuArrayDestroy},
      {"cuMipmappedArrayDestroy", (void*)&cuMipmappedArrayDestroy},
      {"cuLaunchKernel", (void*)&cuLaunchKernel},
      {"cuModuleLoadData", (void*)&cuModuleLoadData},
      {"cuModuleGetFunction", (void*)&cuModuleGetFunction},
      {"cuStreamCreate", (void*)&cuStreamCreate},
      {"cuLaunchKernel_ptsz", (void*)&cuLaunchKernel_ptsz},
      {"cuLaunchKernelEx", (void*)&cuLaunchKernelEx},
      {"cuLaunchKernelEx_ptsz", (void*)&cuLaunchKernelEx_ptsz},
      {"cuStreamSynchronize", (void*)&cuStreamSynchronize},
      {"cuCtxSynchronize", (void*)&cuCtxSynchronize},
      {"cuStreamIsCapturing", (void*)&cuStreamIsCapturing},
      {"cuStreamQuery", (void*)&cuStreamQuery},
      {"cuMemsetD32Async", (void*)&cuMemsetD32Async},
      {"cuMemAllocHost_v2", (void*)&cuMemAllocHost_v2},
      {"cuEventCreate", (void*)&cuEventCreate},
      {"cuEventDestroy_v2", (void*)&cuEventDestroy_v2},
      {"cuEventRecord", (void*)&cuEventRecord},
      {"cuEventQuery", (void*)&cuEventQuery},
      {"cuEventElapsedTime", (void*)&cuEventElapsedTime},
      {"cuMemAlloc_v2", (void*)&cuMemAlloc_v2},
      {"cuMemAllocAsync", (void*)&cuMemAllocAsync},
      {"cuMemAllocAsync_ptsz", (void*)&cuMemAllocAsync_ptsz},
      {"cuMemFree_v2", (void*)&cuMemFree_v2},
      {"cuMemFreeAsync", (void*)&cuMemFreeAsync},
      {"cuMemFreeAsync_ptsz", (void*)&cuMemFreeAsync_ptsz},
      {"cuMemCreate", (void*)&cuMemCreate},
      {"cuMemRelease", (void*)&cuMemRelease},
      {"cuMemGetInfo_v2", (void*)&cuMemGetInfo_v2},
      {"cuDeviceTotalMem_v2", (void*)&cuDeviceTotalMem_v2},
      {"cuGetProcAddress", (void*)&cuGetProcAddress},
      {"cuGetProcAddress_v2", (void*)&cuGetProcAddress_v2},
  };
  for (const Entry& e : kTable)
    if (strcmp(e.name, name) == 0) return e.fn;
  return nullptr;
}

FAKE_EXPORT CUresult cuGetProcAddress_v2(const char* symbol, void** pfn,
                                         int version, cuuint64_t flags,
                                         CUdriverProcAddressQueryResult* st) {
  static const char* kPtsz[] = {
      "cuLaunchKernel",  "cuLaunchKernelEx",          "cuMemAllocAsync",
      "cuMemFreeAsync",  "cuLaunchCooperativeKernel", "cuGraphLaunch",
      "cuMemAllocFromPoolAsync"};
  static const char* kV2[] = {
      "cuMemAlloc",       "cuMemFree",     "cuMemGetInfo",
      "cuDeviceTotalMem", "cuEventDestroy", "cuMemAllocPitch",
      "cuArrayCreate",    "cuArray3DCreate", "cuCtxPushCurrent",
      "cuCtxPopCurrent",  "cuStreamBeginCapture"};
  char name[128];
  strncpy(name, symbol, sizeof(name) - 16);
  name[sizeof(name) - 16] = '\0';
  if (flags & CU_GET_PROC_ADDRESS_PER_THREAD_DEFAULT_STREAM)
    for (const char* p : kPtsz)
      if (strcmp(p, symbol) == 0) strcat(name, "_ptsz");
  if (version >= 3020)
    for (const char* v : kV2)
      if (strcmp(v, symbol) == 0) strcat(name, "_v2");
  if (strcmp(symbol, "cuGetProcAddress") == 0 && version >= 12000)
    strcat(name, "_v2");
  *pfn = fake_real_address(name);
  if (st) *st = *pfn ? 0 : 1;
  return *pfn ? CUDA_SUCCESS : CUDA_ERROR_NOT_FOUND;
}

FAKE_EXPORT CUresult cuGetProcAddress(const char* symbol, void** pfn,
                                      int version, cuuint64_t flags) {
  return cuGetProcAddress_v2(symbol, pfn, version, flags, nullptr);
}

FAKE_EXPORT uint64_t fake_launches_total() {
  std::lock_guard<std::mutex> lock(g_mu);
  return g_launches;
}

FAKE_EXPORT uint64_t fake_graph_launches_total() {
  std::lock_guard<std::mutex> lock(g_mu);
  return g_graph_launches;
}

FAKE_EXPORT uint64_t fake_cooperative_launches_total() {
  std::lock_guard<std::mutex> lock(g_mu);
  return g_coop_launches;
}

FAKE_EXPORT uint64_t fake_used_bytes() {
  std::lock_guard<std::mutex> lock(g_mu);
  return g_used;
}
