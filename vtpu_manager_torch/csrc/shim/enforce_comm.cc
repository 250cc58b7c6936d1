// enforce_comm.cc — communication accounting (CommTelemetry).
//
// Ports library/src/enforce.cc's measured-communication accumulators
// (CommTelemetryArmed:753, AccumulateComm:767, the exports :2359-2370 and
// the step ring's comm block :2438-2444) to the driver API. Armed once by
// VTPU_COMM_TELEMETRY=true; unarmed, every hook below costs one branch,
// the ring's comm block stays zeros and the exports read 0.
//
// What is counted, beside the reference's PJRT sources:
//   - transfers between host and card: the copy entries that torch's
//     copy_, .to() and pinned staging reach through the runtime (the
//     driver's cuMemcpyHtoD / DtoH, their asynchronous forms, the per-thread
//     default stream forms, and the unified cuMemcpy / cuMemcpyAsync, whose
//     direction cuPointerGetAttribute tells). Bytes at the call, as the
//     reference counts a host-to-card payload (enforce.cc:930-932) and a
//     card-to-host copy's (enforce.cc:3215-3227). A blocking copy's span is
//     its wall; an asynchronous one's is two events around it on its
//     stream, read back later without waiting, unless the stream is being
//     captured: then bytes alone, since an event recorded on a capturing
//     stream would invalidate the capture. Card-to-card copies, and host
//     to host, are not counted (the reference counts none);
//   - collectives: a kernel launch whose function is NCCL's (named by
//     cuFuncGetName, or cuKernelGetName for a CUkernel handle; the verdict
//     is cached per handle) counts one collective and its span, from events
//     as above. The reference counts a measured multi-chip execution
//     (enforce.cc:2711-2723). A collective's payload is not visible at the
//     driver API, so it adds no bytes (the reference adds the multi-chip
//     executable's output, enforce.cc:3162-3166). A graph replay is not
//     looked into.
// Every tenant is accounted, throttled or not. The windows are exchanged
// to 0 into each step-ring record the interposer writes; the totals are
// exported for the Python writer, which charges each of its records the
// deltas.

#include <string.h>

#include <cstdio>
#include <cstdlib>
#include <mutex>
#include <string>
#include <unordered_map>
#include <vector>

#include "shim.h"

namespace vtpu_cuda {

namespace {

constexpr size_t kMaxCommPending = 1024;

std::atomic<uint64_t> g_comm_time_window_ns{0};
std::atomic<uint64_t> g_comm_bytes_window{0};
std::atomic<uint32_t> g_collectives_window{0};
std::atomic<uint64_t> g_comm_time_ns_total{0};
std::atomic<uint64_t> g_comm_bytes_total{0};
std::atomic<uint64_t> g_collectives_total{0};

std::mutex g_comm_mu;  // the pending spans, the event pool, the names
std::vector<CommBracket> g_comm_pending;
std::vector<CUevent> g_comm_events;
std::unordered_map<const void*, bool> g_nccl;  // per handle: NCCL's kernel?

using PFN_cuPointerGetAttribute = CUresult (*)(void*, int, CUdeviceptr);
using PFN_cuFuncGetName = CUresult (*)(const char**, const void*);

constexpr int kPointerAttributeMemoryType = 2;  // CU_POINTER_ATTRIBUTE_...
constexpr unsigned kMemoryTypeDevice = 2;       // CU_MEMORYTYPE_DEVICE
constexpr unsigned kMemoryTypeArray = 3;

enum Direction { kUncounted, kToCard, kToHost };

CUevent TakeCommEventLocked() {
  if (!g_comm_events.empty()) {
    CUevent ev = g_comm_events.back();
    g_comm_events.pop_back();
    return ev;
  }
  auto create = VTPU_REAL_AS(PFN_cuEventCreate, "cuEventCreate");
  CUevent ev = nullptr;
  if (!create || create(&ev, CU_EVENT_DEFAULT) != CUDA_SUCCESS) return nullptr;
  return ev;
}

void GiveCommEventsLocked(const CommBracket& b) {
  if (b.start) g_comm_events.push_back(b.start);
  if (b.end) g_comm_events.push_back(b.end);
}

// Adds the spans whose end event has been reached. Caller holds
// g_comm_mu and runs in the relaxed capture mode.
void DrainCommLocked() {
  auto query = VTPU_REAL_AS(PFN_cuEventQuery, "cuEventQuery");
  auto elapsed = VTPU_REAL_AS(PFN_cuEventElapsedTime, "cuEventElapsedTime");
  if (!query || !elapsed) return;
  size_t keep = 0;
  for (const CommBracket& b : g_comm_pending) {
    CUresult rc = query(b.end);
    if (rc == CUDA_ERROR_NOT_READY) {
      g_comm_pending[keep++] = b;
      continue;
    }
    float ms = 0.f;
    if (rc == CUDA_SUCCESS &&
        elapsed(&ms, b.start, b.end) == CUDA_SUCCESS && ms > 0.f)
      AccumulateComm((uint64_t)(ms * 1e6), 0, false);
    GiveCommEventsLocked(b);
  }
  g_comm_pending.resize(keep);
}

// Whether a device pointer names the card's memory (a host pointer the
// driver does not know is the host's).
bool OnCard(CUdeviceptr p) {
  auto get = VTPU_REAL_AS(PFN_cuPointerGetAttribute, "cuPointerGetAttribute");
  unsigned type = 0;
  return get && get(&type, kPointerAttributeMemoryType, p) == CUDA_SUCCESS &&
         (type == kMemoryTypeDevice || type == kMemoryTypeArray);
}

Direction Unified(CUdeviceptr dst, CUdeviceptr src) {
  bool to = OnCard(dst), from = OnCard(src);
  return to == from ? kUncounted : to ? kToCard : kToHost;
}

// The copy entries, by the bit FIRST_USE sets for each.
const char* const kEntries[] = {
    "cuMemcpyHtoD_v2",      "cuMemcpyHtoD_v2_ptds",
    "cuMemcpyDtoH_v2",      "cuMemcpyDtoH_v2_ptds",
    "cuMemcpyHtoDAsync_v2", "cuMemcpyHtoDAsync_v2_ptsz",
    "cuMemcpyDtoHAsync_v2", "cuMemcpyDtoHAsync_v2_ptsz",
    "cuMemcpy",             "cuMemcpy_ptds",
    "cuMemcpyAsync",        "cuMemcpyAsync_ptsz"};
std::atomic<uint32_t> g_entries_used{0};

// Which entries a tenant's runtime reached, logged once each.
void FirstUse(int entry) {
  uint32_t bit = 1u << entry;
  if (!(g_entries_used.fetch_or(bit, std::memory_order_relaxed) & bit))
    Log(kLogInfo, "copy entry %s in use", kEntries[entry]);
}

// A blocking copy: its bytes and its wall.
template <typename Copy>
CUresult Blocking(Direction dir, size_t bytes, Copy copy) {
  if (!CommArmed() || dir == kUncounted) return copy();
  uint64_t t0 = NowNs();
  CUresult rc = copy();
  if (rc == CUDA_SUCCESS) AccumulateComm(NowNs() - t0, bytes, false);
  return rc;
}

// An asynchronous copy on `stream` (a null stream of a _ptsz entry is the
// per-thread default stream): its bytes, and its span from events.
template <typename Copy>
CUresult Async(Direction dir, size_t bytes, CUstream stream, bool ptsz,
               Copy copy) {
  if (!CommArmed() || dir == kUncounted) return copy();
  if (ptsz && stream == nullptr) stream = CU_STREAM_PER_THREAD;
  CommBracket b = OpenComm(stream);
  CUresult rc = copy();
  CloseComm(b, rc == CUDA_SUCCESS, rc == CUDA_SUCCESS ? bytes : 0, false);
  return rc;
}

#define FIRST_USE(entry) \
  if (CommArmed()) FirstUse(entry)

}  // namespace

bool CommArmed() {
  static const bool armed = [] {
    const char* v = getenv("VTPU_COMM_TELEMETRY");
    return v && strcmp(v, "true") == 0;
  }();
  return armed;
}

void AccumulateComm(uint64_t span_ns, uint64_t bytes, bool collective) {
  if (!CommArmed()) return;
  if (span_ns) {
    g_comm_time_window_ns.fetch_add(span_ns, std::memory_order_relaxed);
    g_comm_time_ns_total.fetch_add(span_ns, std::memory_order_relaxed);
  }
  if (bytes) {
    g_comm_bytes_window.fetch_add(bytes, std::memory_order_relaxed);
    g_comm_bytes_total.fetch_add(bytes, std::memory_order_relaxed);
  }
  if (collective) {
    g_collectives_window.fetch_add(1, std::memory_order_relaxed);
    g_collectives_total.fetch_add(1, std::memory_order_relaxed);
  }
}

void DrainComm() {
  if (!CommArmed()) return;
  RelaxedCaptureMode relaxed;
  std::lock_guard<std::mutex> lock(g_comm_mu);
  DrainCommLocked();
}

CommWindow TakeCommWindow() {
  DrainComm();
  CommWindow w;
  w.time_ns = g_comm_time_window_ns.exchange(0, std::memory_order_relaxed);
  w.bytes = g_comm_bytes_window.exchange(0, std::memory_order_relaxed);
  w.collectives = g_collectives_window.exchange(0, std::memory_order_relaxed);
  return w;
}

bool IsCollective(const void* fn) {
  if (!CommArmed() || !fn) return false;
  std::lock_guard<std::mutex> lock(g_comm_mu);
  auto it = g_nccl.find(fn);
  if (it != g_nccl.end()) return it->second;
  auto func_name = VTPU_REAL_AS(PFN_cuFuncGetName, "cuFuncGetName");
  auto kernel_name = VTPU_REAL_AS(PFN_cuFuncGetName, "cuKernelGetName");
  const char* name = nullptr;
  if (!(func_name && func_name(&name, fn) == CUDA_SUCCESS && name) &&
      !(kernel_name && kernel_name(&name, fn) == CUDA_SUCCESS && name))
    name = nullptr;
  bool nccl = name && (strstr(name, "ncclKernel") ||
                       strstr(name, "ncclDevKernel"));
  if (nccl) Log(kLogInfo, "collective kernel %s", name);
  g_nccl.emplace(fn, nccl);
  return nccl;
}

CommBracket OpenComm(CUstream stream) {
  CommBracket b;
  b.stream = stream;
  RelaxedCaptureMode relaxed;
  if (Capturing(stream)) return b;  // bytes alone: the capture stays valid
  auto record = VTPU_REAL_AS(PFN_cuEventRecord, "cuEventRecord");
  std::lock_guard<std::mutex> lock(g_comm_mu);
  DrainCommLocked();
  if (!record || g_comm_pending.size() >= kMaxCommPending) return b;
  b.start = TakeCommEventLocked();
  b.end = TakeCommEventLocked();
  if (!b.start || !b.end || record(b.start, stream) != CUDA_SUCCESS) {
    GiveCommEventsLocked(b);
    b.start = b.end = nullptr;
  }
  return b;
}

void CloseComm(const CommBracket& b, bool ok, uint64_t bytes,
               bool collective) {
  if (ok) AccumulateComm(0, bytes, collective);
  if (!b.start) return;
  RelaxedCaptureMode relaxed;
  auto record = VTPU_REAL_AS(PFN_cuEventRecord, "cuEventRecord");
  std::lock_guard<std::mutex> lock(g_comm_mu);
  if (ok && record && record(b.end, b.stream) == CUDA_SUCCESS)
    g_comm_pending.push_back(b);
  else
    GiveCommEventsLocked(b);
}

}  // namespace vtpu_cuda

using namespace vtpu_cuda;

// The copy entries. Each calls the real driver's own entry.
VTPU_EXPORT CUresult cuMemcpyHtoD_v2(CUdeviceptr dst, const void* src,
                                     size_t bytes) {
  auto real = VTPU_REAL(cuMemcpyHtoD_v2);
  if (!real) return CUDA_ERROR_NOT_INITIALIZED;
  FIRST_USE(0);
  return Blocking(kToCard, bytes, [&] { return real(dst, src, bytes); });
}

VTPU_EXPORT CUresult cuMemcpyHtoD_v2_ptds(CUdeviceptr dst, const void* src,
                                          size_t bytes) {
  auto real = VTPU_REAL(cuMemcpyHtoD_v2_ptds);
  if (!real) return CUDA_ERROR_NOT_INITIALIZED;
  FIRST_USE(1);
  return Blocking(kToCard, bytes, [&] { return real(dst, src, bytes); });
}

VTPU_EXPORT CUresult cuMemcpyDtoH_v2(void* dst, CUdeviceptr src,
                                     size_t bytes) {
  auto real = VTPU_REAL(cuMemcpyDtoH_v2);
  if (!real) return CUDA_ERROR_NOT_INITIALIZED;
  FIRST_USE(2);
  return Blocking(kToHost, bytes, [&] { return real(dst, src, bytes); });
}

VTPU_EXPORT CUresult cuMemcpyDtoH_v2_ptds(void* dst, CUdeviceptr src,
                                          size_t bytes) {
  auto real = VTPU_REAL(cuMemcpyDtoH_v2_ptds);
  if (!real) return CUDA_ERROR_NOT_INITIALIZED;
  FIRST_USE(3);
  return Blocking(kToHost, bytes, [&] { return real(dst, src, bytes); });
}

VTPU_EXPORT CUresult cuMemcpyHtoDAsync_v2(CUdeviceptr dst, const void* src,
                                          size_t bytes, CUstream stream) {
  auto real = VTPU_REAL(cuMemcpyHtoDAsync_v2);
  if (!real) return CUDA_ERROR_NOT_INITIALIZED;
  FIRST_USE(4);
  return Async(kToCard, bytes, stream, false,
               [&] { return real(dst, src, bytes, stream); });
}

VTPU_EXPORT CUresult cuMemcpyHtoDAsync_v2_ptsz(CUdeviceptr dst,
                                               const void* src, size_t bytes,
                                               CUstream stream) {
  auto real = VTPU_REAL(cuMemcpyHtoDAsync_v2_ptsz);
  if (!real) return CUDA_ERROR_NOT_INITIALIZED;
  FIRST_USE(5);
  return Async(kToCard, bytes, stream, true,
               [&] { return real(dst, src, bytes, stream); });
}

VTPU_EXPORT CUresult cuMemcpyDtoHAsync_v2(void* dst, CUdeviceptr src,
                                          size_t bytes, CUstream stream) {
  auto real = VTPU_REAL(cuMemcpyDtoHAsync_v2);
  if (!real) return CUDA_ERROR_NOT_INITIALIZED;
  FIRST_USE(6);
  return Async(kToHost, bytes, stream, false,
               [&] { return real(dst, src, bytes, stream); });
}

VTPU_EXPORT CUresult cuMemcpyDtoHAsync_v2_ptsz(void* dst, CUdeviceptr src,
                                               size_t bytes,
                                               CUstream stream) {
  auto real = VTPU_REAL(cuMemcpyDtoHAsync_v2_ptsz);
  if (!real) return CUDA_ERROR_NOT_INITIALIZED;
  FIRST_USE(7);
  return Async(kToHost, bytes, stream, true,
               [&] { return real(dst, src, bytes, stream); });
}

VTPU_EXPORT CUresult cuMemcpy(CUdeviceptr dst, CUdeviceptr src,
                              size_t bytes) {
  auto real = VTPU_REAL(cuMemcpy);
  if (!real) return CUDA_ERROR_NOT_INITIALIZED;
  FIRST_USE(8);
  Direction dir = CommArmed() ? Unified(dst, src) : kUncounted;
  return Blocking(dir, bytes, [&] { return real(dst, src, bytes); });
}

VTPU_EXPORT CUresult cuMemcpy_ptds(CUdeviceptr dst, CUdeviceptr src,
                                   size_t bytes) {
  auto real = VTPU_REAL(cuMemcpy_ptds);
  if (!real) return CUDA_ERROR_NOT_INITIALIZED;
  FIRST_USE(9);
  Direction dir = CommArmed() ? Unified(dst, src) : kUncounted;
  return Blocking(dir, bytes, [&] { return real(dst, src, bytes); });
}

VTPU_EXPORT CUresult cuMemcpyAsync(CUdeviceptr dst, CUdeviceptr src,
                                   size_t bytes, CUstream stream) {
  auto real = VTPU_REAL(cuMemcpyAsync);
  if (!real) return CUDA_ERROR_NOT_INITIALIZED;
  FIRST_USE(10);
  Direction dir = CommArmed() ? Unified(dst, src) : kUncounted;
  return Async(dir, bytes, stream, false,
               [&] { return real(dst, src, bytes, stream); });
}

VTPU_EXPORT CUresult cuMemcpyAsync_ptsz(CUdeviceptr dst, CUdeviceptr src,
                                        size_t bytes, CUstream stream) {
  auto real = VTPU_REAL(cuMemcpyAsync_ptsz);
  if (!real) return CUDA_ERROR_NOT_INITIALIZED;
  FIRST_USE(11);
  Direction dir = CommArmed() ? Unified(dst, src) : kUncounted;
  return Async(dir, bytes, stream, true,
               [&] { return real(dst, src, bytes, stream); });
}

// The totals a Python writer charges its records the deltas of
// (runtime/client.py), as the reference exports them (enforce.cc:2359).
VTPU_EXPORT uint64_t vtpu_comm_time_ns_total() {
  DrainComm();
  return g_comm_time_ns_total.load(std::memory_order_relaxed);
}

VTPU_EXPORT uint64_t vtpu_comm_bytes_total() {
  return g_comm_bytes_total.load(std::memory_order_relaxed);
}

VTPU_EXPORT uint64_t vtpu_collectives_total() {
  return g_collectives_total.load(std::memory_order_relaxed);
}

// The copy entries this process reached while armed, comma-separated into
// `buf`; the length the list needs.
VTPU_EXPORT int vtpu_comm_entries(char* buf, int len) {
  uint32_t used = g_entries_used.load(std::memory_order_relaxed);
  std::string out;
  for (size_t i = 0; i < sizeof(kEntries) / sizeof(kEntries[0]); i++)
    if (used & (1u << i)) out += (out.empty() ? "" : ",") +
                                 std::string(kEntries[i]);
  if (buf && len > 0) snprintf(buf, (size_t)len, "%s", out.c_str());
  return (int)out.size();
}
