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
//
// Stream capture follows the driver's rules as far as the interposer meets
// them: a launch into a capturing stream becomes a node of the graph and
// runs nothing; a graph replay runs each node for FAKE_EXEC_US. Recording
// an event on, or querying, a capturing stream invalidates its capture, as
// does touching the legacy stream or querying an event while a global-mode
// capture is underway; cuStreamEndCapture then fails. A stream's device is
// bits 12-15 of its handle (cuStreamGetCtx), for multi-device launches.

#include <fcntl.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <sys/file.h>
#include <sys/mman.h>
#include <time.h>
#include <unistd.h>

#include <algorithm>
#include <map>
#include <mutex>

#include "../cuda_subset.h"

#define FAKE_EXPORT extern "C" __attribute__((visibility("default")))

namespace {

struct FakeEvent {
  uint64_t at_ns = 0;
  bool recorded = false;
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
};
FakeCapture g_capture;

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

struct SharedChip {
  uint64_t busy_ns;
  uint64_t free_at_ns;
};
SharedChip* g_shared = nullptr;
int g_shared_lock_fd = -1;

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
  static std::once_flag once;
  std::call_once(once, InitSharedChip);
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

CUresult Launch(CUstream stream, uint64_t nodes = 1) {
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
  return Submit(nodes * ExecNs());
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

FAKE_EXPORT CUresult cuLaunchKernel(CUfunction, unsigned, unsigned, unsigned,
                                    unsigned, unsigned, unsigned, unsigned,
                                    CUstream stream, void**, void**) {
  return Launch(stream);
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
  g_capture = FakeCapture{stream, mode, true, false, 0};
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
  uint64_t t;
  {
    std::lock_guard<std::mutex> lock(g_mu);
    t = g_free_at_ns;
  }
  SleepUntil(t);
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
  e->at_ns = LyingEvents() ? NowNs() : std::max(NowNs(), g_free_at_ns);
  e->recorded = true;
  return CUDA_SUCCESS;
}

FAKE_EXPORT CUresult cuEventQuery(CUevent ev) {
  {
    // a potentially unsafe call while a global-mode capture is underway
    std::lock_guard<std::mutex> lock(g_mu);
    if (g_capture.active && g_capture.mode == CU_STREAM_CAPTURE_MODE_GLOBAL) {
      g_capture.invalidated = true;
      return CUDA_ERROR_STREAM_CAPTURE_UNSUPPORTED;
    }
  }
  auto* e = reinterpret_cast<FakeEvent*>(ev);
  return NowNs() >= e->at_ns ? CUDA_SUCCESS : CUDA_ERROR_NOT_READY;
}

FAKE_EXPORT CUresult cuEventElapsedTime(float* ms, CUevent a, CUevent b) {
  auto* ea = reinterpret_cast<FakeEvent*>(a);
  auto* eb = reinterpret_cast<FakeEvent*>(b);
  if (!ea->recorded || !eb->recorded) return CUDA_ERROR_INVALID_VALUE;
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
