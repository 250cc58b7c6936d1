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

CUresult Launch() {
  {
    std::lock_guard<std::mutex> lock(g_mu);
    g_launches++;
  }
  return Submit(ExecNs());
}

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
  *dev = 0;
  return CUDA_SUCCESS;
}

FAKE_EXPORT CUresult cuLaunchKernel(CUfunction, unsigned, unsigned, unsigned,
                                    unsigned, unsigned, unsigned, unsigned,
                                    CUstream, void**, void**) {
  return Launch();
}

FAKE_EXPORT CUresult cuLaunchKernel_ptsz(CUfunction, unsigned, unsigned,
                                         unsigned, unsigned, unsigned,
                                         unsigned, unsigned, CUstream, void**,
                                         void**) {
  return Launch();
}

FAKE_EXPORT CUresult cuLaunchKernelEx(const CUlaunchConfig*, CUfunction,
                                      void**, void**) {
  return Launch();
}

FAKE_EXPORT CUresult cuLaunchKernelEx_ptsz(const CUlaunchConfig*, CUfunction,
                                           void**, void**) {
  return Launch();
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

FAKE_EXPORT CUresult cuStreamQuery(CUstream) {
  std::lock_guard<std::mutex> lock(g_mu);
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

FAKE_EXPORT CUresult cuStreamIsCapturing(CUstream, CUstreamCaptureStatus* s) {
  *s = CU_STREAM_CAPTURE_STATUS_NONE;
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

FAKE_EXPORT CUresult cuEventRecord(CUevent ev, CUstream) {
  std::lock_guard<std::mutex> lock(g_mu);
  auto* e = reinterpret_cast<FakeEvent*>(ev);
  e->at_ns = LyingEvents() ? NowNs() : std::max(NowNs(), g_free_at_ns);
  e->recorded = true;
  return CUDA_SUCCESS;
}

FAKE_EXPORT CUresult cuEventQuery(CUevent ev) {
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
  static const char* kPtsz[] = {"cuLaunchKernel", "cuLaunchKernelEx",
                                "cuMemAllocAsync", "cuMemFreeAsync"};
  static const char* kV2[] = {"cuMemAlloc", "cuMemFree", "cuMemGetInfo",
                              "cuDeviceTotalMem", "cuEventDestroy"};
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

FAKE_EXPORT uint64_t fake_used_bytes() {
  std::lock_guard<std::mutex> lock(g_mu);
  return g_used;
}
