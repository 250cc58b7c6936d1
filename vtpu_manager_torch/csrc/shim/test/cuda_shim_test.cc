// cuda_shim_test.cc — drives the interposer against the fake driver.
//
// Run with LD_PRELOAD=<interposer> and VTPU_REAL_CUDA_LIBRARY_PATH=<fake
// libcuda.so.1>, the way a tenant process runs. It reaches the driver the
// way the CUDA runtime does: dlopen the driver, dlsym its
// cuGetProcAddress_v2, and resolve everything else through that.
//
//   --routes         every route lands on the hook of the right variant, and
//                    an unhooked symbol lands on the real driver
//   --caps           cap verdicts under, at and over VTPU_MEM_LIMIT_0, the
//                    credit a free returns, and the capped memory view
//   --throttle-only  SHIM_TEST_ITERS launch+synchronize steps; prints wall=
//                    (with the fake's own_busy_ns= on its sliced card) and
//                    the interposer's counters (COUNTERS name=value ...).
//                    SHIM_TEST_LAUNCH picks the path: kernel (cuLaunchKernel,
//                    the default), graph (one captured kernel, replayed by
//                    cuGraphLaunch) or coop (cuLaunchCooperativeKernel)
//   --capture        eager launches, then SHIM_TEST_CAPTURE launches of every
//                    kind captured on a stream in global mode, a legacy-stream
//                    launch during that capture, the graph replayed, and one
//                    multi-device cooperative launch over two devices; prints
//                    CAPTURE name=value ... (what the interposer charged and
//                    counted across each part, and the capture's result);
//                    then a global-mode capture of the main thread while a
//                    second thread launches SHIM_TEST_CROSS metered kernels
//                    on another stream, its samples drained as they finish
//                    (CROSS name=value ...: the capture's result and what
//                    the second thread's launches were counted and sampled)
//   --entry-caps     SHIM_TEST_ENTRY (pitch, managed, pool, pool_ptsz, array,
//                    array3d, mipmap) under VTPU_MEM_LIMIT_0: SHIM_TEST_BIG
//                    bytes refused, SHIM_TEST_SMALL granted, the capped view
//                    while held, the free, the same granted again
//   --alloc          allocates each size of SHIM_TEST_ALLOCS (comma-separated
//                    bytes) and keeps what it got, prints a VERDICT per size
//                    and HELD, then holds it until SHIM_TEST_HOLD_FILE exists
//                    (a second process of the same tenant, a co-tenant, or
//                    a SIGKILL meets it there); with SHIM_TEST_STEP_FILE,
//                    size i > 0 first waits for <SHIM_TEST_STEP_FILE>.<i>
//                    (the test changes the node in between)
//   --overflow       the ops of SHIM_TEST_OPS, comma-separated: alloc:N
//                    (cuMemAlloc), create:N (cuMemCreate), free:K (frees op
//                    K's allocation); a VERDICT opI rc per op, and for an
//                    alloc granted WHERE opI <host or device: the location
//                    of the physical memory mapped there, read back through
//                    cuMemRetainAllocationHandle and
//                    cuMemGetAllocationPropertiesFromHandle; none when no
//                    mapping>; then SPILL name=value ... (the
//                    interposer's overflow tier and the fake's device and
//                    host bytes) and HELD, holds until SHIM_TEST_HOLD_FILE
//                    exists (SHIM_TEST_STEP_FILE as in --alloc), frees what
//                    it holds and prints SPILL again
//   --stress         threads allocating, freeing and launching at once: the
//                    cap holds at every moment, the ledger drains to zero
//                    and every launch is counted
//   --steps          a tenant with no Python, for the step ring: first a
//                    launch into a capturing stream and a synchronisation
//                    of it (no step), then SHIM_TEST_ITERS steps, each
//                    SHIM_TEST_KERNELS launches of its own kernels
//                    (SHIM_TEST_LAUNCH=graph: SHIM_TEST_REPLAYS replays of
//                    one captured kernel) and one synchronisation
//                    (SHIM_TEST_SYNC stream, stream_ptsz, ctx, event, or
//                    none: SHIM_TEST_GAP_US of sleep instead), resolved
//                    by SHIM_TEST_ROUTE (proc: cuGetProcAddress, dlsym:
//                    the driver's handle, export: the global scope),
//                    then a second synchronisation with no launch; step
//                    SHIM_TEST_NEW_AT also launches a kernel never seen
//                    before, and step i holds (i % 3 + 1) x
//                    SHIM_TEST_STEP_ALLOC bytes; the steps end early once
//                    SHIM_TEST_STOP_FILE exists. Prints STEP i start_ns
//                    end_ns epoch per step (CLOCK_MONOTONIC; the
//                    interposer's quota_epoch after the step), then
//                    STEPS records=<the interposer's> and COUNTERS
//   --excess         SHIM_TEST_ITERS launch+synchronize steps (the watcher
//                    ticks and adopts the feed's calibration), then
//                    EXCESS gap_us=excess_us for each gap of SHIM_TEST_GAPS
//                    (comma-separated us): the interposer's active table
//                    (-1: none), and COUNTERS
//   --comm           the copies and launches of SHIM_TEST_COMM, a
//                    comma-separated list of op:bytes (htod, dtoh, htod_async,
//                    dtoh_async, dtod_async, unified_htod, unified_dtoh,
//                    unified_async_htod, unified_async_dtoh, unified_dtod
//                    and unified_hh, the bytes copied; nccl: a launch of an
//                    NCCL-named CUfunction, nccl_kernel: of an NCCL-named
//                    CUkernel, kernel: of another, the number in place of
//                    bytes), each on kStream, resolved with
//                    SHIM_TEST_PTDS=1 as the per-thread default stream
//                    forms (null stream), each followed by a launch and a
//                    synchronisation of kStream (one step, whose ring record
//                    holds what the op moved); then, with
//                    SHIM_TEST_CAPTURE=1, an async copy and an NCCL launch
//                    into a stream captured in the global mode. Prints
//                    COMM comm_time_ns=.. comm_bytes=.. collectives=..
//                    copies=<the fake's> capture_rc=<cuStreamEndCapture's>
//                    records=<the interposer's ring records>
//
// (The counterpart of library/test/shim_test.cc.)

#include <dlfcn.h>
#include <pthread.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <time.h>

#include <sys/stat.h>
#include <unistd.h>

#include <atomic>
#include <string>
#include <thread>
#include <vector>

#include "../cuda_subset.h"

extern "C" CUresult cuMemGetInfo_v2(size_t*, size_t*) __attribute__((weak));

namespace {

using GetProcV2 = CUresult (*)(const char*, void**, int, cuuint64_t,
                               CUdriverProcAddressQueryResult*);
using GetProcV1 = CUresult (*)(const char*, void**, int, cuuint64_t);
using LaunchFn = CUresult (*)(CUfunction, unsigned, unsigned, unsigned,
                              unsigned, unsigned, unsigned, unsigned,
                              CUstream, void**, void**);
using SyncFn = CUresult (*)(CUstream);
using AllocFn = CUresult (*)(CUdeviceptr*, size_t);
using AllocAsyncFn = CUresult (*)(CUdeviceptr*, size_t, CUstream);
using FreeFn = CUresult (*)(CUdeviceptr);
using CreateFn = CUresult (*)(CUmemGenericAllocationHandle*, size_t,
                              const CUmemAllocationProp*, unsigned long long);
using ReleaseFn = CUresult (*)(CUmemGenericAllocationHandle);
using InfoFn = CUresult (*)(size_t*, size_t*);
using TotalFn = CUresult (*)(size_t*, CUdevice);
using CounterFn = uint64_t (*)();
using AddressFn = void* (*)(const char*);
using LaunchExFn = CUresult (*)(const CUlaunchConfig*, CUfunction, void**,
                                void**);
using CoopFn = CUresult (*)(CUfunction, unsigned, unsigned, unsigned,
                            unsigned, unsigned, unsigned, unsigned, CUstream,
                            void**);
using MultiFn = CUresult (*)(CUDA_LAUNCH_PARAMS*, unsigned, unsigned);
using BeginCaptureFn = CUresult (*)(CUstream, CUstreamCaptureMode);
using EndCaptureFn = CUresult (*)(CUstream, CUgraph*);
using InstantiateFn = CUresult (*)(CUgraphExec*, CUgraph, unsigned long long);
using GraphLaunchFn = CUresult (*)(CUgraphExec, CUstream);
using PitchFn = CUresult (*)(CUdeviceptr*, size_t*, size_t, size_t, unsigned);
using ManagedFn = CUresult (*)(CUdeviceptr*, size_t, unsigned);
using PoolFn = CUresult (*)(CUmemoryPool*, CUdevice);
using FromPoolFn = CUresult (*)(CUdeviceptr*, size_t, CUmemoryPool, CUstream);
using FreeAsyncFn = CUresult (*)(CUdeviceptr, CUstream);
using ArrayFn = CUresult (*)(CUarray*, const CUDA_ARRAY_DESCRIPTOR*);
using Array3DFn = CUresult (*)(CUarray*, const CUDA_ARRAY3D_DESCRIPTOR*);
using MipmapFn = CUresult (*)(CUmipmappedArray*,
                              const CUDA_ARRAY3D_DESCRIPTOR*, unsigned);
using ArrayDestroyFn = CUresult (*)(CUarray);
using MipmapDestroyFn = CUresult (*)(CUmipmappedArray);

// A stream of the harness's own on device 0 (the fake reads a stream's
// device from bits 12-15 of its handle), and one on device 1.
CUstream const kStream = reinterpret_cast<CUstream>(0x10);
CUstream const kStreamDev1 = reinterpret_cast<CUstream>(0x1010);
CUstream const kStream2 = reinterpret_cast<CUstream>(0x20);

void* g_driver = nullptr;
GetProcV2 g_get_proc = nullptr;

double NowMs() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return ts.tv_sec * 1e3 + ts.tv_nsec / 1e6;
}

void* Proc(const char* name, cuuint64_t flags = 0, int version = 12000) {
  void* fn = nullptr;
  if (g_get_proc(name, &fn, version, flags, nullptr) != CUDA_SUCCESS)
    return nullptr;
  return fn;
}

// Library file and symbol name an address lies in.
bool Where(void* p, const char** lib, const char** sym) {
  Dl_info info;
  if (!p || !dladdr(p, &info)) return false;
  *lib = info.dli_fname ? info.dli_fname : "?";
  *sym = info.dli_sname ? info.dli_sname : "?";
  return true;
}

bool Expect(const char* label, void* p, const char* want_lib,
            const char* want_sym) {
  const char* lib = "?";
  const char* sym = "?";
  bool found = Where(p, &lib, &sym);
  bool ok = found && strstr(lib, want_lib) && strcmp(sym, want_sym) == 0;
  printf("ROUTE %s %s %s:%s\n", label, ok ? "ok" : "FAIL", lib, sym);
  return ok;
}

int Routes() {
  const char* shim = getenv("SHIM_PATH");
  const char* real = getenv("VTPU_REAL_CUDA_LIBRARY_PATH");
  if (!shim || !real) {
    fprintf(stderr, "--routes needs SHIM_PATH and VTPU_REAL_CUDA_LIBRARY_PATH\n");
    return 2;
  }
  const char* shim_base = strrchr(shim, '/') ? strrchr(shim, '/') + 1 : shim;
  const char* real_base = strrchr(real, '/') ? strrchr(real, '/') + 1 : real;
  bool ok = true;
  // route 1: an exported name, bound at load time
  ok &= Expect("export:cuMemGetInfo_v2", (void*)&cuMemGetInfo_v2, shim_base,
               "cuMemGetInfo_v2");
  // route 2: dlsym on the driver's own handle
  ok &= Expect("dlsym:cuGetProcAddress_v2",
               dlsym(g_driver, "cuGetProcAddress_v2"), shim_base,
               "cuGetProcAddress_v2");
  ok &= Expect("dlsym:cuGetProcAddress", dlsym(g_driver, "cuGetProcAddress"),
               shim_base, "cuGetProcAddress");
  ok &= Expect("dlsym:cuLaunchKernel", dlsym(g_driver, "cuLaunchKernel"),
               shim_base, "cuLaunchKernel");
  // route 3: cuGetProcAddress, by version and flags
  const cuuint64_t ptsz = CU_GET_PROC_ADDRESS_PER_THREAD_DEFAULT_STREAM;
  ok &= Expect("proc:cuLaunchKernel", Proc("cuLaunchKernel"), shim_base,
               "cuLaunchKernel");
  ok &= Expect("proc:cuLaunchKernel/ptsz", Proc("cuLaunchKernel", ptsz),
               shim_base, "cuLaunchKernel_ptsz");
  ok &= Expect("proc:cuLaunchKernelEx", Proc("cuLaunchKernelEx"), shim_base,
               "cuLaunchKernelEx");
  ok &= Expect("proc:cuLaunchKernelEx/ptsz", Proc("cuLaunchKernelEx", ptsz),
               shim_base, "cuLaunchKernelEx_ptsz");
  ok &= Expect("proc:cuMemAlloc", Proc("cuMemAlloc"), shim_base,
               "cuMemAlloc_v2");
  ok &= Expect("proc:cuMemFree", Proc("cuMemFree"), shim_base,
               "cuMemFree_v2");
  ok &= Expect("proc:cuMemAllocAsync/ptsz", Proc("cuMemAllocAsync", ptsz),
               shim_base, "cuMemAllocAsync_ptsz");
  ok &= Expect("proc:cuMemFreeAsync", Proc("cuMemFreeAsync"), shim_base,
               "cuMemFreeAsync");
  ok &= Expect("proc:cuMemCreate", Proc("cuMemCreate"), shim_base,
               "cuMemCreate");
  ok &= Expect("proc:cuMemRelease", Proc("cuMemRelease"), shim_base,
               "cuMemRelease");
  ok &= Expect("proc:cuMemGetInfo", Proc("cuMemGetInfo"), shim_base,
               "cuMemGetInfo_v2");
  ok &= Expect("proc:cuDeviceTotalMem", Proc("cuDeviceTotalMem"), shim_base,
               "cuDeviceTotalMem_v2");
  ok &= Expect("proc:cuGetProcAddress", Proc("cuGetProcAddress"), shim_base,
               "cuGetProcAddress_v2");
  // launch paths and allocation entries beyond cuLaunchKernel / cuMemAlloc
  struct Lookup {
    const char* name;
    cuuint64_t flags;
    const char* hook;
  };
  static const Lookup kMore[] = {
      {"cuGraphLaunch", 0, "cuGraphLaunch"},
      {"cuGraphLaunch", ptsz, "cuGraphLaunch_ptsz"},
      {"cuLaunchCooperativeKernel", 0, "cuLaunchCooperativeKernel"},
      {"cuLaunchCooperativeKernel", ptsz, "cuLaunchCooperativeKernel_ptsz"},
      {"cuLaunchCooperativeKernelMultiDevice", 0,
       "cuLaunchCooperativeKernelMultiDevice"},
      {"cuMemAllocPitch", 0, "cuMemAllocPitch_v2"},
      {"cuMemAllocManaged", 0, "cuMemAllocManaged"},
      {"cuMemAllocFromPoolAsync", 0, "cuMemAllocFromPoolAsync"},
      {"cuMemAllocFromPoolAsync", ptsz, "cuMemAllocFromPoolAsync_ptsz"},
      {"cuArrayCreate", 0, "cuArrayCreate_v2"},
      {"cuArray3DCreate", 0, "cuArray3DCreate_v2"},
      {"cuMipmappedArrayCreate", 0, "cuMipmappedArrayCreate"},
      {"cuArrayDestroy", 0, "cuArrayDestroy"},
      {"cuMipmappedArrayDestroy", 0, "cuMipmappedArrayDestroy"},
      // the synchronisations that close a step
      {"cuStreamSynchronize", 0, "cuStreamSynchronize"},
      {"cuStreamSynchronize", ptsz, "cuStreamSynchronize_ptsz"},
      {"cuCtxSynchronize", 0, "cuCtxSynchronize"},
      {"cuEventSynchronize", 0, "cuEventSynchronize"},
      // the copies CommTelemetry counts
      {"cuMemcpyHtoD", 0, "cuMemcpyHtoD_v2"},
      {"cuMemcpyHtoD", ptsz, "cuMemcpyHtoD_v2_ptds"},
      {"cuMemcpyDtoH", 0, "cuMemcpyDtoH_v2"},
      {"cuMemcpyDtoH", ptsz, "cuMemcpyDtoH_v2_ptds"},
      {"cuMemcpyHtoDAsync", 0, "cuMemcpyHtoDAsync_v2"},
      {"cuMemcpyHtoDAsync", ptsz, "cuMemcpyHtoDAsync_v2_ptsz"},
      {"cuMemcpyDtoHAsync", 0, "cuMemcpyDtoHAsync_v2"},
      {"cuMemcpyDtoHAsync", ptsz, "cuMemcpyDtoHAsync_v2_ptsz"},
      {"cuMemcpy", 0, "cuMemcpy"},
      {"cuMemcpy", ptsz, "cuMemcpy_ptds"},
      {"cuMemcpyAsync", 0, "cuMemcpyAsync"},
      {"cuMemcpyAsync", ptsz, "cuMemcpyAsync_ptsz"},
  };
  for (const Lookup& l : kMore) {
    char label[128];
    snprintf(label, sizeof(label), "proc:%s%s", l.name,
             l.flags ? "/ptsz" : "");
    ok &= Expect(label, Proc(l.name, l.flags), shim_base, l.hook);
  }
  ok &= Expect("dlsym:cuMemAllocManaged", dlsym(g_driver, "cuMemAllocManaged"),
               shim_base, "cuMemAllocManaged");
  ok &= Expect("dlsym:cuGraphLaunch", dlsym(g_driver, "cuGraphLaunch"),
               shim_base, "cuGraphLaunch");
  auto v1 = reinterpret_cast<GetProcV1>(Proc("cuGetProcAddress", 0, 11030));
  void* via_v1 = nullptr;
  if (v1) v1("cuLaunchKernel", &via_v1, 12000, 0);
  ok &= Expect("proc-v1:cuGetProcAddress", (void*)v1, shim_base,
               "cuGetProcAddress");
  ok &= Expect("proc-v1:cuLaunchKernel", via_v1, shim_base, "cuLaunchKernel");
  void* sync_v1 = nullptr;
  if (v1) v1("cuStreamSynchronize", &sync_v1, 12000, 0);
  ok &= Expect("proc-v1:cuStreamSynchronize", sync_v1, shim_base,
               "cuStreamSynchronize");
  ok &= Expect("dlsym:cuCtxSynchronize", dlsym(g_driver, "cuCtxSynchronize"),
               shim_base, "cuCtxSynchronize");
  ok &= Expect("dlsym:cuEventSynchronize",
               dlsym(g_driver, "cuEventSynchronize"), shim_base,
               "cuEventSynchronize");
  // every other symbol passes through to the real driver
  auto real_address =
      reinterpret_cast<AddressFn>(dlsym(g_driver, "fake_real_address"));
  void* query = Proc("cuEventQuery");
  ok &= Expect("proc:cuEventQuery", query, real_base, "cuEventQuery");
  ok &= real_address && query == real_address("cuEventQuery");
  printf("%s\n", ok ? "ROUTES OK" : "ROUTES FAIL");
  return ok ? 0 : 1;
}

void Verdict(const char* label, CUresult rc) {
  printf("VERDICT %s %d\n", label, rc);
}

int Caps() {
  const char* raw = getenv("VTPU_MEM_LIMIT_0");
  if (!raw) {
    fprintf(stderr, "--caps needs VTPU_MEM_LIMIT_0\n");
    return 2;
  }
  size_t cap = strtoull(raw, nullptr, 10);
  auto alloc = reinterpret_cast<AllocFn>(Proc("cuMemAlloc"));
  auto alloc_async = reinterpret_cast<AllocAsyncFn>(Proc("cuMemAllocAsync"));
  auto release_ptr = reinterpret_cast<FreeFn>(Proc("cuMemFree"));
  auto create = reinterpret_cast<CreateFn>(Proc("cuMemCreate"));
  auto release = reinterpret_cast<ReleaseFn>(Proc("cuMemRelease"));
  auto info = reinterpret_cast<InfoFn>(Proc("cuMemGetInfo"));
  auto total_mem = reinterpret_cast<TotalFn>(Proc("cuDeviceTotalMem"));
  if (!alloc || !alloc_async || !release_ptr || !create || !release ||
      !info || !total_mem) {
    fprintf(stderr, "driver entry points missing\n");
    return 2;
  }
  size_t free_b = 0, total_b = 0, dev_total = 0;
  info(&free_b, &total_b);
  printf("MEMINFO start free=%zu total=%zu\n", free_b, total_b);
  total_mem(&dev_total, 0);
  printf("TOTALMEM %zu\n", dev_total);
  CUdeviceptr a = 0, b = 0, c = 0, d = 0;
  Verdict("under", alloc(&a, cap / 2));
  Verdict("at_cap", alloc(&b, cap - cap / 2));
  Verdict("over_by_one", alloc(&c, 1));
  info(&free_b, &total_b);
  printf("MEMINFO full free=%zu total=%zu\n", free_b, total_b);
  Verdict("free", release_ptr(a));
  Verdict("after_free", alloc(&d, cap / 2));
  Verdict("async_over", alloc_async(&c, 1, nullptr));
  Verdict("free_b", release_ptr(b));
  Verdict("free_d", release_ptr(d));
  CUmemAllocationProp prop = {};
  CUmemGenericAllocationHandle h = 0;
  Verdict("create_over", create(&h, cap + 1, &prop, 0));
  Verdict("create_at_cap", create(&h, cap, &prop, 0));
  Verdict("alloc_while_created", alloc(&a, 1));
  Verdict("release", release(h));
  Verdict("alloc_after_release", alloc(&a, cap));
  info(&free_b, &total_b);
  printf("MEMINFO end free=%zu total=%zu\n", free_b, total_b);
  return 0;
}

// The interposer's counters, read the way a tenant reads them.
void PrintCounters() {
  static const char* kNames[] = {
      "vtpu_launches_total",        "vtpu_sampled_launches_total",
      "vtpu_probes_total",          "vtpu_charged_ns_total",
      "vtpu_obs_overhead_ns",       "vtpu_throttle_wait_ns_total",
      "vtpu_watcher_external_total", "vtpu_watcher_fallback_total",
      "vtpu_blind_ticks_total",     "vtpu_oom_rejected_total",
      "vtpu_graph_launches_total",  "vtpu_captured_launches_total",
      "vtpu_windows_total",         "vtpu_stand_aside_ns_total",
      "vtpu_clocked_total",         "vtpu_quota_reloads_total",
      "vtpu_freeze_wait_ns_total",  "vtpu_quota_epoch"};
  printf("COUNTERS");
  for (const char* name : kNames) {
    auto fn = reinterpret_cast<int64_t (*)()>(dlsym(RTLD_DEFAULT, name));
    printf(" %s=%lld", name, fn ? (long long)fn() : -1ll);
  }
  auto up = reinterpret_cast<int (*)(int)>(dlsym(RTLD_DEFAULT,
                                                 "vtpu_up_limit"));
  auto limit = reinterpret_cast<int (*)(int)>(dlsym(RTLD_DEFAULT,
                                                    "vtpu_core_limit"));
  printf(" vtpu_up_limit=%d vtpu_core_limit=%d\n", up ? up(0) : -1,
         limit ? limit(0) : -1);
}

int Alloc() {
  auto alloc = reinterpret_cast<AllocFn>(Proc("cuMemAlloc"));
  auto release_ptr = reinterpret_cast<FreeFn>(Proc("cuMemFree"));
  if (!alloc || !release_ptr) {
    fprintf(stderr, "driver entry points missing\n");
    return 2;
  }
  const char* raw = getenv("SHIM_TEST_ALLOCS");
  const char* step = getenv("SHIM_TEST_STEP_FILE");
  std::vector<CUdeviceptr> held;
  int i = 0;
  for (const char* p = raw ? raw : ""; *p; i++) {
    if (step && i > 0) {
      std::string go = std::string(step) + "." + std::to_string(i);
      struct stat st;
      for (int waited = 0; stat(go.c_str(), &st) != 0 && waited < 60000;
           waited += 10)
        usleep(10000);
    }
    char* end = nullptr;
    size_t bytes = strtoull(p, &end, 10);
    CUdeviceptr ptr = 0;
    CUresult rc = alloc(&ptr, bytes);
    printf("VERDICT alloc%d %d\n", i, rc);
    fflush(stdout);
    if (rc == CUDA_SUCCESS) held.push_back(ptr);
    p = (*end == ',') ? end + 1 : end;
  }
  PrintCounters();
  printf("HELD\n");
  fflush(stdout);
  const char* hold = getenv("SHIM_TEST_HOLD_FILE");
  struct stat st;
  for (int waited = 0; hold && stat(hold, &st) != 0 && waited < 60000;
       waited += 10)
    usleep(10000);
  for (CUdeviceptr ptr : held) release_ptr(ptr);
  return 0;
}

void WaitFor(const std::string& path) {
  struct stat st;
  for (int waited = 0; stat(path.c_str(), &st) != 0 && waited < 60000;
       waited += 10)
    usleep(10000);
}

int64_t Driver(const char* name);  // a fake driver's counter (-1: none)

void PrintSpill() {
  auto counter = [](const char* name) {
    auto fn = reinterpret_cast<int64_t (*)()>(dlsym(RTLD_DEFAULT, name));
    return fn ? (long long)fn() : -1ll;
  };
  auto spilled = reinterpret_cast<int64_t (*)(int)>(
      dlsym(RTLD_DEFAULT, "vtpu_spilled_bytes"));
  printf("SPILL spilled=%lld spills=%lld rejected=%lld fill_ns=%lld "
         "oom=%lld device_bytes=%lld host_bytes=%lld\n",
         spilled ? (long long)spilled(0) : -1ll, counter("vtpu_spills_total"),
         counter("vtpu_spill_rejected_total"),
         counter("vtpu_spill_fill_ns_total"),
         counter("vtpu_oom_rejected_total"),
         (long long)Driver("fake_used_bytes"),
         (long long)Driver("fake_host_bytes"));
  fflush(stdout);
}

int Overflow() {
  using RetainFn = CUresult (*)(CUmemGenericAllocationHandle*, void*);
  using PropsFn = CUresult (*)(CUmemAllocationProp*,
                               CUmemGenericAllocationHandle);
  auto alloc = reinterpret_cast<AllocFn>(Proc("cuMemAlloc"));
  auto release_ptr = reinterpret_cast<FreeFn>(Proc("cuMemFree"));
  auto create = reinterpret_cast<CreateFn>(Proc("cuMemCreate"));
  auto release = reinterpret_cast<ReleaseFn>(Proc("cuMemRelease"));
  auto retain = reinterpret_cast<RetainFn>(
      Proc("cuMemRetainAllocationHandle"));
  auto props = reinterpret_cast<PropsFn>(
      Proc("cuMemGetAllocationPropertiesFromHandle"));
  if (!alloc || !release_ptr || !create || !release || !retain || !props) {
    fprintf(stderr, "driver entry points missing\n");
    return 2;
  }
  const char* raw = getenv("SHIM_TEST_OPS");
  const char* step = getenv("SHIM_TEST_STEP_FILE");
  std::vector<CUdeviceptr> ptrs;
  std::vector<CUmemGenericAllocationHandle> handles;
  int i = 0;
  for (const char* p = raw ? raw : ""; *p; i++) {
    if (step && i > 0) WaitFor(std::string(step) + "." + std::to_string(i));
    const char* colon = strchr(p, ':');
    if (!colon) return 2;
    std::string op(p, colon - p);
    char* end = nullptr;
    unsigned long long n = strtoull(colon + 1, &end, 10);
    CUresult rc = CUDA_ERROR_INVALID_VALUE;
    CUdeviceptr ptr = 0;
    CUmemGenericAllocationHandle handle = 0;
    if (op == "alloc") {
      rc = alloc(&ptr, n);
    } else if (op == "create") {
      CUmemAllocationProp prop = {};
      rc = create(&handle, n, &prop, 0);
    } else if (op == "free" && n < ptrs.size()) {
      if (ptrs[n]) {
        rc = release_ptr(ptrs[n]);
        ptrs[n] = 0;
      } else if (handles[n]) {
        rc = release(handles[n]);
        handles[n] = 0;
      }
    }
    ptrs.push_back(rc == CUDA_SUCCESS ? ptr : 0);
    handles.push_back(rc == CUDA_SUCCESS ? handle : 0);
    printf("VERDICT op%d %d\n", i, rc);
    if (ptr && rc == CUDA_SUCCESS) {
      CUmemGenericAllocationHandle mapped = 0;
      CUmemAllocationProp prop = {};
      const char* where = "none";
      if (retain(&mapped, reinterpret_cast<void*>(ptr)) == CUDA_SUCCESS) {
        if (props(&prop, mapped) == CUDA_SUCCESS)
          where = prop.locationType == CU_MEM_LOCATION_TYPE_HOST ? "host"
                                                                 : "device";
        release(mapped);
      }
      printf("WHERE op%d %s\n", i, where);
    }
    fflush(stdout);
    p = (*end == ',') ? end + 1 : end;
  }
  PrintSpill();
  printf("HELD\n");
  fflush(stdout);
  const char* hold = getenv("SHIM_TEST_HOLD_FILE");
  if (hold) WaitFor(hold);
  for (CUdeviceptr ptr : ptrs)
    if (ptr) release_ptr(ptr);
  for (CUmemGenericAllocationHandle h : handles)
    if (h) release(h);
  PrintSpill();
  return 0;
}

// One kernel captured on kStream and instantiated: what the graph path
// replays.
CUgraphExec CaptureOne(CUfunction fn) {
  auto launch = reinterpret_cast<LaunchFn>(Proc("cuLaunchKernel"));
  auto begin = reinterpret_cast<BeginCaptureFn>(Proc("cuStreamBeginCapture"));
  auto end = reinterpret_cast<EndCaptureFn>(Proc("cuStreamEndCapture"));
  auto inst =
      reinterpret_cast<InstantiateFn>(Proc("cuGraphInstantiateWithFlags"));
  CUgraph graph = nullptr;
  CUgraphExec exec = nullptr;
  if (!launch || !begin || !end || !inst ||
      begin(kStream, CU_STREAM_CAPTURE_MODE_GLOBAL) != CUDA_SUCCESS ||
      launch(fn, 1, 1, 1, 1, 1, 1, 0, kStream, nullptr, nullptr) !=
          CUDA_SUCCESS ||
      end(kStream, &graph) != CUDA_SUCCESS ||
      inst(&exec, graph, 0) != CUDA_SUCCESS)
    return nullptr;
  return exec;
}

int ThrottleOnly() {
  const char* raw = getenv("SHIM_TEST_ITERS");
  int iters = raw ? atoi(raw) : 100;
  const char* path = getenv("SHIM_TEST_LAUNCH");
  std::string kind = path && *path ? path : "kernel";
  auto launch = reinterpret_cast<LaunchFn>(Proc("cuLaunchKernel"));
  auto coop = reinterpret_cast<CoopFn>(Proc("cuLaunchCooperativeKernel"));
  auto graph_launch = reinterpret_cast<GraphLaunchFn>(Proc("cuGraphLaunch"));
  auto sync = reinterpret_cast<SyncFn>(Proc("cuStreamSynchronize"));
  if (!launch || !coop || !graph_launch || !sync) {
    fprintf(stderr, "driver entry points missing\n");
    return 2;
  }
  // one distinct "kernel" handle, as a real module's function would be
  CUfunction fn = reinterpret_cast<CUfunction>(0x1234);
  CUgraphExec exec = nullptr;
  if (kind == "graph" && !(exec = CaptureOne(fn))) {
    fprintf(stderr, "capturing the graph failed\n");
    return 1;
  }
  double t0 = NowMs();
  for (int i = 0; i < iters; i++) {
    CUresult rc =
        kind == "graph" ? graph_launch(exec, kStream)
        : kind == "coop"
            ? coop(fn, 1, 1, 1, 1, 1, 1, 0, nullptr, nullptr)
            : launch(fn, 1, 1, 1, 1, 1, 1, 0, nullptr, nullptr, nullptr);
    if (rc != CUDA_SUCCESS) return 1;
    sync(kind == "graph" ? kStream : nullptr);
  }
  double wall = NowMs() - t0;
  auto launches = reinterpret_cast<CounterFn>(dlsym(RTLD_DEFAULT,
                                                    "vtpu_launches_total"));
  printf("wall=%.3fms iters=%d shim_launches=%llu own_busy_ns=%lld\n", wall,
         iters, launches ? (unsigned long long)launches() : 0ull,
         (long long)Driver("fake_own_busy_ns"));
  PrintCounters();
  return 0;
}

int64_t Counter(const char* name) {
  auto fn = reinterpret_cast<int64_t (*)()>(dlsym(RTLD_DEFAULT, name));
  return fn ? fn() : -1;
}

int64_t Driver(const char* name) {
  auto fn = reinterpret_cast<int64_t (*)()>(dlsym(g_driver, name));
  return fn ? fn() : -1;
}

int Capture() {
  const char* raw = getenv("SHIM_TEST_CAPTURE");
  int n = raw ? atoi(raw) : 8;
  auto launch = reinterpret_cast<LaunchFn>(Proc("cuLaunchKernel"));
  auto launch_ex = reinterpret_cast<LaunchExFn>(Proc("cuLaunchKernelEx"));
  auto coop = reinterpret_cast<CoopFn>(Proc("cuLaunchCooperativeKernel"));
  auto multi = reinterpret_cast<MultiFn>(
      Proc("cuLaunchCooperativeKernelMultiDevice"));
  auto begin = reinterpret_cast<BeginCaptureFn>(Proc("cuStreamBeginCapture"));
  auto end = reinterpret_cast<EndCaptureFn>(Proc("cuStreamEndCapture"));
  auto inst =
      reinterpret_cast<InstantiateFn>(Proc("cuGraphInstantiateWithFlags"));
  auto graph_launch = reinterpret_cast<GraphLaunchFn>(Proc("cuGraphLaunch"));
  auto sync = reinterpret_cast<SyncFn>(Proc("cuStreamSynchronize"));
  if (!launch || !launch_ex || !coop || !multi || !begin || !end || !inst ||
      !graph_launch || !sync) {
    fprintf(stderr, "driver entry points missing\n");
    return 2;
  }
  CUfunction fn = reinterpret_cast<CUfunction>(0x1234);
  // eager launches, the last ones left unsynchronized: samples in flight
  for (int i = 0; i < 6; i++)
    launch(fn, 1, 1, 1, 1, 1, 1, 0, kStream, nullptr, nullptr);
  int64_t charged0 = Counter("vtpu_charged_ns_total");
  int64_t launches0 = Counter("vtpu_launches_total");
  int64_t sampled0 = Counter("vtpu_sampled_launches_total");
  CUresult begin_rc = begin(kStream, CU_STREAM_CAPTURE_MODE_GLOBAL);
  CUlaunchConfig cfg = {1, 1, 1, 1, 1, 1, 0, kStream, nullptr, 0};
  int failed = 0;
  for (int i = 0; i < n; i++) {
    CUresult rc = i % 3 == 0   ? launch(fn, 1, 1, 1, 1, 1, 1, 0, kStream,
                                        nullptr, nullptr)
                  : i % 3 == 1 ? launch_ex(&cfg, fn, nullptr, nullptr)
                               : coop(fn, 1, 1, 1, 1, 1, 1, 0, kStream,
                                      nullptr);
    failed += rc != CUDA_SUCCESS;
  }
  CUgraph graph = nullptr;
  CUresult end_rc = end(kStream, &graph);
  int64_t charged1 = Counter("vtpu_charged_ns_total");
  int64_t launches1 = Counter("vtpu_launches_total");
  int64_t sampled1 = Counter("vtpu_sampled_launches_total");
  int64_t captured1 = Counter("vtpu_captured_launches_total");
  // the legacy stream while another stream captures in global mode: the
  // driver refuses the launch; the interposer charges nothing for it
  CUresult begin2_rc = begin(kStream, CU_STREAM_CAPTURE_MODE_GLOBAL);
  CUresult implicit_rc =
      launch(fn, 1, 1, 1, 1, 1, 1, 0, nullptr, nullptr, nullptr);
  CUgraph dropped = nullptr;
  end(kStream, &dropped);
  int64_t charged2 = Counter("vtpu_charged_ns_total");
  // the captured graph, replayed
  sync(kStream);
  CUgraphExec exec = nullptr;
  CUresult inst_rc = graph ? inst(&exec, graph, 0) : CUDA_ERROR_INVALID_VALUE;
  int64_t graphs0 = Counter("vtpu_graph_launches_total");
  int64_t fake_graphs0 = Driver("fake_graph_launches_total");
  int replays = 3;
  for (int i = 0; i < replays && exec; i++) {
    graph_launch(exec, kStream);
    sync(kStream);
  }
  int64_t graphs1 = Counter("vtpu_graph_launches_total");
  int64_t charged3 = Counter("vtpu_charged_ns_total");
  // one cooperative launch over two devices
  CUDA_LAUNCH_PARAMS list[2] = {
      {fn, 1, 1, 1, 1, 1, 1, 0, kStream, nullptr},
      {fn, 1, 1, 1, 1, 1, 1, 0, kStreamDev1, nullptr}};
  int64_t launches2 = Counter("vtpu_launches_total");
  CUresult multi_rc = multi(list, 2, 0);
  int64_t launches3 = Counter("vtpu_launches_total");
  sync(nullptr);
  printf("CAPTURE begin_rc=%d end_rc=%d failed=%d captured=%d "
         "charged_during=%lld launches_during=%lld sampled_during=%lld "
         "captured_counter=%lld begin2_rc=%d implicit_rc=%d "
         "charged_implicit=%lld inst_rc=%d replays=%d graph_launches=%lld "
         "fake_graph_launches=%lld charged_replays=%lld multi_rc=%d "
         "multi_launches=%lld\n",
         begin_rc, end_rc, failed, n, (long long)(charged1 - charged0),
         (long long)(launches1 - launches0), (long long)(sampled1 - sampled0),
         (long long)captured1, begin2_rc,
         implicit_rc, (long long)(charged2 - charged1), inst_rc, replays,
         (long long)(graphs1 - graphs0),
         (long long)(Driver("fake_graph_launches_total") - fake_graphs0),
         (long long)(charged3 - charged2), multi_rc,
         (long long)(launches3 - launches2));
  // another thread's metered launches during this thread's global-mode
  // capture: the interposer's event queries must not invalidate it
  const char* raw_cross = getenv("SHIM_TEST_CROSS");
  int cross = raw_cross ? atoi(raw_cross) : 24;
  int exec_us = getenv("FAKE_EXEC_US") ? atoi(getenv("FAKE_EXEC_US")) : 100;
  sync(kStream);
  sync(kStream2);
  int64_t launches4 = Counter("vtpu_launches_total");
  int64_t sampled4 = Counter("vtpu_sampled_launches_total");
  CUresult cross_begin_rc = begin(kStream, CU_STREAM_CAPTURE_MODE_GLOBAL);
  CUresult cross_captured_rc =
      launch(fn, 1, 1, 1, 1, 1, 1, 0, kStream, nullptr, nullptr);
  std::atomic<int> cross_failed{0};
  std::thread other([&] {
    for (int i = 0; i < cross; i++) {
      if (launch(fn, 1, 1, 1, 1, 1, 1, 0, kStream2, nullptr, nullptr) !=
          CUDA_SUCCESS)
        cross_failed++;
      usleep(2 * exec_us);  // the sample has finished by the next launch
    }
  });
  other.join();
  CUgraph cross_graph = nullptr;
  CUresult cross_end_rc = end(kStream, &cross_graph);
  int64_t launches5 = Counter("vtpu_launches_total");
  int64_t sampled5 = Counter("vtpu_sampled_launches_total");
  sync(kStream2);
  printf("CROSS begin_rc=%d captured_rc=%d end_rc=%d launches=%d failed=%d "
         "counted=%lld sampled=%lld\n",
         cross_begin_rc, cross_captured_rc, cross_end_rc, cross,
         cross_failed.load(), (long long)(launches5 - launches4 - 1),
         (long long)(sampled5 - sampled4));
  PrintCounters();
  return 0;
}

// The bytes an entry asks for, shaped for it: `bytes` is a multiple of
// 64 KiB. A mipmapped array has two levels, so it asks for 5/4 of `bytes`.
struct EntryCall {
  CUresult rc;
  uint64_t asked;
};

EntryCall AllocEntry(const std::string& entry, uint64_t bytes,
                     uintptr_t* handle) {
  CUdeviceptr ptr = 0;
  if (entry == "pitch") {
    size_t pitch = 0;
    auto fn = reinterpret_cast<PitchFn>(Proc("cuMemAllocPitch"));
    CUresult rc = fn(&ptr, &pitch, 65536, bytes / 65536, 4);
    *handle = ptr;
    return {rc, bytes};
  }
  if (entry == "managed") {
    auto fn = reinterpret_cast<ManagedFn>(Proc("cuMemAllocManaged"));
    CUresult rc = fn(&ptr, bytes, CU_MEM_ATTACH_GLOBAL);
    *handle = ptr;
    return {rc, bytes};
  }
  if (entry == "pool" || entry == "pool_ptsz") {
    CUmemoryPool pool = nullptr;
    reinterpret_cast<PoolFn>(Proc("cuDeviceGetDefaultMemPool"))(&pool, 0);
    auto fn = reinterpret_cast<FromPoolFn>(Proc(
        "cuMemAllocFromPoolAsync",
        entry == "pool" ? 0 : CU_GET_PROC_ADDRESS_PER_THREAD_DEFAULT_STREAM));
    CUresult rc = fn(&ptr, bytes, pool, nullptr);
    *handle = ptr;
    return {rc, bytes};
  }
  if (entry == "array") {
    CUDA_ARRAY_DESCRIPTOR d = {4096, bytes / (4096 * 4), CU_AD_FORMAT_FLOAT,
                               1};
    auto fn = reinterpret_cast<ArrayFn>(Proc("cuArrayCreate"));
    return {fn(reinterpret_cast<CUarray*>(handle), &d), bytes};
  }
  if (entry == "array3d") {
    CUDA_ARRAY3D_DESCRIPTOR d = {256, 64, bytes / (256 * 64 * 2 * 2),
                                 CU_AD_FORMAT_HALF, 2, 0};
    auto fn = reinterpret_cast<Array3DFn>(Proc("cuArray3DCreate"));
    return {fn(reinterpret_cast<CUarray*>(handle), &d), bytes};
  }
  if (entry == "mipmap") {
    // 2D, two levels: level 1 is a quarter of level 0
    CUDA_ARRAY3D_DESCRIPTOR d = {4096, bytes / 4096, 0,
                                 CU_AD_FORMAT_UNSIGNED_INT8, 1, 0};
    auto fn = reinterpret_cast<MipmapFn>(Proc("cuMipmappedArrayCreate"));
    return {fn(reinterpret_cast<CUmipmappedArray*>(handle), &d, 2),
            bytes + bytes / 4};
  }
  return {CUDA_ERROR_INVALID_VALUE, 0};
}

CUresult FreeEntry(const std::string& entry, uintptr_t handle) {
  if (entry == "array")
    return reinterpret_cast<ArrayDestroyFn>(Proc("cuArrayDestroy"))(
        reinterpret_cast<CUarray>(handle));
  if (entry == "array3d")
    return reinterpret_cast<ArrayDestroyFn>(Proc("cuArrayDestroy"))(
        reinterpret_cast<CUarray>(handle));
  if (entry == "mipmap")
    return reinterpret_cast<MipmapDestroyFn>(Proc("cuMipmappedArrayDestroy"))(
        reinterpret_cast<CUmipmappedArray>(handle));
  if (entry == "pool" || entry == "pool_ptsz")
    return reinterpret_cast<FreeAsyncFn>(Proc("cuMemFreeAsync"))(
        (CUdeviceptr)handle, nullptr);
  return reinterpret_cast<FreeFn>(Proc("cuMemFree"))((CUdeviceptr)handle);
}

int EntryCaps() {
  const char* entry_raw = getenv("SHIM_TEST_ENTRY");
  const char* big_raw = getenv("SHIM_TEST_BIG");
  const char* small_raw = getenv("SHIM_TEST_SMALL");
  auto info = reinterpret_cast<InfoFn>(Proc("cuMemGetInfo"));
  if (!entry_raw || !big_raw || !small_raw || !info) {
    fprintf(stderr, "--entry-caps needs SHIM_TEST_ENTRY, SHIM_TEST_BIG and "
            "SHIM_TEST_SMALL\n");
    return 2;
  }
  std::string entry = entry_raw;
  uint64_t big = strtoull(big_raw, nullptr, 10);
  uint64_t small = strtoull(small_raw, nullptr, 10);
  uintptr_t h = 0, h2 = 0;
  EntryCall over = AllocEntry(entry, big, &h);
  Verdict("over", over.rc);
  EntryCall got = AllocEntry(entry, small, &h);
  Verdict("granted", got.rc);
  size_t free_b = 0, total_b = 0;
  info(&free_b, &total_b);
  printf("MEMINFO held free=%zu total=%zu\n", free_b, total_b);
  printf("ASKED %llu\n", (unsigned long long)got.asked);
  Verdict("free", FreeEntry(entry, h));
  info(&free_b, &total_b);
  printf("MEMINFO freed free=%zu total=%zu\n", free_b, total_b);
  Verdict("again", AllocEntry(entry, small, &h2).rc);
  Verdict("free_again", FreeEntry(entry, h2));
  printf("FAKE_USED %lld\n", (long long)Driver("fake_used_bytes"));
  PrintCounters();
  return 0;
}

int Stress() {
  const char* raw = getenv("VTPU_MEM_LIMIT_0");
  if (!raw) {
    fprintf(stderr, "--stress needs VTPU_MEM_LIMIT_0\n");
    return 2;
  }
  const uint64_t cap = strtoull(raw, nullptr, 10);
  constexpr int kThreads = 8;
  constexpr int kIters = 2000;
  constexpr int kHeld = 4;
  auto alloc = reinterpret_cast<AllocFn>(Proc("cuMemAlloc"));
  auto release_ptr = reinterpret_cast<FreeFn>(Proc("cuMemFree"));
  auto launch = reinterpret_cast<LaunchFn>(Proc("cuLaunchKernel"));
  auto info = reinterpret_cast<InfoFn>(Proc("cuMemGetInfo"));
  auto fake_used =
      reinterpret_cast<CounterFn>(dlsym(g_driver, "fake_used_bytes"));
  auto forwarded =
      reinterpret_cast<CounterFn>(dlsym(g_driver, "fake_launches_total"));
  auto launches = reinterpret_cast<CounterFn>(
      dlsym(RTLD_DEFAULT, "vtpu_launches_total"));
  if (!alloc || !release_ptr || !launch || !info || !fake_used ||
      !forwarded || !launches) {
    fprintf(stderr, "entry points missing\n");
    return 2;
  }
  uint64_t launches_before = launches();
  uint64_t forwarded_before = forwarded();
  std::atomic<uint64_t> granted{0}, refused{0}, max_used{0};
  std::vector<std::thread> threads;
  for (int t = 0; t < kThreads; t++) {
    threads.emplace_back([&, t] {
      unsigned seed = 12345u + t;
      CUdeviceptr held[kHeld] = {};
      CUfunction fn = reinterpret_cast<CUfunction>(0x100 + t);
      for (int i = 0; i < kIters; i++) {
        int slot = i % kHeld;
        if (held[slot]) {
          release_ptr(held[slot]);
          held[slot] = 0;
        }
        size_t size = 1 + rand_r(&seed) % (cap / 8);
        if (alloc(&held[slot], size) == CUDA_SUCCESS) {
          granted++;
          uint64_t used = fake_used();
          uint64_t prev = max_used.load();
          while (used > prev && !max_used.compare_exchange_weak(prev, used)) {
          }
        } else {
          held[slot] = 0;
          refused++;
        }
        launch(fn, 1, 1, 1, 1, 1, 1, 0, nullptr, nullptr, nullptr);
      }
      for (CUdeviceptr p : held)
        if (p) release_ptr(p);
    });
  }
  for (auto& th : threads) th.join();
  size_t free_b = 0, total_b = 0;
  info(&free_b, &total_b);
  printf("STRESS granted=%llu refused=%llu max_used=%llu cap=%llu "
         "end_free=%zu end_used=%llu launches=%llu forwarded=%llu "
         "expected=%d\n",
         (unsigned long long)granted.load(),
         (unsigned long long)refused.load(),
         (unsigned long long)max_used.load(), (unsigned long long)cap, free_b,
         (unsigned long long)fake_used(),
         (unsigned long long)(launches() - launches_before),
         (unsigned long long)(forwarded() - forwarded_before),
         kThreads * kIters);
  return 0;
}


// The step ring's boundaries from a tenant with no Python (see the header).
int Steps() {
  auto env_int = [](const char* name, int dflt) {
    const char* v = getenv(name);
    return v && *v ? atoi(v) : dflt;
  };
  auto env_str = [](const char* name, const char* dflt) {
    const char* v = getenv(name);
    return std::string(v && *v ? v : dflt);
  };
  int iters = env_int("SHIM_TEST_ITERS", 10);
  int kernels = env_int("SHIM_TEST_KERNELS", 3);
  int replays = env_int("SHIM_TEST_REPLAYS", 1);
  int new_at = env_int("SHIM_TEST_NEW_AT", -1);
  int gap_us = env_int("SHIM_TEST_GAP_US", 0);
  size_t alloc_bytes = (size_t)env_int("SHIM_TEST_STEP_ALLOC", 0);
  std::string kind = env_str("SHIM_TEST_LAUNCH", "kernel");
  std::string sync_kind = env_str("SHIM_TEST_SYNC", "stream");
  std::string route = env_str("SHIM_TEST_ROUTE", "proc");
  std::string stop_file = env_str("SHIM_TEST_STOP_FILE", "");
  bool ptsz = sync_kind == "stream_ptsz";
  const char* name = sync_kind == "ctx"     ? "cuCtxSynchronize"
                     : sync_kind == "event" ? "cuEventSynchronize"
                     : ptsz && route != "proc" ? "cuStreamSynchronize_ptsz"
                                               : "cuStreamSynchronize";
  void* sync_fn =
      route == "dlsym"    ? dlsym(g_driver, name)
      : route == "export" ? dlsym(RTLD_DEFAULT, name)
                          : Proc(name, ptsz
                                 ? CU_GET_PROC_ADDRESS_PER_THREAD_DEFAULT_STREAM
                                 : 0);
  auto launch = reinterpret_cast<LaunchFn>(Proc("cuLaunchKernel"));
  auto graph_launch = reinterpret_cast<GraphLaunchFn>(Proc("cuGraphLaunch"));
  auto stream_sync = reinterpret_cast<SyncFn>(Proc("cuStreamSynchronize"));
  auto begin = reinterpret_cast<BeginCaptureFn>(Proc("cuStreamBeginCapture"));
  auto end = reinterpret_cast<EndCaptureFn>(Proc("cuStreamEndCapture"));
  using EventCreateFn = CUresult (*)(CUevent*, unsigned);
  using EventRecordFn = CUresult (*)(CUevent, CUstream);
  auto ev_create = reinterpret_cast<EventCreateFn>(Proc("cuEventCreate"));
  auto ev_record = reinterpret_cast<EventRecordFn>(Proc("cuEventRecord"));
  auto alloc = reinterpret_cast<AllocFn>(Proc("cuMemAlloc"));
  auto release_ptr = reinterpret_cast<FreeFn>(Proc("cuMemFree"));
  if ((sync_kind != "none" && !sync_fn) || !launch || !graph_launch ||
      !stream_sync || !begin || !end || !ev_create || !ev_record || !alloc ||
      !release_ptr) {
    fprintf(stderr, "driver entry points missing (%s via %s)\n", name,
            route.c_str());
    return 2;
  }
  CUevent ev = nullptr;
  ev_create(&ev, 0);
  auto sync = [&]() -> CUresult {
    if (sync_kind == "ctx")
      return reinterpret_cast<CUresult (*)()>(sync_fn)();
    if (sync_kind == "event") {
      ev_record(ev, kStream);
      return reinterpret_cast<CUresult (*)(CUevent)>(sync_fn)(ev);
    }
    return reinterpret_cast<SyncFn>(sync_fn)(kStream);
  };
  // a captured launch and a synchronisation of the capturing stream (which
  // fails): neither opens nor closes a step
  CUgraph dropped = nullptr;
  CUfunction captured = reinterpret_cast<CUfunction>(0x4fff);
  if (begin(kStream2, CU_STREAM_CAPTURE_MODE_RELAXED) == CUDA_SUCCESS) {
    launch(captured, 1, 1, 1, 1, 1, 1, 0, kStream2, nullptr, nullptr);
    CUresult rc = stream_sync(kStream2);
    end(kStream2, &dropped);
    printf("CAPTURED sync_rc=%d\n", rc);
  }
  auto epoch = reinterpret_cast<uint64_t (*)()>(
      dlsym(RTLD_DEFAULT, "vtpu_quota_epoch"));
  CUgraphExec exec = nullptr;
  if (kind == "graph" &&
      !(exec = CaptureOne(reinterpret_cast<CUfunction>(0x4ffe)))) {
    fprintf(stderr, "capturing the graph failed\n");
    return 1;
  }
  for (int i = 0; i < iters; i++) {
    if (!stop_file.empty() && access(stop_file.c_str(), F_OK) == 0) break;
    struct timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    uint64_t t0 = (uint64_t)ts.tv_sec * 1000000000ull + ts.tv_nsec;
    // step i holds (i % 3 + 1) x SHIM_TEST_STEP_ALLOC bytes until its end
    CUdeviceptr held = 0;
    if (alloc_bytes &&
        alloc(&held, alloc_bytes * (i % 3 + 1)) != CUDA_SUCCESS)
      return 1;
    int n = kind == "graph" ? replays : kernels;
    for (int k = 0; k < n; k++) {
      CUresult rc =
          kind == "graph"
              ? graph_launch(exec, kStream)
              : launch(reinterpret_cast<CUfunction>(0x5000 + 16 * k), 1, 1, 1,
                       1, 1, 1, 0, kStream, nullptr, nullptr);
      if (rc != CUDA_SUCCESS) return 1;
    }
    if (i == new_at &&
        launch(reinterpret_cast<CUfunction>(0x6000), 1, 1, 1, 1, 1, 1, 0,
               kStream, nullptr, nullptr) != CUDA_SUCCESS)
      return 1;
    if (sync_kind == "none") {
      usleep(gap_us);
    } else if (sync() != CUDA_SUCCESS || sync() != CUDA_SUCCESS) {
      return 1;
    }
    if (held) release_ptr(held);
    clock_gettime(CLOCK_MONOTONIC, &ts);
    uint64_t t1 = (uint64_t)ts.tv_sec * 1000000000ull + ts.tv_nsec;
    printf("STEP %d %llu %llu %lld\n", i, (unsigned long long)t0,
           (unsigned long long)t1, epoch ? (long long)epoch() : -1ll);
  }
  printf("STEPS records=%lld\n", (long long)Counter("vtpu_step_records_total"));
  PrintCounters();
  return 0;
}

int Comm() {
  const char* spec_raw = getenv("SHIM_TEST_COMM");
  std::string spec = spec_raw ? spec_raw : "";
  const char* ptds_raw = getenv("SHIM_TEST_PTDS");
  bool ptds = ptds_raw && strcmp(ptds_raw, "1") == 0;
  const char* cap_raw = getenv("SHIM_TEST_CAPTURE");
  bool capture = cap_raw && strcmp(cap_raw, "1") == 0;
  cuuint64_t flags = ptds ? CU_GET_PROC_ADDRESS_PER_THREAD_DEFAULT_STREAM : 0;
  using HtoDFn = CUresult (*)(CUdeviceptr, const void*, size_t);
  using DtoHFn = CUresult (*)(void*, CUdeviceptr, size_t);
  using HtoDAsyncFn = CUresult (*)(CUdeviceptr, const void*, size_t,
                                   CUstream);
  using DtoHAsyncFn = CUresult (*)(void*, CUdeviceptr, size_t, CUstream);
  using UnifiedFn = CUresult (*)(CUdeviceptr, CUdeviceptr, size_t);
  using UnifiedAsyncFn = CUresult (*)(CUdeviceptr, CUdeviceptr, size_t,
                                      CUstream);
  auto htod = reinterpret_cast<HtoDFn>(Proc("cuMemcpyHtoD", flags));
  auto dtoh = reinterpret_cast<DtoHFn>(Proc("cuMemcpyDtoH", flags));
  auto htod_async =
      reinterpret_cast<HtoDAsyncFn>(Proc("cuMemcpyHtoDAsync", flags));
  auto dtoh_async =
      reinterpret_cast<DtoHAsyncFn>(Proc("cuMemcpyDtoHAsync", flags));
  auto unified = reinterpret_cast<UnifiedFn>(Proc("cuMemcpy", flags));
  auto unified_async =
      reinterpret_cast<UnifiedAsyncFn>(Proc("cuMemcpyAsync", flags));
  auto launch = reinterpret_cast<LaunchFn>(Proc("cuLaunchKernel", flags));
  auto launch_ex = reinterpret_cast<LaunchExFn>(Proc("cuLaunchKernelEx",
                                                     flags));
  auto sync = reinterpret_cast<SyncFn>(Proc("cuStreamSynchronize", flags));
  auto alloc = reinterpret_cast<AllocFn>(Proc("cuMemAlloc"));
  auto begin = reinterpret_cast<BeginCaptureFn>(Proc("cuStreamBeginCapture"));
  auto end = reinterpret_cast<EndCaptureFn>(Proc("cuStreamEndCapture"));
  if (!htod || !dtoh || !htod_async || !dtoh_async || !unified ||
      !unified_async || !launch || !launch_ex || !sync || !alloc || !begin ||
      !end) {
    fprintf(stderr, "driver entry points missing\n");
    return 2;
  }
  CUstream stream = ptds ? nullptr : kStream;
  CUdeviceptr dev = 0, dev2 = 0;
  if (alloc(&dev, 1 << 24) != CUDA_SUCCESS ||
      alloc(&dev2, 1 << 24) != CUDA_SUCCESS)
    return 1;
  std::vector<char> host(1 << 24), host2(1 << 24);
  auto host_ptr = [](void* p) { return (CUdeviceptr)(uintptr_t)p; };
  CUfunction fn = reinterpret_cast<CUfunction>(0x1234);
  size_t pos = 0;
  while (pos < spec.size()) {
    size_t comma = spec.find(',', pos);
    std::string item = spec.substr(pos, comma == std::string::npos
                                            ? std::string::npos
                                            : comma - pos);
    pos = comma == std::string::npos ? spec.size() : comma + 1;
    size_t colon = item.find(':');
    std::string op = item.substr(0, colon);
    size_t n = colon == std::string::npos ? 1 : strtoull(
        item.c_str() + colon + 1, nullptr, 10);
    CUresult rc = CUDA_SUCCESS;
    if (op == "htod") {
      rc = htod(dev, host.data(), n);
    } else if (op == "dtoh") {
      rc = dtoh(host.data(), dev, n);
    } else if (op == "htod_async") {
      rc = htod_async(dev, host.data(), n, stream);
    } else if (op == "dtoh_async") {
      rc = dtoh_async(host.data(), dev, n, stream);
    } else if (op == "dtod_async" || op == "unified_dtod") {
      rc = op == "unified_dtod" ? unified(dev2, dev, n)
                                : unified_async(dev2, dev, n, stream);
    } else if (op == "unified_htod") {
      rc = unified(dev, host_ptr(host.data()), n);
    } else if (op == "unified_dtoh") {
      rc = unified(host_ptr(host.data()), dev + 16, n);
    } else if (op == "unified_async_htod") {
      rc = unified_async(dev, host_ptr(host.data()), n, stream);
    } else if (op == "unified_async_dtoh") {
      rc = unified_async(host_ptr(host.data()), dev, n, stream);
    } else if (op == "unified_hh") {
      rc = unified(host_ptr(host2.data()), host_ptr(host.data()), n);
    } else if (op == "nccl" || op == "kernel") {
      CUfunction f = reinterpret_cast<CUfunction>(op == "nccl" ? 0x9000
                                                               : 0x1238);
      for (size_t i = 0; i < n && rc == CUDA_SUCCESS; i++)
        rc = launch(f, 1, 1, 1, 1, 1, 1, 0, stream, nullptr, nullptr);
    } else if (op == "nccl_kernel") {
      CUlaunchConfig config = {};
      config.gridDimX = config.gridDimY = config.gridDimZ = 1;
      config.blockDimX = config.blockDimY = config.blockDimZ = 1;
      config.hStream = stream;
      for (size_t i = 0; i < n && rc == CUDA_SUCCESS; i++)
        rc = launch_ex(&config, reinterpret_cast<CUfunction>(0xa000),
                       nullptr, nullptr);
    } else {
      fprintf(stderr, "unknown op %s\n", op.c_str());
      return 2;
    }
    // one step: the op, a launch and a synchronisation
    if (rc != CUDA_SUCCESS ||
        launch(fn, 1, 1, 1, 1, 1, 1, 0, stream, nullptr, nullptr) !=
            CUDA_SUCCESS ||
        sync(stream) != CUDA_SUCCESS) {
      fprintf(stderr, "op %s failed (rc=%d)\n", op.c_str(), rc);
      return 1;
    }
  }
  CUresult capture_rc = CUDA_SUCCESS;
  if (capture) {
    CUgraph graph = nullptr;
    if (begin(kStream2, CU_STREAM_CAPTURE_MODE_GLOBAL) != CUDA_SUCCESS)
      return 1;
    htod_async(dev, host.data(), 4096, kStream2);
    launch(reinterpret_cast<CUfunction>(0x9000), 1, 1, 1, 1, 1, 1, 0,
           kStream2, nullptr, nullptr);
    capture_rc = end(kStream2, &graph);
    // the graph is never replayed; one more step closes the ring's record
    if (launch(fn, 1, 1, 1, 1, 1, 1, 0, stream, nullptr, nullptr) !=
            CUDA_SUCCESS ||
        sync(stream) != CUDA_SUCCESS)
      return 1;
  }
  printf("COMM comm_time_ns=%lld comm_bytes=%lld collectives=%lld "
         "copies=%lld capture_rc=%d records=%lld\n",
         (long long)Counter("vtpu_comm_time_ns_total"),
         (long long)Counter("vtpu_comm_bytes_total"),
         (long long)Counter("vtpu_collectives_total"),
         (long long)Driver("fake_copies_total"), (int)capture_rc,
         (long long)Counter("vtpu_step_records_total"));
  PrintCounters();
  return 0;
}

// The interposer's active excess table, after a few metered steps.
int Excess() {
  const char* raw = getenv("SHIM_TEST_ITERS");
  int iters = raw ? atoi(raw) : 20;
  auto launch = reinterpret_cast<LaunchFn>(Proc("cuLaunchKernel"));
  auto sync = reinterpret_cast<SyncFn>(Proc("cuStreamSynchronize"));
  auto excess = reinterpret_cast<int64_t (*)(int64_t)>(
      dlsym(RTLD_DEFAULT, "vtpu_obs_excess_at_us"));
  if (!launch || !sync || !excess) {
    fprintf(stderr, "entry points missing\n");
    return 2;
  }
  CUfunction fn = reinterpret_cast<CUfunction>(0x1234);
  for (int i = 0; i < iters; i++) {
    if (launch(fn, 1, 1, 1, 1, 1, 1, 0, kStream, nullptr, nullptr) !=
        CUDA_SUCCESS)
      return 1;
    sync(kStream);
  }
  usleep(50000);  // a few of the watcher's ticks
  printf("EXCESS");
  const char* gaps = getenv("SHIM_TEST_GAPS");
  for (const char* p = gaps ? gaps : ""; *p;) {
    char* end = nullptr;
    long long gap = strtoll(p, &end, 10);
    if (end == p) break;
    printf(" %lld=%lld", gap, (long long)excess(gap));
    p = *end == ',' ? end + 1 : end;
  }
  printf("\n");
  PrintCounters();
  return 0;
}

}  // namespace

int main(int argc, char** argv) {
  const char* real = getenv("VTPU_REAL_CUDA_LIBRARY_PATH");
  g_driver = dlopen(real ? real : "libcuda.so.1", RTLD_NOW | RTLD_LOCAL);
  if (!g_driver) {
    fprintf(stderr, "cannot open the driver: %s\n", dlerror());
    return 2;
  }
  g_get_proc =
      reinterpret_cast<GetProcV2>(dlsym(g_driver, "cuGetProcAddress_v2"));
  if (!g_get_proc) {
    fprintf(stderr, "driver has no cuGetProcAddress_v2\n");
    return 2;
  }
  const char* mode = argc > 1 ? argv[1] : "";
  if (strcmp(mode, "--routes") == 0) return Routes();
  if (strcmp(mode, "--caps") == 0) return Caps();
  if (strcmp(mode, "--throttle-only") == 0) return ThrottleOnly();
  if (strcmp(mode, "--stress") == 0) return Stress();
  if (strcmp(mode, "--alloc") == 0) return Alloc();
  if (strcmp(mode, "--overflow") == 0) return Overflow();
  if (strcmp(mode, "--capture") == 0) return Capture();
  if (strcmp(mode, "--entry-caps") == 0) return EntryCaps();
  if (strcmp(mode, "--steps") == 0) return Steps();
  if (strcmp(mode, "--excess") == 0) return Excess();
  if (strcmp(mode, "--comm") == 0) return Comm();
  fprintf(stderr, "usage: %s --routes|--caps|--throttle-only|--alloc|"
          "--overflow|--stress|--capture|--entry-caps|--steps|--excess|"
          "--comm\n", argv[0]);
  return 2;
}
