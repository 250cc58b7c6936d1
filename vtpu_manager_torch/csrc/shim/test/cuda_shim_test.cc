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
//                    and the interposer's counters (COUNTERS name=value ...)
//   --alloc          allocates each size of SHIM_TEST_ALLOCS (comma-separated
//                    bytes) and keeps what it got, prints a VERDICT per size
//                    and HELD, then holds it until SHIM_TEST_HOLD_FILE exists
//                    (a second process of the same tenant, a co-tenant, or
//                    a SIGKILL meets it there)
//   --stress         threads allocating, freeing and launching at once: the
//                    cap holds at every moment, the ledger drains to zero
//                    and every launch is counted
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
  auto v1 = reinterpret_cast<GetProcV1>(Proc("cuGetProcAddress", 0, 11030));
  void* via_v1 = nullptr;
  if (v1) v1("cuLaunchKernel", &via_v1, 12000, 0);
  ok &= Expect("proc-v1:cuGetProcAddress", (void*)v1, shim_base,
               "cuGetProcAddress");
  ok &= Expect("proc-v1:cuLaunchKernel", via_v1, shim_base, "cuLaunchKernel");
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
      "vtpu_blind_ticks_total",     "vtpu_oom_rejected_total"};
  printf("COUNTERS");
  for (const char* name : kNames) {
    auto fn = reinterpret_cast<int64_t (*)()>(dlsym(RTLD_DEFAULT, name));
    printf(" %s=%lld", name, fn ? (long long)fn() : -1ll);
  }
  auto up = reinterpret_cast<int (*)(int)>(dlsym(RTLD_DEFAULT,
                                                 "vtpu_up_limit"));
  printf(" vtpu_up_limit=%d\n", up ? up(0) : -1);
}

int Alloc() {
  auto alloc = reinterpret_cast<AllocFn>(Proc("cuMemAlloc"));
  auto release_ptr = reinterpret_cast<FreeFn>(Proc("cuMemFree"));
  if (!alloc || !release_ptr) {
    fprintf(stderr, "driver entry points missing\n");
    return 2;
  }
  const char* raw = getenv("SHIM_TEST_ALLOCS");
  std::vector<CUdeviceptr> held;
  int i = 0;
  for (const char* p = raw ? raw : ""; *p; i++) {
    char* end = nullptr;
    size_t bytes = strtoull(p, &end, 10);
    CUdeviceptr ptr = 0;
    CUresult rc = alloc(&ptr, bytes);
    printf("VERDICT alloc%d %d\n", i, rc);
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

int ThrottleOnly() {
  const char* raw = getenv("SHIM_TEST_ITERS");
  int iters = raw ? atoi(raw) : 100;
  auto launch = reinterpret_cast<LaunchFn>(Proc("cuLaunchKernel"));
  auto sync = reinterpret_cast<SyncFn>(Proc("cuStreamSynchronize"));
  if (!launch || !sync) {
    fprintf(stderr, "driver entry points missing\n");
    return 2;
  }
  // one distinct "kernel" handle, as a real module's function would be
  CUfunction fn = reinterpret_cast<CUfunction>(0x1234);
  double t0 = NowMs();
  for (int i = 0; i < iters; i++) {
    if (launch(fn, 1, 1, 1, 1, 1, 1, 0, nullptr, nullptr, nullptr) !=
        CUDA_SUCCESS)
      return 1;
    sync(nullptr);
  }
  double wall = NowMs() - t0;
  auto launches = reinterpret_cast<CounterFn>(dlsym(RTLD_DEFAULT,
                                                    "vtpu_launches_total"));
  printf("wall=%.3fms iters=%d shim_launches=%llu\n", wall, iters,
         launches ? (unsigned long long)launches() : 0ull);
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
  fprintf(stderr, "usage: %s --routes|--caps|--throttle-only|--alloc|"
          "--stress\n",
          argv[0]);
  return 2;
}
