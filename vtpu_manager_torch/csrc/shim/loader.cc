// loader.cc — real-driver loading, config, and symbol routing.
//
// Ports library/src/loader.cc (OpenRealPlugin:64, SynthesizeFromEnv:125,
// LoadConfig:182) from a PJRT plugin interposer to a CUDA driver-API one.
// The config comes from the environment only; the node's config file is
// read once the port has its copy of that layout.
// A PJRT plugin is reached through one GetPjrtApi table; the CUDA driver is
// reached three ways, and all three are routed to the hooks:
//   1. exported names: the hooks carry the driver's names, and LD_PRELOAD
//      puts them ahead of libcuda.so.1 in the global scope;
//   2. the dlsym override: the CUDA runtime opens libcuda.so.1 itself and
//      asks dlsym(handle, "cuGetProcAddress_v2"), which only an exported
//      dlsym catches;
//   3. cuGetProcAddress(_v2): the runtime, cuBLAS and PyTorch resolve every
//      driver entry point through it. The hook asks the real driver first
//      and maps the real address it returns onto the hook for the same
//      address, so the exact _v2/_ptsz variant the caller asked for is the
//      one it gets.
// Nothing here runs in a constructor: the real driver is opened on the
// first call that needs it.

#include <dlfcn.h>
#include <stdarg.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <time.h>

#include <mutex>

#include "shim.h"

namespace vtpu_cuda {

namespace {

constexpr const char* kRealPathEnv = "VTPU_REAL_CUDA_LIBRARY_PATH";
constexpr const char* kDefaultReal = "libcuda.so.1";
void* const kMissing = reinterpret_cast<void*>(~uintptr_t{0});

using DlsymFn = void* (*)(void*, const char*);

std::atomic<uint64_t> g_proc_hooked{0};    // lookups answered with a hook

// glibc 2.34 moved dlsym into libc.so.6; older glibcs have it in libdl at
// GLIBC_2.2.5. dlvsym is not overridden, so this cannot recurse.
DlsymFn RealDlsym() {
  static std::atomic<DlsymFn> cached{nullptr};
  DlsymFn fn = cached.load(std::memory_order_acquire);
  if (fn) return fn;
  fn = reinterpret_cast<DlsymFn>(dlvsym(RTLD_NEXT, "dlsym", "GLIBC_2.34"));
  if (!fn)
    fn = reinterpret_cast<DlsymFn>(dlvsym(RTLD_NEXT, "dlsym", "GLIBC_2.2.5"));
  cached.store(fn, std::memory_order_release);
  return fn;
}

void* RealHandle() {
  static std::once_flag once;
  static void* handle = nullptr;
  std::call_once(once, [] {
    const char* path = getenv(kRealPathEnv);
    if (!path || !*path) path = kDefaultReal;
    handle = dlopen(path, RTLD_NOW | RTLD_LOCAL);
    if (!handle)
      Log(kLogError, "cannot open the real driver %s: %s", path, dlerror());
    else
      Log(kLogInfo, "real driver: %s", path);
  });
  return handle;
}

int64_t EnvInt(const char* base, int i, int64_t fallback) {
  char name[96];
  snprintf(name, sizeof(name), "%s_%d", base, i);
  const char* raw = getenv(name);
  if (!raw || !*raw) raw = getenv(base);
  if (!raw || !*raw) return fallback;
  return strtoll(raw, nullptr, 10);
}

// Per-device limits from the VTPU_* environment, the same variables the
// JAX package's shim reads when no config file is mounted.
Config SynthesizeFromEnv() {
  Config c;
  const char* level = getenv("VTPU_LOGGER_LEVEL");
  if (level && *level) c.log_level = atoi(level);
  const char* disable = getenv("DISABLE_VTPU_CONTROL");
  c.disabled = disable && *disable;
  for (int i = 0; i < kMaxDevices; i++) {
    int64_t mem = EnvInt("VTPU_MEM_LIMIT", i, 0);
    int64_t core = EnvInt("VTPU_CORE_LIMIT", i, 0);
    c.mem_limit[i] = mem > 0 ? mem : 0;
    c.core_limit[i] = (core > 0 && core < 100) ? (int)core : 0;
  }
  return c;
}

struct Route {
  const char* name;
  void* hook;
  void* real;
};

// Every hooked symbol, by its exported driver name.
Route g_routes[] = {
    {"cuLaunchKernel", (void*)&cuLaunchKernel, nullptr},
    {"cuLaunchKernel_ptsz", (void*)&cuLaunchKernel_ptsz, nullptr},
    {"cuLaunchKernelEx", (void*)&cuLaunchKernelEx, nullptr},
    {"cuLaunchKernelEx_ptsz", (void*)&cuLaunchKernelEx_ptsz, nullptr},
    {"cuMemAlloc_v2", (void*)&cuMemAlloc_v2, nullptr},
    {"cuMemAllocAsync", (void*)&cuMemAllocAsync, nullptr},
    {"cuMemAllocAsync_ptsz", (void*)&cuMemAllocAsync_ptsz, nullptr},
    {"cuMemFree_v2", (void*)&cuMemFree_v2, nullptr},
    {"cuMemFreeAsync", (void*)&cuMemFreeAsync, nullptr},
    {"cuMemFreeAsync_ptsz", (void*)&cuMemFreeAsync_ptsz, nullptr},
    {"cuMemCreate", (void*)&cuMemCreate, nullptr},
    {"cuMemRelease", (void*)&cuMemRelease, nullptr},
    {"cuMemGetInfo_v2", (void*)&cuMemGetInfo_v2, nullptr},
    {"cuDeviceTotalMem_v2", (void*)&cuDeviceTotalMem_v2, nullptr},
    {"cuGetProcAddress", (void*)&cuGetProcAddress, nullptr},
    {"cuGetProcAddress_v2", (void*)&cuGetProcAddress_v2, nullptr},
};

void* HookByName(const char* name) {
  for (const Route& r : g_routes)
    if (strcmp(r.name, name) == 0) return r.hook;
  return nullptr;
}

// The real address of every hooked name, from the real driver's exports.
void BuildRoutes() {
  static std::once_flag once;
  std::call_once(once, [] {
    void* handle = RealHandle();
    DlsymFn real_dlsym = RealDlsym();
    if (!handle || !real_dlsym) return;
    for (Route& r : g_routes) r.real = real_dlsym(handle, r.name);
  });
}

// The hook for a real address, or the address itself when it is not hooked.
void* RouteProcAddress(const char* symbol, void* real) {
  BuildRoutes();
  for (const Route& r : g_routes) {
    if (r.real && r.real == real) {
      g_proc_hooked.fetch_add(1, std::memory_order_relaxed);
      return r.hook;
    }
  }
  Log(kLogDebug, "cuGetProcAddress(%s) passes through", symbol);
  return real;
}

}  // namespace

const Config& Cfg() {
  static Config cfg = SynthesizeFromEnv();
  return cfg;
}

void Log(int level, const char* fmt, ...) {
  if (level > Cfg().log_level) return;
  static const char* kNames[] = {"ERROR", "WARN", "INFO", "DEBUG"};
  char buf[512];
  va_list ap;
  va_start(ap, fmt);
  vsnprintf(buf, sizeof(buf), fmt, ap);
  va_end(ap);
  fprintf(stderr, "[vtpu-cuda %s] %s\n", kNames[level < 0 ? 0 : level > 3 ? 3
                                                                      : level],
          buf);
}

uint64_t NowNs() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return (uint64_t)ts.tv_sec * 1000000000ull + (uint64_t)ts.tv_nsec;
}

void* RealSymCached(const char* name, std::atomic<void*>* cache) {
  void* fn = cache->load(std::memory_order_acquire);
  if (fn) return fn == kMissing ? nullptr : fn;
  void* handle = RealHandle();
  DlsymFn real_dlsym = RealDlsym();
  fn = (handle && real_dlsym) ? real_dlsym(handle, name) : nullptr;
  if (!fn) Log(kLogWarn, "real driver has no %s", name);
  cache->store(fn ? fn : kMissing, std::memory_order_release);
  return fn;
}

int CurrentSlot() {
  auto get_device = VTPU_REAL_AS(PFN_cuCtxGetDevice, "cuCtxGetDevice");
  CUdevice dev = 0;
  if (!get_device || get_device(&dev) != CUDA_SUCCESS) return 0;
  return (dev >= 0 && dev < kMaxDevices) ? dev : 0;
}

}  // namespace vtpu_cuda

using namespace vtpu_cuda;

// Route 2: the dlsym override. A thread-local depth guard sends any
// re-entrant lookup straight to the real dlsym.
VTPU_EXPORT void* dlsym(void* handle, const char* name) {
  static thread_local int depth = 0;
  DlsymFn real = RealDlsym();
  if (depth > 0 || name[0] != 'c' || name[1] != 'u')
    return real ? real(handle, name) : nullptr;
  depth++;
  void* hook = HookByName(name);
  void* out = hook ? hook : (real ? real(handle, name) : nullptr);
  depth--;
  return out;
}

// Route 3: cuGetProcAddress, both ABIs.
VTPU_EXPORT CUresult cuGetProcAddress(const char* symbol, void** pfn,
                                      int cuda_version, cuuint64_t flags) {
  auto real = VTPU_REAL(cuGetProcAddress);
  if (!real) return CUDA_ERROR_NOT_INITIALIZED;
  CUresult rc = real(symbol, pfn, cuda_version, flags);
  if (rc == CUDA_SUCCESS && symbol && pfn && *pfn)
    *pfn = RouteProcAddress(symbol, *pfn);
  return rc;
}

VTPU_EXPORT CUresult cuGetProcAddress_v2(
    const char* symbol, void** pfn, int cuda_version, cuuint64_t flags,
    CUdriverProcAddressQueryResult* status) {
  auto real = VTPU_REAL(cuGetProcAddress_v2);
  if (!real) return CUDA_ERROR_NOT_INITIALIZED;
  CUresult rc = real(symbol, pfn, cuda_version, flags, status);
  if (rc == CUDA_SUCCESS && symbol && pfn && *pfn)
    *pfn = RouteProcAddress(symbol, *pfn);
  return rc;
}

// Counters a tenant reads over ctypes.
VTPU_EXPORT uint64_t vtpu_proc_address_hooked_total() {
  return g_proc_hooked.load(std::memory_order_relaxed);
}
