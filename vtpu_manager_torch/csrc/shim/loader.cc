// loader.cc — real-driver loading, config, and symbol routing.
//
// Ports library/src/loader.cc (OpenRealPlugin:64, LoadConfigFile:92,
// SynthesizeFromEnv:125, LoadConfig:182, MapTcUtil:211) from a PJRT plugin
// interposer to a CUDA driver-API one. The limits come from the container's
// vtpu.config (VTPU_CONFIG_PATH) when it validates, else from the VTPU_*
// environment, in the reference's order.
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
#include <fcntl.h>
#include <stdarg.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <spawn.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <sys/wait.h>
#include <time.h>
#include <unistd.h>

#include <mutex>
#include <string>

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

using namespace vtpu_abi;

constexpr const char* kDefaultConfigPath = "/etc/vtpu-manager/config/vtpu.config";
constexpr const char* kDefaultFeedPath =
    "/etc/vtpu-manager/watcher/tc_util.config";

int64_t EnvInt(const char* base, int i, int64_t fallback) {
  char name[96];
  snprintf(name, sizeof(name), "%s_%d", base, i);
  const char* raw = getenv(name);
  if (!raw || !*raw) raw = getenv(base);
  if (!raw || !*raw) return fallback;
  return strtoll(raw, nullptr, 10);
}

// The file's device at local position i as the slot's limits.
DeviceLimits FromFile(const VtpuDevice& d) {
  DeviceLimits out;
  out.present = true;
  out.mem_limit = d.memory_limit ? (int64_t)d.total_memory : 0;
  out.real_memory = (int64_t)d.real_memory;
  out.hard_core = d.hard_core;
  out.soft_core = d.soft_core;
  out.core_limit = d.core_limit;
  out.lease_core = d.lease_core;
  out.host_index = d.host_index;
  memcpy(out.uuid, d.uuid, sizeof(out.uuid));
  out.uuid[sizeof(out.uuid) - 1] = 0;
  return out;
}

// Size, magic, version, checksum, then the device count, as the
// reference validates the file (loader.cc:92-114).
bool LoadConfigFile(const char* path, Config* out) {
  int fd = open(path, O_RDONLY | O_CLOEXEC);
  if (fd < 0) return false;
  struct stat st;
  if (fstat(fd, &st) != 0 || (size_t)st.st_size != sizeof(VtpuConfig)) {
    close(fd);
    fprintf(stderr, "[vtpu-cuda WARN] config %s has the wrong size\n", path);
    return false;
  }
  void* mem = mmap(nullptr, sizeof(VtpuConfig), PROT_READ, MAP_PRIVATE, fd, 0);
  close(fd);
  if (mem == MAP_FAILED) return false;
  const auto* cfg = static_cast<const VtpuConfig*>(mem);
  bool ok = cfg->magic == kConfigMagic && cfg->version == kConfigVersion &&
            cfg->pad_ == 0 &&
            cfg->checksum == Fnv1a(static_cast<const uint8_t*>(mem),
                                   offsetof(VtpuConfig, checksum)) &&
            cfg->device_count >= 0 && cfg->device_count <= kMaxDeviceCount;
  if (ok) {
    out->compat_mode = cfg->compat_mode;
    out->device_count = cfg->device_count < kMaxDevices ? cfg->device_count
                                                        : kMaxDevices;
    for (int i = 0; i < out->device_count; i++)
      out->dev[i] = FromFile(cfg->devices[i]);
    out->workload_class = cfg->workload_class;
    out->quota_epoch = cfg->quota_epoch;
    out->migration_freeze = cfg->migration_freeze;
    out->freeze_epoch = cfg->freeze_epoch;
    out->from_file = true;
  } else {
    fprintf(stderr, "[vtpu-cuda ERROR] config %s failed validation\n", path);
  }
  munmap(mem, sizeof(VtpuConfig));
  return ok;
}

// Per-device limits from the VTPU_* environment (loader.cc:125-180): the
// same variables the JAX package's shim reads when no file is mounted.
bool SynthesizeFromEnv(Config* out) {
  bool any = getenv("VTPU_MEM_LIMIT") || getenv("VTPU_MEM_LIMIT_0") ||
             getenv("VTPU_CORE_LIMIT") || getenv("VTPU_CORE_LIMIT_0");
  if (!any) return false;
  const char* compat = getenv("MANAGER_COMPATIBILITY_MODE");
  out->compat_mode = compat && *compat ? atoi(compat) : kCompatHost;
  int hosts[kMaxDevices] = {};
  int count = 0;
  const char* visible = getenv("MANAGER_VISIBLE_DEVICES");
  if (visible && *visible) {
    char tmp[256];
    snprintf(tmp, sizeof(tmp), "%s", visible);
    char* save = nullptr;
    for (char* tok = strtok_r(tmp, ",", &save); tok && count < kMaxDevices;
         tok = strtok_r(nullptr, ",", &save))
      hosts[count++] = atoi(tok);
  } else {
    count = 1;
  }
  for (int i = 0; i < count; i++) {
    DeviceLimits& d = out->dev[i];
    int64_t mem = EnvInt("VTPU_MEM_LIMIT", i, 0);
    int64_t core = EnvInt("VTPU_CORE_LIMIT", i, 0);
    int64_t soft = EnvInt("VTPU_CORE_SOFT_LIMIT", i, core);
    d.present = true;
    d.mem_limit = mem > 0 ? mem : 0;
    d.real_memory = EnvInt("VTPU_MEM_REAL", i, 0);
    if (d.real_memory < 0) d.real_memory = 0;
    d.hard_core = (int)core;
    d.soft_core = (int)soft;
    d.core_limit = core <= 0      ? kCoreLimitNone
                   : soft > core  ? kCoreLimitSoft
                                  : kCoreLimitHard;
    d.host_index = hosts[i];
  }
  out->device_count = count;
  return true;
}

const char* ConfigPath() {
  const char* path = getenv("VTPU_CONFIG_PATH");
  return path && *path ? path : kDefaultConfigPath;
}

Config LoadConfig() {
  Config c;
  const char* level = getenv("VTPU_LOGGER_LEVEL");
  if (level && *level) c.log_level = atoi(level);
  const char* disable = getenv("DISABLE_VTPU_CONTROL");
  c.disabled = disable && *disable;
  if (c.disabled) return c;
  if (!LoadConfigFile(ConfigPath(), &c)) SynthesizeFromEnv(&c);
  return c;
}

// The registrar beside this interposer: the directory that holds the
// loaded interposer (the driver mount in a container, the build dir in the
// tests), else empty.
std::string ScriptBesideInterposer() {
  Dl_info info;
  if (dladdr(reinterpret_cast<void*>(&ScriptBesideInterposer), &info) == 0 ||
      !info.dli_fname)
    return "";
  std::string path = info.dli_fname;
  size_t slash = path.rfind('/');
  path = (slash == std::string::npos ? std::string(".")
                                     : path.substr(0, slash)) +
         "/vtpu_device_client.py";
  return access(path.c_str(), R_OK) == 0 ? path : "";
}

// CLIENT compat mode: announces this container to the node registry, so
// the node can attest its pids into pids.config (library/src/loader.cc:301
// SpawnDeviceClient). The command, in the reference's order:
// VTPU_DEVICE_CLIENT_CMD; the stdlib-only registrar the node installs
// beside the interposer (vtpu_manager_torch/tools/vtpu_device_client.py:
// a tenant image need not carry the package); the port's runtime client
// as a module, a fallback for development. It runs in the background of a
// shell that exits at once, so init reaps it and the tenant keeps no
// zombie; posix_spawn runs no fork handlers in a process whose threads may
// hold locks. Logs with fprintf: it runs while the config is being loaded.
void SpawnDeviceClient(int log_level) {
  const char* cmd = getenv("VTPU_DEVICE_CLIENT_CMD");
  std::string script_cmd;
  if (!cmd || !*cmd) {
    std::string script = ScriptBesideInterposer();
    if (!script.empty() && script.find('\'') == std::string::npos) {
      script_cmd = "python3 '" + script + "'";
      cmd = script_cmd.c_str();
    } else {
      cmd = "python3 -m vtpu_manager_torch.runtime.client";
    }
  }
  std::string line = std::string("(") + cmd + ") </dev/null &";
  char* argv[] = {const_cast<char*>("sh"), const_cast<char*>("-c"),
                  const_cast<char*>(line.c_str()), nullptr};
  posix_spawnattr_t attr;
  posix_spawnattr_init(&attr);
  posix_spawnattr_setflags(&attr, POSIX_SPAWN_SETSID);
  pid_t pid = 0;
  int rc = posix_spawn(&pid, "/bin/sh", nullptr, &attr, argv, environ);
  posix_spawnattr_destroy(&attr);
  int status = -1;
  if (rc == 0) waitpid(pid, &status, 0);
  if (rc == 0 && WIFEXITED(status) && WEXITSTATUS(status) == 0) {
    if (log_level >= kLogInfo)
      fprintf(stderr, "[vtpu-cuda INFO] device-client spawned: %s\n", cmd);
  } else {
    fprintf(stderr,
            "[vtpu-cuda ERROR] device-client spawn FAILED (rc=%d status=%d): "
            "%s\n", rc, status, cmd);
  }
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
    {"cuLaunchCooperativeKernel", (void*)&cuLaunchCooperativeKernel, nullptr},
    {"cuLaunchCooperativeKernel_ptsz", (void*)&cuLaunchCooperativeKernel_ptsz,
     nullptr},
    {"cuLaunchCooperativeKernelMultiDevice",
     (void*)&cuLaunchCooperativeKernelMultiDevice, nullptr},
    {"cuGraphLaunch", (void*)&cuGraphLaunch, nullptr},
    {"cuGraphLaunch_ptsz", (void*)&cuGraphLaunch_ptsz, nullptr},
    {"cuStreamSynchronize", (void*)&cuStreamSynchronize, nullptr},
    {"cuStreamSynchronize_ptsz", (void*)&cuStreamSynchronize_ptsz, nullptr},
    {"cuCtxSynchronize", (void*)&cuCtxSynchronize, nullptr},
    {"cuEventSynchronize", (void*)&cuEventSynchronize, nullptr},
    {"cuMemAlloc_v2", (void*)&cuMemAlloc_v2, nullptr},
    {"cuMemAllocPitch_v2", (void*)&cuMemAllocPitch_v2, nullptr},
    {"cuMemAllocManaged", (void*)&cuMemAllocManaged, nullptr},
    {"cuMemAllocFromPoolAsync", (void*)&cuMemAllocFromPoolAsync, nullptr},
    {"cuMemAllocFromPoolAsync_ptsz", (void*)&cuMemAllocFromPoolAsync_ptsz,
     nullptr},
    {"cuArrayCreate_v2", (void*)&cuArrayCreate_v2, nullptr},
    {"cuArray3DCreate_v2", (void*)&cuArray3DCreate_v2, nullptr},
    {"cuMipmappedArrayCreate", (void*)&cuMipmappedArrayCreate, nullptr},
    {"cuArrayDestroy", (void*)&cuArrayDestroy, nullptr},
    {"cuMipmappedArrayDestroy", (void*)&cuMipmappedArrayDestroy, nullptr},
    {"cuMemAllocAsync", (void*)&cuMemAllocAsync, nullptr},
    {"cuMemAllocAsync_ptsz", (void*)&cuMemAllocAsync_ptsz, nullptr},
    {"cuMemFree_v2", (void*)&cuMemFree_v2, nullptr},
    {"cuMemFreeAsync", (void*)&cuMemFreeAsync, nullptr},
    {"cuMemFreeAsync_ptsz", (void*)&cuMemFreeAsync_ptsz, nullptr},
    {"cuMemCreate", (void*)&cuMemCreate, nullptr},
    {"cuMemRelease", (void*)&cuMemRelease, nullptr},
    {"cuMemGetInfo_v2", (void*)&cuMemGetInfo_v2, nullptr},
    {"cuDeviceTotalMem_v2", (void*)&cuDeviceTotalMem_v2, nullptr},
    {"cuMemcpyHtoD_v2", (void*)&cuMemcpyHtoD_v2, nullptr},
    {"cuMemcpyHtoD_v2_ptds", (void*)&cuMemcpyHtoD_v2_ptds, nullptr},
    {"cuMemcpyDtoH_v2", (void*)&cuMemcpyDtoH_v2, nullptr},
    {"cuMemcpyDtoH_v2_ptds", (void*)&cuMemcpyDtoH_v2_ptds, nullptr},
    {"cuMemcpyHtoDAsync_v2", (void*)&cuMemcpyHtoDAsync_v2, nullptr},
    {"cuMemcpyHtoDAsync_v2_ptsz", (void*)&cuMemcpyHtoDAsync_v2_ptsz, nullptr},
    {"cuMemcpyDtoHAsync_v2", (void*)&cuMemcpyDtoHAsync_v2, nullptr},
    {"cuMemcpyDtoHAsync_v2_ptsz", (void*)&cuMemcpyDtoHAsync_v2_ptsz, nullptr},
    {"cuMemcpy", (void*)&cuMemcpy, nullptr},
    {"cuMemcpy_ptds", (void*)&cuMemcpy_ptds, nullptr},
    {"cuMemcpyAsync", (void*)&cuMemcpyAsync, nullptr},
    {"cuMemcpyAsync_ptsz", (void*)&cuMemcpyAsync_ptsz, nullptr},
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

// Loaded once; the quota market's reloader is armed as soon as the limits
// are known (it logs nothing: Log reads this config).
Config& MutableCfg() {
  static Config cfg = [] {
    Config c = LoadConfig();
    for (int i = 0; i < c.device_count; i++) {
      const DeviceLimits& d = c.dev[i];
      if (c.log_level >= kLogInfo)
        fprintf(stderr,
                "[vtpu-cuda INFO] device[%d] from %s: host=%d cap=%lld "
                "real=%lld core=%d..%d policy=%d\n",
                i, c.from_file ? "config file" : "environment", d.host_index,
                (long long)d.mem_limit, (long long)d.real_memory, d.hard_core,
                d.soft_core, d.core_limit);
    }
    if (!c.disabled && c.device_count > 0 && (c.compat_mode & kCompatClient))
      SpawnDeviceClient(c.log_level);
    if (!c.disabled && c.device_count > 0)
      ArmQuotaReloader(ConfigPath(), c.quota_epoch);
    return c;
  }();
  return cfg;
}

const Config& Cfg() { return MutableCfg(); }

const DeviceLimits* Dev(int slot) {
  const Config& c = Cfg();
  if (c.disabled || slot < 0 || slot >= c.device_count) return nullptr;
  return c.dev[slot].present ? &c.dev[slot] : nullptr;
}

namespace {
size_t g_feed_bytes = 0;  // the mapped feed's size, set once by TcFeed
}  // namespace

// The node watcher's feed (loader.cc:211-241), read-only: v1 (records
// only) or v2 (records and the calibration block).
const TcUtilFile* TcFeed() {
  static const TcUtilFile* feed = []() -> const TcUtilFile* {
    const char* path = getenv("VTPU_TC_UTIL_PATH");
    if (!path || !*path) path = kDefaultFeedPath;
    int fd = open(path, O_RDONLY | O_CLOEXEC);
    if (fd < 0) return nullptr;
    struct stat st;
    constexpr size_t kV1 = sizeof(TcUtilFile);
    constexpr size_t kV2 = sizeof(TcUtilFile) + sizeof(TcCalibration);
    if (fstat(fd, &st) != 0 ||
        ((size_t)st.st_size != kV1 && (size_t)st.st_size != kV2)) {
      close(fd);
      return nullptr;
    }
    void* mem = mmap(nullptr, (size_t)st.st_size, PROT_READ, MAP_SHARED, fd, 0);
    close(fd);
    if (mem == MAP_FAILED) return nullptr;
    const auto* f = static_cast<const TcUtilFile*>(mem);
    if (f->magic != kTcUtilMagic) {
      munmap(mem, (size_t)st.st_size);
      return nullptr;
    }
    Log(kLogInfo, "watcher feed mapped: %s (v%u)", path, f->version);
    g_feed_bytes = (size_t)st.st_size;
    return f;
  }();
  return feed;
}

const TcCalibration* TcFeedCalibration() {
  const TcUtilFile* f = TcFeed();
  if (!f || g_feed_bytes != sizeof(TcUtilFile) + sizeof(TcCalibration))
    return nullptr;
  return reinterpret_cast<const TcCalibration*>(f + 1);
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
