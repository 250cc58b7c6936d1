// enforce_mem.cc — the device-memory cap, the node's memory ledger and the
// capped memory view.
//
// Ports library/src/enforce.cc DeviceLockFd:275, the ledger
// (ComputeOwnerToken:343, MapVmemLedger:391, ScanLedgerBytes:501,
// FindOrClaimOwnEntryLocked:551, RecordOwnBytes:573), ReserveMemory:792,
// UnreserveMemory:850 and WrappedMemoryStats:1249.
//
// Every allocating entry of the driver API is capped, as the reference
// wraps every allocating entry of its API (enforce.cc:965-989): linear
// memory (cuMemAlloc_v2, cuMemAllocPitch_v2, cuMemAllocManaged, the
// stream-ordered cuMemAllocAsync and cuMemAllocFromPoolAsync), physical
// memory (cuMemCreate) and arrays (cuArrayCreate_v2, cuArray3DCreate_v2,
// cuMipmappedArrayCreate; their bytes from the descriptor, summed over a
// mipmap's levels). Every allocation the driver hands out is recorded by
// pointer (by handle for cuMemCreate and arrays) with its size, and its
// free (cuMemFree_v2, cuMemFreeAsync, cuMemRelease, cuArrayDestroy,
// cuMipmappedArrayDestroy) returns the credit. A pitched allocation is
// reserved at its width rounded to 512 bytes before the call and settled
// to pitch x height after it. An allocation is admitted under
// two checks, made together with the charge under the node-wide per-device
// flock (VTPU_LOCK_DIR/vtpu_<host>.lock), so two processes allocating at
// once cannot both pass:
//   the cap:      own bytes + this tenant's other processes' bytes (same
//                 owner token in the ledger; an entry without a token is
//                 one of them when CLIENT mode's registry-attested pid set,
//                 pids.config, names its pid: enforce.cc:441-484, 513-514)
//                 + the request <= the cap;
//   the physical: every tenant's bytes on the device + the request <=
//                 real_memory.
// A refusal is CUDA_ERROR_OUT_OF_MEMORY before the driver sees the call
// (vtpu_oom_rejected_total). The ledger entry (VTPU_VMEM_PATH) is written
// while the lock is held and again on every free; PyTorch's caching
// allocator frees its cache and retries on a refusal, so the ledger holds
// live segments only.
//
// The view must match the cap: cuMemGetInfo_v2 reports total = cap and
// free = cap - own - siblings, or PyTorch's caching allocator would size
// itself against the whole card.

#include <errno.h>
#include <fcntl.h>
#include <pthread.h>
#include <signal.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <sys/file.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <algorithm>
#include <mutex>
#include <string>
#include <unordered_map>
#include <unordered_set>

#include "shim.h"

namespace vtpu_cuda {

using namespace vtpu_abi;

namespace {

struct Allocation {
  int slot;
  int64_t bytes;
};

std::mutex g_mu;
int64_t g_used[kMaxDevices] = {};
// the most the cap has granted this process at once, per slot (the step
// ring's HBM high-water); under g_mu
int64_t g_peak[kMaxDevices] = {};
std::unordered_map<CUdeviceptr, Allocation> g_by_ptr;
std::unordered_map<CUmemGenericAllocationHandle, Allocation> g_by_handle;
std::unordered_map<uintptr_t, Allocation> g_by_array;  // arrays, mipmaps
std::atomic<uint64_t> g_oom_rejected{0};

// CLIENT mode's pid set and the identity (inode, mtime, size) of the
// pids.config it was read from.
std::mutex g_client_pids_mu;
std::unordered_set<int> g_client_pids;
struct FileStamp {
  ino_t ino = 0;
  int64_t mtime_ns = -1;
  off_t size = -1;
  bool operator==(const FileStamp& o) const {
    return ino == o.ino && mtime_ns == o.mtime_ns && size == o.size;
  }
};
FileStamp g_client_pids_stamp;

// pids.config beside the container's vtpu.config (enforce.cc:441).
std::string ClientPidsPath() {
  const char* cfg = getenv("VTPU_CONFIG_PATH");
  std::string dir = cfg && *cfg ? cfg : "/etc/vtpu-manager/config/vtpu.config";
  size_t slash = dir.rfind('/');
  if (slash == std::string::npos) return "pids.config";
  return dir.substr(0, slash) + "/pids.config";
}

int64_t Used(int slot) {
  std::lock_guard<std::mutex> lock(g_mu);
  return g_used[slot];
}

// --- the node ledger ------------------------------------------------------

VmemFile* g_vmem = nullptr;
int g_vmem_lock_fd = -1;
std::atomic<uint64_t> g_token{0};
std::atomic<int> g_entry_idx[kMaxDevices];
std::atomic<bool> g_exiting{false};
std::mutex g_lock_fds_mu;
std::unordered_map<int, int> g_lock_fds;  // host index -> device lock fd
std::mutex* g_local_mu[kMaxDevices];       // host index % kMaxDevices

uint64_t ComputeOwnerToken() {
  const char* pod_uid = getenv("VTPU_POD_UID");
  const char* cont = getenv("VTPU_CONTAINER_NAME");
  char buf[256];
  if (pod_uid && *pod_uid) {
    snprintf(buf, sizeof(buf), "%s/%s", pod_uid, cont ? cont : "");
    return Fnv1a64(buf);
  }
  // a bare process: its pid and start time (field 22 of /proc/self/stat,
  // counted after the command name, which may hold spaces)
  unsigned long long starttime = 0;
  if (FILE* f = fopen("/proc/self/stat", "r")) {
    char line[1024];
    if (fgets(line, sizeof(line), f)) {
      char* p = strrchr(line, ')');
      int field = 2;
      char* save = nullptr;
      for (char* tok = p ? strtok_r(p + 1, " ", &save) : nullptr; tok;
           tok = strtok_r(nullptr, " ", &save)) {
        if (++field == 22) {
          starttime = strtoull(tok, nullptr, 10);
          break;
        }
      }
    }
    fclose(f);
  }
  snprintf(buf, sizeof(buf), "proc-%d-%llu", (int)getpid(), starttime);
  return Fnv1a64(buf);
}

uint64_t StaleReapNs() {
  static uint64_t ns = VmemStaleReapNsFromEnv(getenv("VTPU_VMEM_STALE_S"));
  return ns;
}

bool PidAlive(int pid) { return kill(pid, 0) == 0 || errno != ESRCH; }

// A forked child is another process: its own token (for a bare process),
// its own ledger entries, fresh lock descriptions (flock is per open file
// description, so inherited ones would not exclude the parent) and none of
// the parent's allocations.
void ResetInChild() {
  g_token.store(0);
  for (auto& idx : g_entry_idx) idx.store(-1);
  for (auto& kv : g_lock_fds) close(kv.second);
  g_lock_fds.clear();
  if (g_vmem) {
    const char* path = getenv("VTPU_VMEM_PATH");
    char lock_path[512];
    snprintf(lock_path, sizeof(lock_path), "%s.lock",
             path ? path : "/tmp/.vmem_node/vmem_node.config");
    if (g_vmem_lock_fd >= 0) close(g_vmem_lock_fd);
    g_vmem_lock_fd = open(lock_path, O_CREAT | O_RDWR | O_CLOEXEC, 0666);
  }
  for (auto& u : g_used) u = 0;
  for (auto& u : g_peak) u = 0;
  g_by_ptr.clear();
  g_by_handle.clear();
  g_by_array.clear();
}

// The Python ledger's FileLock protocol: flock on <ledger>.lock.
class LedgerLock {
 public:
  LedgerLock() {
    if (g_vmem_lock_fd >= 0 && flock(g_vmem_lock_fd, LOCK_EX) == 0)
      held_ = true;
  }
  ~LedgerLock() {
    if (held_) flock(g_vmem_lock_fd, LOCK_UN);
  }

 private:
  bool held_ = false;
};

// Frees this process's entries at exit, so a departed tenant leaves no
// resident behind in the watcher's feed (reference loader.c:2527-2543).
// A process killed outright leaves them until they go stale.
void ClearOwnEntries() {
  g_exiting.store(true);
  if (!g_vmem) return;
  int me = (int)getpid();
  LedgerLock lock;
  for (int i = 0; i < kVmemMaxEntries; i++) {
    VmemEntry& e = g_vmem->entries[i];
    if (e.pid != me) continue;
    __atomic_store_n(&e.pid, 0, __ATOMIC_RELEASE);
    e.bytes = 0;
    e.owner_token = 0;
    e.activity = 0;
    e.last_update_ns = 0;
  }
}

void MapLedgerOnce() {
  static std::once_flag once;
  std::call_once(once, [] {
    for (auto& idx : g_entry_idx) idx.store(-1);
    for (auto& mu : g_local_mu) mu = new std::mutex();
    pthread_atfork(nullptr, nullptr, ResetInChild);
    atexit(ClearOwnEntries);
    const char* path = getenv("VTPU_VMEM_PATH");
    if (!path || !*path) path = "/tmp/.vmem_node/vmem_node.config";
    int fd = open(path, O_RDWR | O_CLOEXEC);
    if (fd < 0) return;
    struct stat st;
    if (fstat(fd, &st) != 0 || (size_t)st.st_size != sizeof(VmemFile)) {
      close(fd);
      Log(kLogWarn, "vmem ledger %s has the wrong size; no co-tenant view",
          path);
      return;
    }
    void* mem = mmap(nullptr, sizeof(VmemFile), PROT_READ | PROT_WRITE,
                     MAP_SHARED, fd, 0);
    close(fd);
    if (mem == MAP_FAILED) return;
    auto* f = static_cast<VmemFile*>(mem);
    if (f->magic != kVmemMagic || f->version != kVmemVersion) {
      Log(kLogWarn, "vmem ledger %s rejected (magic=%08x version=%u); no "
          "co-tenant view", path, f->magic, f->version);
      munmap(mem, sizeof(VmemFile));
      return;
    }
    char lock_path[512];
    snprintf(lock_path, sizeof(lock_path), "%s.lock", path);
    g_vmem_lock_fd = open(lock_path, O_CREAT | O_RDWR | O_CLOEXEC, 0666);
    g_vmem = f;
    Log(kLogInfo, "vmem ledger mapped: %s (token=%016llx)", path,
        (unsigned long long)OwnerToken());
  });
}

int DeviceLockFd(int host_index) {
  std::lock_guard<std::mutex> lock(g_lock_fds_mu);
  auto it = g_lock_fds.find(host_index);
  if (it != g_lock_fds.end()) return it->second;
  const char* dir = getenv("VTPU_LOCK_DIR");
  if (!dir || !*dir) dir = "/tmp/.vtpu_lock";
  mkdir(dir, 0777);
  char path[512];
  snprintf(path, sizeof(path), "%s/vtpu_%d.lock", dir, host_index);
  int fd = open(path, O_CREAT | O_RDWR | O_CLOEXEC, 0666);
  Log(kLogInfo, "device %d lock: %s", host_index, path);
  g_lock_fds[host_index] = fd;
  return fd;
}

// The node-wide critical section for one device's memory accounting: a
// local mutex (flock does not exclude threads sharing a description) and
// the device's flock, with the reference's backoff and a 10 s timeout
// after which the check runs unlocked rather than hanging (lock.c:207).
class DeviceLock {
 public:
  explicit DeviceLock(int host_index)
      : local_(*g_local_mu[host_index % kMaxDevices]),
        fd_(DeviceLockFd(host_index)) {
    local_.lock();
    if (fd_ < 0) return;
    uint64_t deadline = NowNs() + 10'000'000'000ull;
    useconds_t backoff = 1000;
    while (flock(fd_, LOCK_EX | LOCK_NB) != 0) {
      if ((errno != EWOULDBLOCK && errno != EINTR) || NowNs() > deadline) {
        Log(kLogError, "device %d lock not taken; checking unlocked",
            host_index);
        return;
      }
      usleep(backoff);
      backoff = std::min<useconds_t>(backoff * 2, 10000);
    }
    held_ = true;
  }
  ~DeviceLock() {
    if (held_) flock(fd_, LOCK_UN);
    local_.unlock();
  }

 private:
  std::mutex& local_;
  int fd_;
  bool held_ = false;
};

// This process's entry for `host`, claiming a free slot when `claim`. The
// caller holds the ledger lock; the pid is stored last, which publishes
// the claimed slot to lock-free readers.
int FindOrClaimLocked(int host, bool claim) {
  int me = (int)getpid();
  uint64_t token = OwnerToken();
  int free_slot = -1;
  for (int i = 0; i < kVmemMaxEntries; i++) {
    VmemEntry& e = g_vmem->entries[i];
    if (e.pid == me && e.host_index == host && e.owner_token == token)
      return i;
    if (e.pid == 0 && free_slot < 0) free_slot = i;
  }
  if (!claim || free_slot < 0) return -1;
  VmemEntry& e = g_vmem->entries[free_slot];
  e.host_index = host;
  e.bytes = 0;
  e.last_update_ns = NowNs();
  e.owner_token = token;
  e.activity = 0;
  e.spilled = 0;
  __atomic_store_n(&e.pid, me, __ATOMIC_RELEASE);
  return free_slot;
}

// Publishes this process's bytes on the slot's device (a zero entry with
// no activity history is freed).
void RecordOwnBytes(int slot, int64_t used) {
  const DeviceLimits* d = Dev(slot);
  MapLedgerOnce();
  if (!g_vmem || !d || g_exiting.load()) return;
  uint64_t mine = used > 0 ? (uint64_t)used : 0;
  LedgerLock lock;
  int idx = FindOrClaimLocked(d->host_index, mine > 0);
  if (idx < 0) return;
  VmemEntry& e = g_vmem->entries[idx];
  e.bytes = mine;
  e.last_update_ns = NowNs();
  g_entry_idx[slot].store(idx, std::memory_order_relaxed);
}

void Record(CUdeviceptr ptr, int slot, int64_t bytes) {
  std::lock_guard<std::mutex> lock(g_mu);
  g_by_ptr[ptr] = Allocation{slot, bytes};
}

// Drops `ptr` from the ledger and returns its reservation.
void Forget(CUdeviceptr ptr) {
  Allocation a{0, 0};
  {
    std::lock_guard<std::mutex> lock(g_mu);
    auto it = g_by_ptr.find(ptr);
    if (it == g_by_ptr.end()) return;
    a = it->second;
    g_by_ptr.erase(it);
  }
  UnreserveMemory(a.slot, a.bytes);
}

}  // namespace

uint64_t OwnerToken() {
  uint64_t t = g_token.load(std::memory_order_relaxed);
  if (t == 0) {
    t = ComputeOwnerToken();
    g_token.store(t, std::memory_order_relaxed);
  }
  return t;
}

// Reads pids.config again when its inode, mtime or size changed
// (enforce.cc:449; the reference compares the mtime in seconds, which a
// rewrite within the same second would not change). A file that does not
// decode is remembered and the set stays as it was.
void RefreshClientPids() {
  if (!(Cfg().compat_mode & kCompatClient)) return;
  std::string path = ClientPidsPath();
  struct stat st;
  if (stat(path.c_str(), &st) != 0) return;
  FileStamp stamp{st.st_ino,
                  (int64_t)st.st_mtim.tv_sec * 1000000000 + st.st_mtim.tv_nsec,
                  st.st_size};
  {
    std::lock_guard<std::mutex> lock(g_client_pids_mu);
    if (stamp == g_client_pids_stamp) return;
    g_client_pids_stamp = stamp;
  }
  int fd = open(path.c_str(), O_RDONLY | O_CLOEXEC);
  if (fd < 0) return;
  PidsFileHeader header;
  std::unordered_set<int> pids;
  bool ok = read(fd, &header, sizeof(header)) == (ssize_t)sizeof(header) &&
            header.magic == kPidsMagic && header.version == 1 &&
            header.count >= 0 && header.count < 65536;
  for (int i = 0; ok && i < header.count; i++) {
    int32_t pid;
    ok = read(fd, &pid, sizeof(pid)) == (ssize_t)sizeof(pid);
    pids.insert(pid);
  }
  close(fd);
  if (!ok) {
    Log(kLogWarn, "client pid set %s does not decode; keeping the last",
        path.c_str());
    return;
  }
  size_t n = pids.size();
  {
    std::lock_guard<std::mutex> lock(g_client_pids_mu);
    g_client_pids.swap(pids);
  }
  Log(kLogInfo, "client pid set refreshed (%zu pids)", n);
}

bool PidIsSelf(int pid) {
  if (pid == (int)getpid()) return true;
  if (!(Cfg().compat_mode & kCompatClient)) return false;
  std::lock_guard<std::mutex> lock(g_client_pids_mu);
  return g_client_pids.count(pid) > 0;
}

LedgerBytes ScanLedgerBytes(int slot) {
  LedgerBytes out;
  // a process that only allocates starts no watcher to refresh the set
  RefreshClientPids();
  const DeviceLimits* d = Dev(slot);
  MapLedgerOnce();
  if (!g_vmem || !d) return out;
  int me = (int)getpid();
  uint64_t token = OwnerToken();
  uint64_t now = NowNs();
  for (int i = 0; i < kVmemMaxEntries; i++) {
    const VmemEntry& e = g_vmem->entries[i];
    int pid = __atomic_load_n(&e.pid, __ATOMIC_ACQUIRE);
    if (pid == 0 || e.host_index != d->host_index) continue;
    // tenant identity is the token; an entry without one falls back to
    // the registry-attested pid set (enforce.cc:513-514)
    bool self_tenant =
        e.owner_token != 0 ? e.owner_token == token : PidIsSelf(pid);
    if (self_tenant && pid == me) continue;  // g_used covers this process
    // a foreign namespace's pid cannot be probed: count the entry unless
    // it is both dead here and stale
    if (!PidAlive(pid) && now - e.last_update_ns > StaleReapNs()) continue;
    (self_tenant ? out.siblings : out.others) += (int64_t)e.bytes;
  }
  return out;
}

bool TenantOnCard(int slot, uint64_t token) {
  const DeviceLimits* d = Dev(slot);
  MapLedgerOnce();
  if (!g_vmem || !d) return false;
  uint64_t now = NowNs();
  for (int i = 0; i < kVmemMaxEntries; i++) {
    const VmemEntry& e = g_vmem->entries[i];
    int pid = __atomic_load_n(&e.pid, __ATOMIC_ACQUIRE);
    if (pid == 0 || e.host_index != d->host_index || e.owner_token != token)
      continue;
    if (PidAlive(pid) || now - e.last_update_ns <= StaleReapNs()) return true;
  }
  return false;
}

bool LedgerHoldsPid(int slot, int pid) {
  const DeviceLimits* d = Dev(slot);
  MapLedgerOnce();
  if (!g_vmem || !d) return false;
  for (int i = 0; i < kVmemMaxEntries; i++) {
    const VmemEntry& e = g_vmem->entries[i];
    if (__atomic_load_n(&e.pid, __ATOMIC_ACQUIRE) == pid &&
        e.host_index == d->host_index)
      return true;
  }
  return false;
}

VmemEntry* OwnLedgerEntry(int slot) {
  const DeviceLimits* d = Dev(slot);
  MapLedgerOnce();
  if (!g_vmem || !d || g_exiting.load()) return nullptr;
  int idx = g_entry_idx[slot].load(std::memory_order_relaxed);
  if (idx >= 0) {
    VmemEntry& e = g_vmem->entries[idx];
    if (e.pid == (int)getpid() && e.host_index == d->host_index &&
        e.owner_token == OwnerToken())
      return &e;
  }
  LedgerLock lock;
  idx = FindOrClaimLocked(d->host_index, /*claim=*/true);
  g_entry_idx[slot].store(idx, std::memory_order_relaxed);
  return idx >= 0 ? &g_vmem->entries[idx] : nullptr;
}

// Admits `bytes` on `slot` when the tenant stays within its cap and the
// device within its physical memory; at the cap exactly is admitted, one
// byte over is not. The check, the charge and the ledger entry happen
// under the device lock.
CUresult ReserveMemory(int slot, int64_t bytes) {
  const DeviceLimits* d = Dev(slot);
  if (!d) {
    std::lock_guard<std::mutex> lock(g_mu);
    g_used[slot] += bytes;
    g_peak[slot] = std::max(g_peak[slot], g_used[slot]);
    return CUDA_SUCCESS;
  }
  MapLedgerOnce();
  DeviceLock device_lock(d->host_index);
  int64_t own = Used(slot);
  LedgerBytes lb = ScanLedgerBytes(slot);
  if (d->mem_limit > 0 && own + lb.siblings + bytes > d->mem_limit) {
    g_oom_rejected.fetch_add(1, std::memory_order_relaxed);
    Log(kLogInfo, "device %d: %lld bytes refused by the cap (own %lld, "
        "siblings %lld, cap %lld)", slot, (long long)bytes, (long long)own,
        (long long)lb.siblings, (long long)d->mem_limit);
    return CUDA_ERROR_OUT_OF_MEMORY;
  }
  if (d->real_memory > 0 &&
      own + lb.siblings + lb.others + bytes > d->real_memory) {
    g_oom_rejected.fetch_add(1, std::memory_order_relaxed);
    Log(kLogInfo, "device %d: %lld bytes refused by physical memory "
        "(tenant %lld, co-tenants %lld, physical %lld)", slot,
        (long long)bytes, (long long)(own + lb.siblings),
        (long long)lb.others, (long long)d->real_memory);
    return CUDA_ERROR_OUT_OF_MEMORY;
  }
  int64_t now_used;
  {
    std::lock_guard<std::mutex> lock(g_mu);
    now_used = g_used[slot] += bytes;
    g_peak[slot] = std::max(g_peak[slot], now_used);
  }
  RecordOwnBytes(slot, now_used);
  return CUDA_SUCCESS;
}

int64_t PeakBytes(int slot) {
  if (slot < 0 || slot >= kMaxDevices) return 0;
  std::lock_guard<std::mutex> lock(g_mu);
  return g_peak[slot];
}

void UnreserveMemory(int slot, int64_t bytes) {
  int64_t now_used;
  {
    std::lock_guard<std::mutex> lock(g_mu);
    now_used = g_used[slot] = std::max<int64_t>(0, g_used[slot] - bytes);
  }
  if (Dev(slot)) RecordOwnBytes(slot, now_used);
}

}  // namespace vtpu_cuda

using namespace vtpu_cuda;

namespace {

template <typename Alloc>
CUresult AllocateCapped(CUdeviceptr* dptr, size_t bytes, Alloc alloc) {
  int slot = CurrentSlot();
  CUresult rc = ReserveMemory(slot, (int64_t)bytes);
  if (rc != CUDA_SUCCESS) return rc;
  rc = alloc();
  if (rc == CUDA_SUCCESS && dptr)
    Record(*dptr, slot, (int64_t)bytes);
  else
    UnreserveMemory(slot, (int64_t)bytes);
  return rc;
}

// An array's bytes: width x height x depth x channels x the format's size
// (a zero height or depth is a lower dimension). Formats the subset does
// not name count 4 bytes a channel.
int64_t ArrayBytes(size_t width, size_t height, size_t depth, int format,
                   unsigned channels) {
  int64_t elem;
  switch (format) {
    case CU_AD_FORMAT_UNSIGNED_INT8:
    case CU_AD_FORMAT_SIGNED_INT8:
      elem = 1;
      break;
    case CU_AD_FORMAT_UNSIGNED_INT16:
    case CU_AD_FORMAT_SIGNED_INT16:
    case CU_AD_FORMAT_HALF:
      elem = 2;
      break;
    default:
      elem = 4;
  }
  return (int64_t)width * (int64_t)(height ? height : 1) *
         (int64_t)(depth ? depth : 1) * (int64_t)channels * elem;
}

// Reserves `bytes`, creates the array, records it by handle.
template <typename Create>
CUresult CreateArrayCapped(uintptr_t* handle, int64_t bytes, Create create) {
  int slot = CurrentSlot();
  CUresult rc = ReserveMemory(slot, bytes);
  if (rc != CUDA_SUCCESS) return rc;
  rc = create();
  if (rc != CUDA_SUCCESS || !handle) {
    UnreserveMemory(slot, bytes);
    return rc;
  }
  std::lock_guard<std::mutex> lock(g_mu);
  g_by_array[*handle] = Allocation{slot, bytes};
  return rc;
}

void ForgetArray(uintptr_t handle) {
  Allocation a{0, 0};
  {
    std::lock_guard<std::mutex> lock(g_mu);
    auto it = g_by_array.find(handle);
    if (it == g_by_array.end()) return;
    a = it->second;
    g_by_array.erase(it);
  }
  UnreserveMemory(a.slot, a.bytes);
}

}  // namespace

VTPU_EXPORT CUresult cuMemAlloc_v2(CUdeviceptr* dptr, size_t bytes) {
  auto real = VTPU_REAL(cuMemAlloc_v2);
  if (!real) return CUDA_ERROR_NOT_INITIALIZED;
  return AllocateCapped(dptr, bytes, [&] { return real(dptr, bytes); });
}

VTPU_EXPORT CUresult cuMemAllocAsync(CUdeviceptr* dptr, size_t bytes,
                                     CUstream stream) {
  auto real = VTPU_REAL(cuMemAllocAsync);
  if (!real) return CUDA_ERROR_NOT_INITIALIZED;
  return AllocateCapped(dptr, bytes,
                        [&] { return real(dptr, bytes, stream); });
}

VTPU_EXPORT CUresult cuMemAllocAsync_ptsz(CUdeviceptr* dptr, size_t bytes,
                                          CUstream stream) {
  auto real = VTPU_REAL(cuMemAllocAsync_ptsz);
  if (!real) return CUDA_ERROR_NOT_INITIALIZED;
  return AllocateCapped(dptr, bytes,
                        [&] { return real(dptr, bytes, stream); });
}

VTPU_EXPORT CUresult cuMemAllocPitch_v2(CUdeviceptr* dptr, size_t* pitch,
                                        size_t width_bytes, size_t height,
                                        unsigned element_bytes) {
  auto real = VTPU_REAL(cuMemAllocPitch_v2);
  if (!real) return CUDA_ERROR_NOT_INITIALIZED;
  int slot = CurrentSlot();
  int64_t reserved = (int64_t)((width_bytes + 511) / 512 * 512 * height);
  CUresult rc = ReserveMemory(slot, reserved);
  if (rc != CUDA_SUCCESS) return rc;
  rc = real(dptr, pitch, width_bytes, height, element_bytes);
  if (rc != CUDA_SUCCESS || !dptr || !pitch) {
    UnreserveMemory(slot, reserved);
    return rc;
  }
  // settle to what the driver laid out
  int64_t actual = (int64_t)(*pitch * height);
  if (actual > reserved &&
      ReserveMemory(slot, actual - reserved) != CUDA_SUCCESS) {
    VTPU_REAL(cuMemFree_v2)(*dptr);
    UnreserveMemory(slot, reserved);
    return CUDA_ERROR_OUT_OF_MEMORY;
  }
  if (actual < reserved) UnreserveMemory(slot, reserved - actual);
  Record(*dptr, slot, actual);
  return rc;
}

VTPU_EXPORT CUresult cuMemAllocManaged(CUdeviceptr* dptr, size_t bytes,
                                       unsigned flags) {
  auto real = VTPU_REAL(cuMemAllocManaged);
  if (!real) return CUDA_ERROR_NOT_INITIALIZED;
  return AllocateCapped(dptr, bytes, [&] { return real(dptr, bytes, flags); });
}

VTPU_EXPORT CUresult cuMemAllocFromPoolAsync(CUdeviceptr* dptr, size_t bytes,
                                             CUmemoryPool pool,
                                             CUstream stream) {
  auto real = VTPU_REAL(cuMemAllocFromPoolAsync);
  if (!real) return CUDA_ERROR_NOT_INITIALIZED;
  return AllocateCapped(dptr, bytes,
                        [&] { return real(dptr, bytes, pool, stream); });
}

VTPU_EXPORT CUresult cuMemAllocFromPoolAsync_ptsz(CUdeviceptr* dptr,
                                                  size_t bytes,
                                                  CUmemoryPool pool,
                                                  CUstream stream) {
  auto real = VTPU_REAL(cuMemAllocFromPoolAsync_ptsz);
  if (!real) return CUDA_ERROR_NOT_INITIALIZED;
  return AllocateCapped(dptr, bytes,
                        [&] { return real(dptr, bytes, pool, stream); });
}

VTPU_EXPORT CUresult cuArrayCreate_v2(CUarray* array,
                                      const CUDA_ARRAY_DESCRIPTOR* desc) {
  auto real = VTPU_REAL(cuArrayCreate_v2);
  if (!real) return CUDA_ERROR_NOT_INITIALIZED;
  if (!desc) return real(array, desc);
  return CreateArrayCapped(
      reinterpret_cast<uintptr_t*>(array),
      ArrayBytes(desc->Width, desc->Height, 0, desc->Format,
                 desc->NumChannels),
      [&] { return real(array, desc); });
}

VTPU_EXPORT CUresult cuArray3DCreate_v2(CUarray* array,
                                        const CUDA_ARRAY3D_DESCRIPTOR* desc) {
  auto real = VTPU_REAL(cuArray3DCreate_v2);
  if (!real) return CUDA_ERROR_NOT_INITIALIZED;
  if (!desc) return real(array, desc);
  return CreateArrayCapped(
      reinterpret_cast<uintptr_t*>(array),
      ArrayBytes(desc->Width, desc->Height, desc->Depth, desc->Format,
                 desc->NumChannels),
      [&] { return real(array, desc); });
}

VTPU_EXPORT CUresult cuMipmappedArrayCreate(
    CUmipmappedArray* array, const CUDA_ARRAY3D_DESCRIPTOR* desc,
    unsigned levels) {
  auto real = VTPU_REAL(cuMipmappedArrayCreate);
  if (!real) return CUDA_ERROR_NOT_INITIALIZED;
  if (!desc) return real(array, desc, levels);
  // each level halves every dimension the array has, down to 1
  int64_t bytes = 0;
  for (unsigned l = 0; l < levels && l < 64; l++) {
    auto at = [l](size_t n) { return n ? std::max<size_t>(1, n >> l) : 0; };
    bytes += ArrayBytes(at(desc->Width), at(desc->Height), at(desc->Depth),
                        desc->Format, desc->NumChannels);
  }
  return CreateArrayCapped(reinterpret_cast<uintptr_t*>(array), bytes,
                           [&] { return real(array, desc, levels); });
}

VTPU_EXPORT CUresult cuArrayDestroy(CUarray array) {
  auto real = VTPU_REAL(cuArrayDestroy);
  if (!real) return CUDA_ERROR_NOT_INITIALIZED;
  CUresult rc = real(array);
  if (rc == CUDA_SUCCESS) ForgetArray(reinterpret_cast<uintptr_t>(array));
  return rc;
}

VTPU_EXPORT CUresult cuMipmappedArrayDestroy(CUmipmappedArray array) {
  auto real = VTPU_REAL(cuMipmappedArrayDestroy);
  if (!real) return CUDA_ERROR_NOT_INITIALIZED;
  CUresult rc = real(array);
  if (rc == CUDA_SUCCESS) ForgetArray(reinterpret_cast<uintptr_t>(array));
  return rc;
}

VTPU_EXPORT CUresult cuMemFree_v2(CUdeviceptr dptr) {
  auto real = VTPU_REAL(cuMemFree_v2);
  if (!real) return CUDA_ERROR_NOT_INITIALIZED;
  CUresult rc = real(dptr);
  if (rc == CUDA_SUCCESS) Forget(dptr);
  return rc;
}

VTPU_EXPORT CUresult cuMemFreeAsync(CUdeviceptr dptr, CUstream stream) {
  auto real = VTPU_REAL(cuMemFreeAsync);
  if (!real) return CUDA_ERROR_NOT_INITIALIZED;
  CUresult rc = real(dptr, stream);
  if (rc == CUDA_SUCCESS) Forget(dptr);
  return rc;
}

VTPU_EXPORT CUresult cuMemFreeAsync_ptsz(CUdeviceptr dptr, CUstream stream) {
  auto real = VTPU_REAL(cuMemFreeAsync_ptsz);
  if (!real) return CUDA_ERROR_NOT_INITIALIZED;
  CUresult rc = real(dptr, stream);
  if (rc == CUDA_SUCCESS) Forget(dptr);
  return rc;
}

VTPU_EXPORT CUresult cuMemCreate(CUmemGenericAllocationHandle* handle,
                                 size_t bytes,
                                 const CUmemAllocationProp* prop,
                                 unsigned long long flags) {
  auto real = VTPU_REAL(cuMemCreate);
  if (!real) return CUDA_ERROR_NOT_INITIALIZED;
  int slot = prop && prop->locationId >= 0 && prop->locationId < kMaxDevices
                 ? prop->locationId
                 : CurrentSlot();
  CUresult rc = ReserveMemory(slot, (int64_t)bytes);
  if (rc != CUDA_SUCCESS) return rc;
  rc = real(handle, bytes, prop, flags);
  if (rc != CUDA_SUCCESS || !handle) {
    UnreserveMemory(slot, (int64_t)bytes);
    return rc;
  }
  std::lock_guard<std::mutex> lock(g_mu);
  g_by_handle[*handle] = Allocation{slot, (int64_t)bytes};
  return rc;
}

VTPU_EXPORT CUresult cuMemRelease(CUmemGenericAllocationHandle handle) {
  auto real = VTPU_REAL(cuMemRelease);
  if (!real) return CUDA_ERROR_NOT_INITIALIZED;
  CUresult rc = real(handle);
  if (rc != CUDA_SUCCESS) return rc;
  Allocation a{0, 0};
  {
    std::lock_guard<std::mutex> lock(g_mu);
    auto it = g_by_handle.find(handle);
    if (it == g_by_handle.end()) return rc;
    a = it->second;
    g_by_handle.erase(it);
  }
  UnreserveMemory(a.slot, a.bytes);
  return rc;
}

VTPU_EXPORT CUresult cuMemGetInfo_v2(size_t* free_bytes, size_t* total_bytes) {
  auto real = VTPU_REAL(cuMemGetInfo_v2);
  if (!real) return CUDA_ERROR_NOT_INITIALIZED;
  CUresult rc = real(free_bytes, total_bytes);
  int slot = CurrentSlot();
  const DeviceLimits* d = Dev(slot);
  if (rc != CUDA_SUCCESS || !d || d->mem_limit <= 0) return rc;
  int64_t used = Used(slot) + ScanLedgerBytes(slot).siblings;
  if (total_bytes) *total_bytes = (size_t)d->mem_limit;
  if (free_bytes)
    *free_bytes = std::min<size_t>(
        *free_bytes, (size_t)std::max<int64_t>(0, d->mem_limit - used));
  return rc;
}

VTPU_EXPORT CUresult cuDeviceTotalMem_v2(size_t* bytes, CUdevice dev) {
  auto real = VTPU_REAL(cuDeviceTotalMem_v2);
  if (!real) return CUDA_ERROR_NOT_INITIALIZED;
  CUresult rc = real(bytes, dev);
  const DeviceLimits* d = Dev(dev);
  if (rc != CUDA_SUCCESS || !bytes || !d || d->mem_limit <= 0) return rc;
  *bytes = std::min<size_t>(*bytes, (size_t)d->mem_limit);
  return rc;
}

// The most the cap has granted this process at once on a device: host
// memory (cuMemAllocHost, cuMemHostAlloc) is not hooked and never counted.
VTPU_EXPORT int64_t vtpu_peak_bytes(int slot) { return PeakBytes(slot); }

VTPU_EXPORT uint64_t vtpu_oom_rejected_total() {
  return g_oom_rejected.load(std::memory_order_relaxed);
}
