// enforce_mem.cc — the device-memory cap and the capped memory view.
//
// Ports library/src/enforce.cc ReserveMemory:792, UnreserveMemory:850 and
// WrappedMemoryStats:1249. The ledger is this process's own: every
// allocation the driver hands out is recorded by pointer (or by handle for
// cuMemCreate) with its size, and an allocation that would take the
// device's total past VTPU_MEM_LIMIT_<i> fails with CUDA_ERROR_OUT_OF_MEMORY
// before the driver sees it. Sibling processes sharing the cap (the
// reference's ScanLedgerBytes:501) are not counted yet.
//
// The view must match the cap: cuMemGetInfo_v2 reports total = cap and
// free = cap - own, or PyTorch's caching allocator would size itself
// against the whole card.

#include <algorithm>
#include <mutex>
#include <unordered_map>

#include "shim.h"

namespace vtpu_cuda {

namespace {

struct Allocation {
  int slot;
  int64_t bytes;
};

std::mutex g_mu;
int64_t g_used[kMaxDevices] = {};
std::unordered_map<CUdeviceptr, Allocation> g_by_ptr;
std::unordered_map<CUmemGenericAllocationHandle, Allocation> g_by_handle;

int64_t Limit(int slot) {
  const Config& c = Cfg();
  return c.disabled ? 0 : c.mem_limit[slot];
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

// Admits `bytes` on `slot` when the total stays within the cap; at the cap
// exactly is admitted, one byte over is not.
CUresult ReserveMemory(int slot, int64_t bytes) {
  std::lock_guard<std::mutex> lock(g_mu);
  int64_t limit = Limit(slot);
  if (limit > 0 && g_used[slot] + bytes > limit) {
    Log(kLogInfo, "device %d: %lld bytes refused (%lld of %lld in use)", slot,
        (long long)bytes, (long long)g_used[slot], (long long)limit);
    return CUDA_ERROR_OUT_OF_MEMORY;
  }
  g_used[slot] += bytes;
  return CUDA_SUCCESS;
}

void UnreserveMemory(int slot, int64_t bytes) {
  std::lock_guard<std::mutex> lock(g_mu);
  g_used[slot] = std::max<int64_t>(0, g_used[slot] - bytes);
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
  int64_t limit = Limit(slot);
  if (rc != CUDA_SUCCESS || limit <= 0) return rc;
  int64_t used;
  {
    std::lock_guard<std::mutex> lock(g_mu);
    used = g_used[slot];
  }
  if (total_bytes) *total_bytes = (size_t)limit;
  if (free_bytes)
    *free_bytes = std::min<size_t>(
        *free_bytes, (size_t)std::max<int64_t>(0, limit - used));
  return rc;
}

VTPU_EXPORT CUresult cuDeviceTotalMem_v2(size_t* bytes, CUdevice dev) {
  auto real = VTPU_REAL(cuDeviceTotalMem_v2);
  if (!real) return CUDA_ERROR_NOT_INITIALIZED;
  CUresult rc = real(bytes, dev);
  if (rc != CUDA_SUCCESS || !bytes || dev < 0 || dev >= kMaxDevices) return rc;
  int64_t limit = Limit(dev);
  if (limit > 0) *bytes = std::min<size_t>(*bytes, (size_t)limit);
  return rc;
}
