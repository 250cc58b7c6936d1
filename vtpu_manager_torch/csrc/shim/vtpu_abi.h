// vtpu_abi.h — the node's shared file layouts, as the interposer reads them.
//
// The port's own copy of library/include/vtpu_config.h:21-309: the
// per-container config file (vtpu.config, version 6), the node watcher's
// utilization feed (tc_util.config, version 2), the cross-process
// memory ledger (vmem_node.config, version 3) and CLIENT mode's pid set
// (pids.config, version 1). The Python writers are
// vtpu_manager_torch/config/{vtpu_config,tc_watcher,vmem}.py;
// tests/test_torch_config_abi.py compiles this header beside the JAX
// package's and checks that every size and offset agrees.
//
// Little-endian, explicitly padded, fixed NUL-terminated strings; the
// config ends in an FNV-1a checksum over every byte before it.

#pragma once

#include <stddef.h>
#include <stdint.h>
#include <stdlib.h>

namespace vtpu_abi {

constexpr uint32_t kConfigMagic = 0x55505456;  // "VTPU"
constexpr uint32_t kConfigVersion = 6;
constexpr int kMaxDeviceCount = 64;
constexpr int kUuidLen = 64;
constexpr int kNameLen = 64;
constexpr int kPodUidLen = 48;
constexpr int kCacheDirLen = 64;

enum CoreLimit : int32_t {
  kCoreLimitNone = 0,
  kCoreLimitHard = 1,  // fixed policy: clamp at hard_core
  kCoreLimitSoft = 2,  // balance policy: elastic hard_core..soft_core
};

enum CompatMode : int32_t {
  kCompatHost = 0x01,
  kCompatClient = 0x04,  // the registry-attested pid set (pids.config)
};

struct VtpuDevice {
  char uuid[kUuidLen];
  uint64_t total_memory;  // cap, bytes
  uint64_t real_memory;   // physical device memory, bytes (0 = unknown)
  int32_t hard_core;      // percent
  int32_t soft_core;      // percent (balance ceiling)
  int32_t core_limit;     // CoreLimit
  int32_t memory_limit;   // bool
  int32_t memory_oversold;
  int32_t host_index;
  int32_t mesh_x;
  int32_t mesh_y;
  int32_t mesh_z;
  int32_t lease_core;
  uint64_t virtual_hbm_bytes;
  uint64_t spill_budget_bytes;
  int32_t ici_link_pct;
  uint32_t ici_pad_;
};
static_assert(sizeof(VtpuDevice) == 144, "VtpuDevice ABI size");
static_assert(offsetof(VtpuDevice, total_memory) == 64, "ABI");
static_assert(offsetof(VtpuDevice, hard_core) == 80, "ABI");
static_assert(offsetof(VtpuDevice, mesh_x) == 104, "ABI");
static_assert(offsetof(VtpuDevice, lease_core) == 116, "ABI");
static_assert(offsetof(VtpuDevice, virtual_hbm_bytes) == 120, "ABI");
static_assert(offsetof(VtpuDevice, spill_budget_bytes) == 128, "ABI");
static_assert(offsetof(VtpuDevice, ici_link_pct) == 136, "ABI");

struct VtpuConfig {
  uint32_t magic;
  uint32_t version;
  char pod_uid[kPodUidLen];
  char pod_name[kNameLen];
  char pod_namespace[kNameLen];
  char container_name[kNameLen];
  int32_t device_count;
  int32_t compat_mode;
  char compile_cache_dir[kCacheDirLen];
  int32_t workload_class;
  uint32_t quota_epoch;
  int32_t migration_freeze;
  uint32_t freeze_epoch;
  VtpuDevice devices[kMaxDeviceCount];
  uint32_t checksum;  // FNV-1a over all preceding bytes
  uint32_t pad_;
};
static_assert(offsetof(VtpuConfig, device_count) == 248, "ABI");
static_assert(offsetof(VtpuConfig, compile_cache_dir) == 256, "ABI");
static_assert(offsetof(VtpuConfig, workload_class) == 320, "ABI");
static_assert(offsetof(VtpuConfig, quota_epoch) == 324, "ABI");
static_assert(offsetof(VtpuConfig, migration_freeze) == 328, "ABI");
static_assert(offsetof(VtpuConfig, freeze_epoch) == 332, "ABI");
static_assert(offsetof(VtpuConfig, devices) == 336, "ABI");
static_assert(sizeof(VtpuConfig) == 336 + 64 * 144 + 8, "VtpuConfig ABI");

inline uint64_t Fnv1a64(const char* data) {
  uint64_t h = 0xCBF29CE484222325ull;
  for (const char* p = data; *p; ++p) {
    h ^= (uint64_t)(unsigned char)*p;
    h *= 0x100000001B3ull;
  }
  return h;
}

inline uint32_t Fnv1a(const uint8_t* data, size_t len) {
  uint32_t h = 0x811C9DC5u;
  for (size_t i = 0; i < len; ++i) {
    h ^= data[i];
    h *= 0x01000193u;
  }
  return h;
}

// tc_util.config: one seqlock'd record per device (odd seq = writing).
constexpr uint32_t kTcUtilMagic = 0x55544356;  // "VCTU"
constexpr uint32_t kTcUtilVersion2 = 2;
constexpr int kMaxProcs = 32;
constexpr int kMaxExcessPoints = 8;

struct TcProcUtil {
  int32_t pid;
  int32_t util;          // percent of the device
  uint64_t mem_used;     // bytes
  uint64_t owner_token;  // namespace-independent tenant identity
};
static_assert(sizeof(TcProcUtil) == 24, "ABI");

struct TcDeviceRecord {
  uint64_t seq;
  uint64_t timestamp_ns;  // writer's CLOCK_MONOTONIC
  int32_t device_util;    // percent
  int32_t proc_count;
  TcProcUtil procs[kMaxProcs];
};
static_assert(sizeof(TcDeviceRecord) == 24 + 32 * 24, "ABI");

struct TcUtilFile {
  uint32_t magic;
  uint32_t version;
  int32_t device_count;
  int32_t pad_;
  TcDeviceRecord records[kMaxDeviceCount];
};
static_assert(offsetof(TcUtilFile, records) == 16, "ABI");
static_assert(sizeof(TcUtilFile) == 16 + 64 * (24 + 32 * 24), "ABI");

// v2: one calibration block after the records: the node's excess table
// (manager/obs_calibrate.py), which the interposer adopts at its tick.
struct TcCalibration {
  uint64_t seq;
  uint64_t timestamp_ns;
  int32_t n_points;
  int32_t pad_;
  int64_t gap_us[kMaxExcessPoints];
  int64_t excess_us[kMaxExcessPoints];
};
static_assert(sizeof(TcCalibration) == 24 + 2 * 8 * 8, "ABI");

// vmem_node.config: one entry per (process, device).
constexpr uint32_t kVmemMagic = 0x4D454D56;  // "VMEM"
constexpr uint32_t kVmemVersion = 3;
constexpr int kVmemMaxEntries = 1024;

struct VmemEntry {
  int32_t pid;  // 0 = free slot
  int32_t host_index;
  uint64_t bytes;
  uint64_t last_update_ns;
  uint64_t owner_token;
  uint64_t activity;  // launches; the node watcher shares util by deltas
  uint64_t spilled;
};
static_assert(sizeof(VmemEntry) == 48, "ABI");
static_assert(offsetof(VmemEntry, spilled) == 40, "ABI");

struct VmemFile {
  uint32_t magic;
  uint32_t version;
  int32_t max_entries;
  int32_t pad_;
  VmemEntry entries[kVmemMaxEntries];
};
static_assert(sizeof(VmemFile) == 16 + 1024 * 48, "ABI");

// pids.config: the node registry's attested pids of one container
// (registry/server.py write_pids_config), in its config dir.
constexpr uint32_t kPidsMagic = 0x53444950;  // "PIDS"

struct PidsFileHeader {
  uint32_t magic;
  uint32_t version;
  int32_t count;
  int32_t pad_;
  // followed by count little-endian int32 pids
};
static_assert(sizeof(PidsFileHeader) == 16, "ABI");

// The dead-entry staleness window (VTPU_VMEM_STALE_S), clamped as the
// Python ledger clamps it: unparsable, <= 0 or NaN is 120 s, huge values
// cap at 1e10 s before the conversion.
inline uint64_t VmemStaleReapNsFromEnv(const char* v) {
  double s = v ? atof(v) : 120.0;
  if (!(s > 0)) s = 120.0;
  if (s > 1e10) s = 1e10;
  return (uint64_t)(s * 1e9);
}

}  // namespace vtpu_abi
