// vtpu_quota_abi.h — the quota market's tenant side: lease arithmetic and
// the config re-reader.
//
// The port's copy of library/include/vtpu_quota.h:37-139 over the port's
// own layouts (vtpu_abi.h). The node's quota market lends a card's idle
// compute between co-tenants by rewriting each tenant's vtpu.config
// (tmp + rename, the file's checksum guarding a torn write) with a new
// per-device lease_core and a bumped quota_epoch; a migration rewrites
// migration_freeze the same way. A rename swaps the inode, so the
// interposer cannot keep a mapping of the file: it stats the path at most
// once per throttle quantum and reads and verifies it only when the
// inode, size or nanosecond mtime moved.
//
// Header-only: enforce_quota.cc and the probe csrc/shim/test/
// quota_reclaim_probe.cc compile the same code, so the latency the tests
// measure is the interposer's.

#pragma once

#include <fcntl.h>
#include <stdio.h>
#include <sys/stat.h>
#include <unistd.h>

#include "vtpu_abi.h"

namespace vtpu_abi {

// The compute percent under a lease: the base plus the signed delta,
// clamped to a card's share (vtpu_quota.h:37). The market keeps each
// card's sum at or below 100; the clamp guards against a torn ledger.
inline int EffectiveCorePct(int base_core, int lease_core) {
  int v = base_core + lease_core;
  if (v < 0) v = 0;
  if (v > 100) v = 100;
  return v;
}

// Watches one vtpu.config path for new generations (vtpu_quota.h:50).
// Check() costs one stat() while nothing moved; a full read runs only when
// the inode, size or mtime moved, and its result is taken only when it
// validates (magic, version, checksum, device count) and carries another
// quota_epoch than the last generation taken. A torn, stale or same-epoch
// rewrite is never taken.
class QuotaReloader {
 public:
  explicit QuotaReloader(const char* path) {
    path_[0] = 0;
    if (path) snprintf(path_, sizeof(path_), "%s", path);
  }

  // The generation already loaded at start, so the first Check() does not
  // take it again.
  void Prime(uint32_t epoch) {
    last_epoch_ = epoch;
    primed_ = true;
    struct stat st;
    if (path_[0] && stat(path_, &st) == 0) RememberStat(st);
  }

  // True when a new valid generation was read into *out.
  bool Check(VtpuConfig* out) {
    if (path_[0] == 0) return false;
    struct stat st;
    if (stat(path_, &st) != 0) return false;
    if (SameStat(st)) return false;
    // a glimpse of another file shape: remember nothing, the rename lands
    // a whole file and the next check stats again
    if ((size_t)st.st_size != sizeof(VtpuConfig)) return false;
    if (!ReadAndVerify(out)) return false;
    RememberStat(st);
    if (primed_ && out->quota_epoch == last_epoch_) return false;
    last_epoch_ = out->quota_epoch;
    primed_ = true;
    return true;
  }

  uint32_t epoch() const { return last_epoch_; }
  const char* path() const { return path_; }

 private:
  // mtime to the nanosecond: the size never changes and inode numbers are
  // reused, so two rewrites within a second could otherwise look alike
  bool SameStat(const struct stat& st) const {
    return seen_stat_ && st.st_ino == last_ino_ &&
           st.st_size == last_size_ &&
           st.st_mtim.tv_sec == last_mtime_sec_ &&
           st.st_mtim.tv_nsec == last_mtime_nsec_;
  }

  void RememberStat(const struct stat& st) {
    last_ino_ = st.st_ino;
    last_size_ = st.st_size;
    last_mtime_sec_ = st.st_mtim.tv_sec;
    last_mtime_nsec_ = st.st_mtim.tv_nsec;
    seen_stat_ = true;
  }

  bool ReadAndVerify(VtpuConfig* cfg) {
    int fd = open(path_, O_RDONLY | O_CLOEXEC);
    if (fd < 0) return false;
    size_t got = 0;
    char* dst = reinterpret_cast<char*>(cfg);
    while (got < sizeof(VtpuConfig)) {
      ssize_t n = read(fd, dst + got, sizeof(VtpuConfig) - got);
      if (n <= 0) {
        close(fd);
        return false;
      }
      got += (size_t)n;
    }
    close(fd);
    return cfg->magic == kConfigMagic && cfg->version == kConfigVersion &&
           cfg->checksum == Fnv1a(reinterpret_cast<const uint8_t*>(cfg),
                                  offsetof(VtpuConfig, checksum)) &&
           cfg->device_count >= 0 && cfg->device_count <= kMaxDeviceCount;
  }

  char path_[512];
  ino_t last_ino_ = 0;
  off_t last_size_ = 0;
  time_t last_mtime_sec_ = 0;
  long last_mtime_nsec_ = 0;
  uint32_t last_epoch_ = 0;
  bool seen_stat_ = false;
  bool primed_ = false;
};

}  // namespace vtpu_abi
