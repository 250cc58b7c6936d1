// quota_reclaim_probe — rename-to-adoption latency through the interposer's
// own QuotaReloader (vtpu_quota_abi.h), the port's counterpart of
// library/tools/quota_reclaim_probe.cc.
//
// The probe does what a throttled tenant's wait loop does at the
// interposer's quantum: sleep 2 ms, then one QuotaReloader::Check(). The
// caller rewrites the config with a bumped quota_epoch (tmp + rename) and
// stamps the rename; each ADOPT line carries the adoption's CLOCK_REALTIME
// stamp, so the difference is the revoke-to-enforcement latency: one
// quantum and one re-read, plus the host's scheduling.
//
// Usage: quota_reclaim_probe <config_path> <n_adoptions>
// Prints READY <epoch>, then per adoption
//   ADOPT <epoch> <wall_ns> <lease_core of device 0> <effective of device 0>
// Exit: 0 after n adoptions, 2 on usage, 3 on a bad first config, 4 when
// 30 s pass without them.

#include <stdio.h>
#include <stdlib.h>
#include <time.h>
#include <unistd.h>

#include "vtpu_quota_abi.h"

namespace {

uint64_t WallNs() {
  struct timespec ts;
  clock_gettime(CLOCK_REALTIME, &ts);
  return (uint64_t)ts.tv_sec * 1000000000ull + (uint64_t)ts.tv_nsec;
}

constexpr int64_t kQuantumUs = 2000;  // enforce_quota.cc kQuantumNs

}  // namespace

int main(int argc, char** argv) {
  if (argc < 3) return 2;
  vtpu_abi::QuotaReloader reloader(argv[1]);
  vtpu_abi::VtpuConfig cfg;
  if (!reloader.Check(&cfg)) return 3;  // the first read takes the baseline
  int want = atoi(argv[2]);
  printf("READY %u\n", cfg.quota_epoch);
  fflush(stdout);
  int adopted = 0;
  int64_t budget = 30ll * 1000 * 1000 / kQuantumUs;
  while (adopted < want && budget-- > 0) {
    usleep(kQuantumUs);
    if (!reloader.Check(&cfg)) continue;
    const vtpu_abi::VtpuDevice* d = cfg.device_count > 0 ? &cfg.devices[0]
                                                         : nullptr;
    printf("ADOPT %u %llu %d %d\n", cfg.quota_epoch,
           (unsigned long long)WallNs(), d ? d->lease_core : 0,
           d ? vtpu_abi::EffectiveCorePct(d->hard_core, d->lease_core) : 0);
    fflush(stdout);
    adopted++;
  }
  return adopted == want ? 0 : 4;
}
