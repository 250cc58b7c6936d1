// vtpu_telemetry_abi.h — the step ring, as the interposer writes it.
//
// The port's own copy of library/include/vtpu_telemetry.h:34-304: ring
// layout version 4 (an 80-byte header, 256 records of 104 bytes) and its
// writer. The Python writer and reader are
// vtpu_manager_torch/telemetry/stepring.py; tests/test_torch_stepring_shim.py
// compiles this header beside the JAX package's and checks that every size
// and offset agrees, and reads the interposer's rings with both packages'
// readers.
//
// One writer per ring: an OFD write lock on the header, taken when the
// writer opens the ring and held until it closes. Each record carries its
// own seqlock (`seq | 1` odd before the payload, +1 even after). A writer
// that opens an existing ring continues its `writes` counter, so a
// reader's cursor stays monotone across writers.

#pragma once

#include <fcntl.h>
#include <stddef.h>
#include <stdint.h>
#include <stdio.h>
#include <string.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace vtpu_abi {

constexpr uint32_t kStepRingMagic = 0x54535456;  // "VTST"
constexpr uint32_t kStepRingVersion = 4;
constexpr int kStepRingCapacity = 256;
constexpr int kStepTraceIdLen = 48;
constexpr uint32_t kStepFlagCompile = 0x1;  // the step loaded new code
// The port's bit, in the JAX layout's reserved flags: the record's
// throttle_wait_ns is the step's time off the card, and bucket_wait_us
// (the JAX layout's pad after flags) holds its bucket's own wait. A reader
// that does not know the bit reads the layout as before.
constexpr uint32_t kStepFlagBucketWait = 0x4;

struct StepRingHeader {
  uint32_t magic;
  uint32_t version;
  int32_t capacity;
  int32_t record_size;
  int32_t writer_pid;
  int32_t pad_;
  uint64_t writes;  // records ever published: the ring's head
  char trace_id[kStepTraceIdLen];
};
static_assert(sizeof(StepRingHeader) == 80, "ABI");
static_assert(offsetof(StepRingHeader, writer_pid) == 16, "ABI");
static_assert(offsetof(StepRingHeader, writes) == 24, "ABI");
static_assert(offsetof(StepRingHeader, trace_id) == 32, "ABI");

struct StepRecord {
  uint64_t seq;  // odd while being written
  uint64_t index;
  uint64_t start_mono_ns;
  uint64_t duration_ns;
  uint64_t throttle_wait_ns;
  uint64_t hbm_highwater_bytes;
  uint32_t flags;
  uint32_t bucket_wait_us;  // with kStepFlagBucketWait, else 0
  // the spill block (v2) and the spill-fill time (v4): the overflow
  // tier's (the interposer serves no fill: fill_events stays 0); the comm
  // block (v3): CommTelemetry's, else zeros
  uint64_t spilled_bytes;
  uint32_t spill_events;
  uint32_t fill_events;
  uint64_t comm_time_ns;
  uint64_t bytes_transferred;
  uint32_t collective_count;
  uint32_t pad2_;
  uint64_t spill_fill_time_ns;
};
static_assert(sizeof(StepRecord) == 104, "ABI");
static_assert(offsetof(StepRecord, index) == 8, "ABI");
static_assert(offsetof(StepRecord, duration_ns) == 24, "ABI");
static_assert(offsetof(StepRecord, throttle_wait_ns) == 32, "ABI");
static_assert(offsetof(StepRecord, hbm_highwater_bytes) == 40, "ABI");
static_assert(offsetof(StepRecord, flags) == 48, "ABI");
static_assert(offsetof(StepRecord, spilled_bytes) == 56, "ABI");
static_assert(offsetof(StepRecord, comm_time_ns) == 72, "ABI");
static_assert(offsetof(StepRecord, spill_fill_time_ns) == 96, "ABI");

constexpr size_t kStepRingFileSize =
    sizeof(StepRingHeader) + kStepRingCapacity * sizeof(StepRecord);

// The writer (vtpu_telemetry.h:132 StepRingWriter). The constructor does
// the one-time work: create the file atomically (tmp + rename, so a reader
// never maps a partial one), take the OFD lock (a writer that finds it
// held yields: ok() is false), map it, check the header. Record() is mmap
// stores only.
class StepRingWriter {
 public:
  StepRingWriter(const char* path, const char* trace_id) {
    if (!path || !*path) return;
    struct stat st;
    if ((stat(path, &st) != 0 || (size_t)st.st_size != kStepRingFileSize) &&
        !CreateAtomically(path, trace_id))
      return;
    fd_ = open(path, O_RDWR | O_CLOEXEC);
    if (fd_ < 0) return;
    struct flock fl;
    memset(&fl, 0, sizeof(fl));
    fl.l_type = F_WRLCK;
    fl.l_whence = SEEK_SET;
    fl.l_len = (off_t)sizeof(StepRingHeader);
    void* mm = MAP_FAILED;
    if (fcntl(fd_, F_OFD_SETLK, &fl) == 0)
      mm = mmap(nullptr, kStepRingFileSize, PROT_READ | PROT_WRITE,
                MAP_SHARED, fd_, 0);
    if (mm == MAP_FAILED) {
      Close();
      return;
    }
    mm_ = static_cast<uint8_t*>(mm);
    StepRingHeader* h = Header();
    if (h->magic != kStepRingMagic || h->version != kStepRingVersion ||
        h->capacity != kStepRingCapacity ||
        h->record_size != (int32_t)sizeof(StepRecord)) {
      Close();
      return;
    }
    writes_ = __atomic_load_n(&h->writes, __ATOMIC_ACQUIRE);
    h->writer_pid = (int32_t)getpid();
    if (trace_id && *trace_id) {
      memset(h->trace_id, 0, kStepTraceIdLen);
      strncpy(h->trace_id, trace_id, kStepTraceIdLen - 1);
    }
  }
  ~StepRingWriter() { Close(); }
  StepRingWriter(const StepRingWriter&) = delete;
  StepRingWriter& operator=(const StepRingWriter&) = delete;

  bool ok() const { return mm_ != nullptr; }
  uint64_t writes() const { return writes_; }

  void Record(uint64_t start_mono_ns, uint64_t duration_ns,
              uint64_t throttle_wait_ns, uint64_t hbm_highwater_bytes,
              bool compiled, uint64_t comm_time_ns = 0,
              uint64_t bytes_transferred = 0, uint32_t collectives = 0,
              uint64_t spilled_bytes = 0, uint32_t spill_events = 0,
              uint64_t spill_fill_time_ns = 0,
              int64_t bucket_wait_ns = -1) {
    if (!mm_) return;
    uint64_t index = writes_;
    StepRecord* rec = reinterpret_cast<StepRecord*>(
        mm_ + sizeof(StepRingHeader) +
        (index % kStepRingCapacity) * sizeof(StepRecord));
    uint64_t wseq = __atomic_load_n(&rec->seq, __ATOMIC_RELAXED) | 1;
    __atomic_store_n(&rec->seq, wseq, __ATOMIC_RELEASE);
    memset(reinterpret_cast<uint8_t*>(rec) + sizeof(rec->seq), 0,
           sizeof(StepRecord) - sizeof(rec->seq));
    rec->index = index;
    rec->start_mono_ns = start_mono_ns;
    rec->duration_ns = duration_ns;
    rec->throttle_wait_ns = throttle_wait_ns;
    rec->hbm_highwater_bytes = hbm_highwater_bytes;
    rec->flags = compiled ? kStepFlagCompile : 0;
    if (bucket_wait_ns >= 0) {
      // carried apart: throttle_wait_ns is then the step's time off the card
      rec->flags |= kStepFlagBucketWait;
      uint64_t us = (uint64_t)bucket_wait_ns / 1000;
      rec->bucket_wait_us = us > UINT32_MAX ? UINT32_MAX : (uint32_t)us;
    }
    rec->comm_time_ns = comm_time_ns;
    rec->bytes_transferred = bytes_transferred;
    rec->collective_count = collectives;
    rec->spilled_bytes = spilled_bytes;
    rec->spill_events = spill_events;
    rec->spill_fill_time_ns = spill_fill_time_ns;
    __atomic_store_n(&rec->seq, wseq + 1, __ATOMIC_RELEASE);
    writes_ = index + 1;
    __atomic_store_n(&Header()->writes, writes_, __ATOMIC_RELEASE);
  }

  // Unmaps the ring and closes the file; the kernel drops the OFD lock
  // with the descriptor.
  void Close() {
    if (mm_) munmap(mm_, kStepRingFileSize);
    mm_ = nullptr;
    if (fd_ >= 0) close(fd_);
    fd_ = -1;
  }

 private:
  StepRingHeader* Header() { return reinterpret_cast<StepRingHeader*>(mm_); }

  static bool CreateAtomically(const char* path, const char* trace_id) {
    char tmp[4096];
    int n = snprintf(tmp, sizeof(tmp), "%s.tmp.%d", path, (int)getpid());
    if (n < 0 || (size_t)n >= sizeof(tmp)) return false;
    int fd = open(tmp, O_WRONLY | O_CREAT | O_TRUNC | O_CLOEXEC, 0644);
    if (fd < 0) return false;
    StepRingHeader h;
    memset(&h, 0, sizeof(h));
    h.magic = kStepRingMagic;
    h.version = kStepRingVersion;
    h.capacity = kStepRingCapacity;
    h.record_size = (int32_t)sizeof(StepRecord);
    h.writer_pid = (int32_t)getpid();
    if (trace_id && *trace_id) strncpy(h.trace_id, trace_id,
                                       kStepTraceIdLen - 1);
    bool ok = write(fd, &h, sizeof(h)) == (ssize_t)sizeof(h) &&
              ftruncate(fd, (off_t)kStepRingFileSize) == 0;
    close(fd);
    if (!ok || rename(tmp, path) != 0) {
      unlink(tmp);
      return false;
    }
    return true;
  }

  int fd_ = -1;
  uint8_t* mm_ = nullptr;
  uint64_t writes_ = 0;
};

}  // namespace vtpu_abi
