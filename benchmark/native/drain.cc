// The harness's sink: drains one output FIFO to its end with no
// interpreter on the path. Bytes that are not kept go from the pipe to
// /dev/null by splice(2), never copied into this process; the first
// `head_len` bytes, and with `keep` the stream whole (as far as it fits),
// are read into the caller's buffers. A FLAC stream is read whole and its
// frames counted as it passes (flac.h's Scanner). Every byte is counted.
//
// The FIFO is opened without blocking, so a drain whose writer never
// comes does not hang: it waits for a writer, and for each next byte, at
// most `limit_s` seconds, then ends.
#include <errno.h>
#include <fcntl.h>
#include <poll.h>
#include <time.h>
#include <unistd.h>

#include <cstring>
#include <vector>

#include "flac.h"

namespace {

const size_t CHUNK = 1 << 20;

double now() {
  timespec t;
  clock_gettime(CLOCK_MONOTONIC, &t);
  return (double)t.tv_sec + 1e-9 * (double)t.tv_nsec;
}

}  // namespace

extern "C" {

// The FIFO's read end, opened without blocking, its pipe widened as far
// as the system allows, up to 16 MiB (a writer that finds room does not
// wait on this drain); or -errno.
int bench_open(const char* path) {
  int fd = open(path, O_RDONLY | O_NONBLOCK | O_CLOEXEC);
  if (fd < 0) return -errno;
  for (int size = 16 << 20; size >= (int)CHUNK; size /= 2)
    if (fcntl(fd, F_SETPIPE_SZ, size) >= 0) break;
  return fd;
}

// Drains fd (from bench_open) to its end and closes it. res receives
// [bytes, head bytes, kept bytes, status, FLAC frames, FLAC samples, FLAC
// bad, FLAC stray bytes]; status is 0, or -ETIMEDOUT where no writer came
// or no byte came for limit_s seconds, or another -errno.
void bench_drain(int fd, uint8_t* head, int64_t head_len, uint8_t* keep,
                 int64_t keep_len, int flac, double limit_s, int64_t* res) {
  benchflac::Scanner scan;
  std::vector<uint8_t> scratch;
  int devnull = open("/dev/null", O_WRONLY | O_CLOEXEC);
  bool use_splice = devnull >= 0 && !flac;
  int64_t total = 0, got_head = 0, kept = 0, status = 0;
  double last = now();
  bool ready = false;
  for (;;) {
    if (!ready) {
      // wait for a writer or a byte. Before its first writer a FIFO
      // reports no hang-up and a read would return 0, so a drain reads
      // only after this wait says there is data or the writers have gone.
      double left = limit_s - (now() - last);
      if (left <= 0) {
        status = -ETIMEDOUT;
        break;
      }
      pollfd p = {fd, POLLIN, 0};
      int r = poll(&p, 1, (int)(left * 1000) + 1);
      if (r < 0 && errno != EINTR) {
        status = -errno;
        break;
      }
      ready = r > 0;
      continue;
    }
    uint8_t* into = nullptr;
    size_t room = CHUNK;
    if (keep != nullptr && kept < keep_len) {
      into = keep + kept, room = (size_t)(keep_len - kept);
      if (room > CHUNK) room = CHUNK;
    } else if (got_head < head_len) {
      into = head + got_head, room = (size_t)(head_len - got_head);
    } else if (!use_splice) {
      scratch.resize(CHUNK);
      into = scratch.data();
    }
    ssize_t n;
    if (into != nullptr) {
      n = read(fd, into, room);
    } else {
      n = splice(fd, nullptr, devnull, nullptr, CHUNK, SPLICE_F_NONBLOCK);
      if (n < 0 && (errno == EINVAL || errno == ENOSYS)) {
        use_splice = false;  // this kernel splices no pipe to /dev/null
        continue;
      }
    }
    if (n > 0) {
      if (into != nullptr && got_head < head_len) {
        // the head is the stream's first bytes, kept or not
        int64_t take = n < head_len - got_head ? n : head_len - got_head;
        if (into != head + got_head) memcpy(head + got_head, into, (size_t)take);
        got_head += take;
      }
      if (keep != nullptr && into == keep + kept) kept += n;
      if (flac && into != nullptr) scan.feed(into, (size_t)n);
      total += n;
      last = now();
      continue;
    }
    if (n == 0) break;  // every writer has closed
    if (errno == EINTR) continue;
    if (errno != EAGAIN) {
      status = -errno;
      break;
    }
    ready = false;
  }
  if (flac) scan.finish();
  close(fd);
  if (devnull >= 0) close(devnull);
  int64_t v[8] = {total, got_head, kept, status,
                  scan.frames, scan.samples, scan.bad, scan.stray};
  for (int i = 0; i < 8; ++i) res[i] = v[i];
}
}
