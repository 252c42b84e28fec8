// strobe-time: oscillate the wall clock by +/- <delta> ms every <period>
// ms for <duration> seconds, measured against CLOCK_MONOTONIC, then
// restore the normal offset. C++ port of the reference tool
// (jepsen/resources/strobe-time.c:1-171), uploaded to nodes and compiled
// there by jepsen_tpu_torch.nemesis.time.
//
// usage: strobe-time [--dry-run] <delta-ms> <period-ms> <duration-s>
//   Prints the number of clock adjustments made. With --dry-run, runs
//   the full strobe loop (including the sleeps) but never touches the
//   wall clock — for tests and rootless sanity checks.

#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <sys/time.h>
#include <thread>

namespace {

using Nanos = std::chrono::nanoseconds;
using Clock = std::chrono::steady_clock; // CLOCK_MONOTONIC

// Wall clock now, as nanoseconds since the epoch (strobe-time.c:36-46)
Nanos wall_now() {
  timeval tv{};
  struct timezone tz{};
  if (gettimeofday(&tv, &tz) != 0) {
    std::perror("gettimeofday");
    std::exit(1);
  }
  return Nanos{static_cast<int64_t>(tv.tv_sec) * 1000000000LL +
               static_cast<int64_t>(tv.tv_usec) * 1000LL};
}

struct timezone wall_tz() {
  timeval tv{};
  struct timezone tz{};
  if (gettimeofday(&tv, &tz) != 0) {
    std::perror("gettimeofday");
    std::exit(1);
  }
  return tz;
}

// settimeofday from an epoch-nanos value (strobe-time.c:59-68)
void set_wall_clock(Nanos t, struct timezone tz, bool dry_run) {
  if (dry_run)
    return;
  timeval tv{};
  tv.tv_sec = static_cast<time_t>(t.count() / 1000000000LL);
  tv.tv_usec = static_cast<suseconds_t>((t.count() % 1000000000LL) / 1000LL);
  if (tv.tv_usec < 0) {
    tv.tv_sec -= 1;
    tv.tv_usec += 1000000;
  }
  if (settimeofday(&tv, &tz) != 0) {
    std::perror("settimeofday");
    std::exit(2);
  }
}

Nanos monotonic_now() {
  return std::chrono::duration_cast<Nanos>(Clock::now().time_since_epoch());
}

} // namespace

int main(int argc, char **argv) {
  bool dry_run = false;
  const char *pos[3] = {nullptr, nullptr, nullptr};
  int npos = 0;
  for (int i = 1; i < argc && npos <= 3; i++) {
    if (std::strcmp(argv[i], "--dry-run") == 0 ||
        std::strcmp(argv[i], "-n") == 0) {
      dry_run = true;
    } else if (npos < 3) {
      pos[npos++] = argv[i];
    }
  }
  if (npos < 3) {
    std::fprintf(stderr, "usage: %s [--dry-run] <delta> <period> <duration>\n",
                 argv[0]);
    std::fprintf(stderr,
                 "Delta and period are in ms, duration is in seconds. Every "
                 "period ms, adjusts the clock forward by delta ms, or, "
                 "alternatively, back by delta ms. Does this for duration "
                 "seconds, then exits. Useful for confusing the heck out of "
                 "systems that assume clocks are monotonic and linear.\n");
    return 1;
  }

  const Nanos delta{static_cast<int64_t>(std::atof(pos[0]) * 1e6)};
  const Nanos period{static_cast<int64_t>(std::atof(pos[1]) * 1e6)};
  const Nanos duration{static_cast<int64_t>(std::atof(pos[2]) * 1e9)};

  // How far ahead of the monotonic clock is wall time?
  // (strobe-time.c:133-135)
  const Nanos normal_offset = wall_now() - monotonic_now();
  const Nanos weird_offset = normal_offset + delta;
  const struct timezone tz = wall_tz();

  const Nanos end = monotonic_now() + duration;
  bool weird = false;
  int64_t count = 0;

  // Strobe until duration's up (strobe-time.c:152-165)
  while (monotonic_now() < end) {
    set_wall_clock(monotonic_now() + (weird ? normal_offset : weird_offset),
                   tz, dry_run);
    weird = !weird;
    count += 1;
    std::this_thread::sleep_for(period);
  }

  // Restore the normal wall/monotonic offset (strobe-time.c:167-169)
  set_wall_clock(monotonic_now() + normal_offset, tz, dry_run);
  std::printf("%lld\n", static_cast<long long>(count));
  return 0;
}
