// strobe-time-experiment: the ALIGNED strobe variant — instead of
// sleeping a fixed period between adjustments (strobe-time), each
// adjustment lands on the next exact multiple of <period> on the
// monotonic clock (tick = anchor + n*period), so clock jumps arrive on
// a precise grid however long settimeofday itself takes. C++ port of
// the reference's experimental tool
// (jepsen/resources/strobe-time-experiment.c:1-205 — unwired there,
// and not even compilable: its timespec_to_nanos declaration, `null`
// literal and inverted cmp loop are artifacts of abandonment; this
// port implements the evident intent with those bugs fixed), uploaded
// to nodes and compiled there by jepsen_tpu_torch.nemesis.time.
//
// usage: strobe-time-experiment [--dry-run] <delta-ms> <period-ms>
//                               <duration-s>
//   Alternates the wall clock between its normal offset and
//   normal+delta at every period tick for duration seconds, restores
//   the normal offset, and prints the number of adjustments. With
//   --dry-run the full tick loop runs (including sleeps) but the wall
//   clock is never touched — for tests and rootless sanity checks.

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

void set_wall_clock(Nanos t, struct timezone tz, bool dry_run) {
  if (dry_run)
    return;
  timeval tv{};
  tv.tv_sec = t.count() / 1000000000LL;
  tv.tv_usec = (t.count() % 1000000000LL) / 1000LL;
  if (settimeofday(&tv, &tz) != 0) {
    std::perror("settimeofday");
    std::exit(2);
  }
}

Nanos mono_now() {
  return std::chrono::duration_cast<Nanos>(
      Clock::now().time_since_epoch());
}

// The next grid point strictly after `now`:
// anchor + ceil((now - anchor) / period) * period
// (strobe-time-experiment.c:186-198's next_tick intent)
Nanos next_tick(Nanos period, Nanos anchor, Nanos now) {
  const int64_t elapsed = (now - anchor).count();
  const int64_t p = period.count();
  const int64_t n = elapsed / p + 1;
  return anchor + Nanos{n * p};
}

} // namespace

int main(int argc, char **argv) {
  bool dry_run = false;
  int arg0 = 1;
  if (argc > 1 && std::strcmp(argv[1], "--dry-run") == 0) {
    dry_run = true;
    arg0 = 2;
  }
  if (argc - arg0 != 3) {
    std::fprintf(stderr,
                 "usage: %s [--dry-run] <delta-ms> <period-ms> "
                 "<duration-s>\n"
                 "Alternates the wall clock between normal and "
                 "normal+delta at every exact multiple of period on "
                 "the monotonic clock, for duration seconds.\n",
                 argv[0]);
    return 1;
  }
  const Nanos delta{
      static_cast<int64_t>(std::atof(argv[arg0]) * 1000000.0)};
  const Nanos period{
      static_cast<int64_t>(std::atof(argv[arg0 + 1]) * 1000000.0)};
  const Nanos duration{
      static_cast<int64_t>(std::atof(argv[arg0 + 2]) * 1000000000.0)};
  if (period.count() <= 0) {
    std::fprintf(stderr, "period must be positive\n");
    return 1;
  }

  const Nanos normal_offset = wall_now() - mono_now();
  const Nanos weird_offset = normal_offset + delta;
  const struct timezone tz = wall_tz();

  const Nanos anchor = mono_now();
  const Nanos end = anchor + duration;
  bool weird = false;
  int64_t count = 0;

  // Bound on the TICK, not the current time: checking `mono_now() <
  // end` before sleeping would let the final adjustment land up to one
  // full period past the requested duration.
  for (;;) {
    const Nanos tick = next_tick(period, anchor, mono_now());
    if (tick >= end) break;
    std::this_thread::sleep_for(tick - mono_now());
    set_wall_clock(mono_now() + (weird ? normal_offset : weird_offset), tz,
                   dry_run);
    weird = !weird;
    count += 1;
  }

  set_wall_clock(mono_now() + normal_offset, tz, dry_run);
  std::printf("%lld\n", static_cast<long long>(count));
  return 0;
}
