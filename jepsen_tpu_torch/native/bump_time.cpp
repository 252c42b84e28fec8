// bump-time: one-shot wall-clock jump by <delta> milliseconds.
// C++ port of the reference tool (jepsen/resources/bump-time.c:1-53),
// uploaded to nodes and compiled there by jepsen_tpu_torch.nemesis.time
// (the analog of nemesis/time.clj:14-41).
//
// usage: bump-time [--dry-run] <delta-ms>
//   Adjusts the system wall clock by delta ms and prints the resulting
//   time as "seconds.microseconds". With --dry-run, computes and prints
//   the would-be time without calling settimeofday (for tests and
//   rootless sanity checks).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <sys/time.h>

namespace {

// Normalize tv_usec into [0, 1e6) (bump-time.c:30-38)
void balance(timeval &t) {
  while (t.tv_usec < 0) {
    t.tv_sec -= 1;
    t.tv_usec += 1000000;
  }
  while (t.tv_usec >= 1000000) {
    t.tv_sec += 1;
    t.tv_usec -= 1000000;
  }
}

} // namespace

int main(int argc, char **argv) {
  bool dry_run = false;
  const char *delta_arg = nullptr;
  for (int i = 1; i < argc; i++) {
    if (std::strcmp(argv[i], "--dry-run") == 0 ||
        std::strcmp(argv[i], "-n") == 0) {
      dry_run = true;
    } else {
      delta_arg = argv[i];
    }
  }
  if (delta_arg == nullptr) {
    std::fprintf(stderr, "usage: %s [--dry-run] <delta>, where delta is in ms\n",
                 argv[0]);
    return 1;
  }

  const int64_t delta_us_total =
      static_cast<int64_t>(std::atof(delta_arg) * 1000.0);

  timeval now{};
  timezone tz{};
  if (gettimeofday(&now, &tz) != 0) {
    std::perror("gettimeofday");
    return 1;
  }

  now.tv_usec += delta_us_total % 1000000;
  now.tv_sec += delta_us_total / 1000000;
  balance(now);

  if (!dry_run) {
    if (settimeofday(&now, &tz) != 0) {
      std::perror("settimeofday");
      return 2;
    }
    if (gettimeofday(&now, &tz) != 0) {
      std::perror("gettimeofday");
      return 1;
    }
  }

  std::printf("%lld.%06lld\n", static_cast<long long>(now.tv_sec),
              static_cast<long long>(now.tv_usec));
  return 0;
}
