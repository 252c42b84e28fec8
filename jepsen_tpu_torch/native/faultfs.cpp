// faultfs: filesystem fault injection via LD_PRELOAD interposition.
//
// TPU-era equivalent of the charybdefs FUSE layer the reference drives
// (charybdefs/src/jepsen/charybdefs.clj:40-85 — studied
// for behavior, not copied; charybdefs mounts a thrift-controlled FUSE
// passthrough at /faulty, this interposes libc I/O in the DB process
// itself, which needs no kernel module, no mount point, and no thrift).
//
// Control protocol: a small text file (FAULTFS_CTL env var, default
// /tmp/faultfs.ctl) re-read at most every 100 ms:
//     line 1:  off | all | percent <n>
//     line 2:  path prefix to affect (optional; default: everything)
// "all" fails every intercepted call with EIO (charybdefs break-all);
// "percent 1" fails ~1% of calls (break-one-percent); "off" is clear.
//
// Interposed: open/open64/openat/creat (fault at open + fd tracking),
// read/write/pread/pwrite/pread64/pwrite64/fsync/fdatasync on tracked
// fds, close (untrack). Faults are scoped to the path prefix so only
// the system under test's data directory misbehaves.
//
// Build:  g++ -shared -fPIC -O2 -o libfaultfs.so faultfs.cpp -ldl
// Use:    LD_PRELOAD=/path/libfaultfs.so FAULTFS_CTL=/path/ctl db-binary

#include <dlfcn.h>
#include <errno.h>
#include <fcntl.h>
#include <pthread.h>
#include <stdarg.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <time.h>
#include <unistd.h>

namespace {

enum Mode { MODE_OFF = 0, MODE_ALL = 1, MODE_PERCENT = 2 };

constexpr int kMaxFds = 65536;
constexpr long kRefreshNs = 100L * 1000 * 1000;  // 100 ms

long now_ns() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return ts.tv_sec * 1000000000L + ts.tv_nsec;
}

struct State {
  pthread_mutex_t mu = PTHREAD_MUTEX_INITIALIZER;
  Mode mode = MODE_OFF;
  int pct = 0;
  char prefix[4096] = {0};
  long last_refresh_ns = -1;
  unsigned rng;
  bool tracked[kMaxFds] = {false};

  State() {
    // per-process seed — a fixed constant would make every freshly
    // exec'd DB process roll the identical fault sequence. Seeding in
    // the constructor rides C++11's thread-safe function-local static
    // initialization (no racy lazy flag).
    unsigned seed = (unsigned)getpid() ^ (unsigned)now_ns();
    rng = seed ? seed : 0x2545F491u;
  }
};

State *state() {
  static State s;
  return &s;
}

const char *ctl_path() {
  const char *p = getenv("FAULTFS_CTL");
  return p && *p ? p : "/tmp/faultfs.ctl";
}

// Must use the real open/read to load the control file, or we'd
// recurse into our own interposers.
typedef int (*open_fn)(const char *, int, ...);
typedef ssize_t (*read_fn)(int, void *, size_t);
typedef int (*close_fn)(int);

template <typename T>
T real(const char *name) {
  static_assert(sizeof(T) == sizeof(void *), "fn ptr size");
  void *p = dlsym(RTLD_NEXT, name);
  T out;
  memcpy(&out, &p, sizeof(out));
  return out;
}

void refresh_locked(State *s) {
  long t = now_ns();
  if (s->last_refresh_ns >= 0 && t - s->last_refresh_ns < kRefreshNs) return;
  s->last_refresh_ns = t;
  static open_fn ropen = real<open_fn>("open");
  static read_fn rread = real<read_fn>("read");
  static close_fn rclose = real<close_fn>("close");
  int fd = ropen(ctl_path(), O_RDONLY);
  if (fd < 0) {
    s->mode = MODE_OFF;
    return;
  }
  char buf[8192];
  ssize_t n = rread(fd, buf, sizeof(buf) - 1);
  rclose(fd);
  if (n <= 0) {
    s->mode = MODE_OFF;
    return;
  }
  buf[n] = 0;
  char mode_word[32] = {0};
  int pct = 0;
  char pfx[4096] = {0};
  char *nl = strchr(buf, '\n');
  if (nl) {
    *nl = 0;
    char *p2 = nl + 1;
    char *nl2 = strchr(p2, '\n');
    if (nl2) *nl2 = 0;
    strncpy(pfx, p2, sizeof(pfx) - 1);
  }
  if (sscanf(buf, "%31s %d", mode_word, &pct) < 1) {
    s->mode = MODE_OFF;
    return;
  }
  if (strcmp(mode_word, "all") == 0) {
    s->mode = MODE_ALL;
  } else if (strcmp(mode_word, "percent") == 0) {
    s->mode = MODE_PERCENT;
    s->pct = pct < 0 ? 0 : (pct > 100 ? 100 : pct);
  } else {
    s->mode = MODE_OFF;
  }
  strncpy(s->prefix, pfx, sizeof(s->prefix) - 1);
}

bool path_in_scope_locked(State *s, const char *path) {
  if (!s->prefix[0]) return true;
  return path && strncmp(path, s->prefix, strlen(s->prefix)) == 0;
}

// xorshift — cheap, no libc rand() state contention
bool roll_locked(State *s) {
  s->rng ^= s->rng << 13;
  s->rng ^= s->rng >> 17;
  s->rng ^= s->rng << 5;
  return (int)(s->rng % 100u) < s->pct;
}

// Decide a fault for an op on `path` (open-style; also tracks fd intent).
bool fault_for_path(const char *path, bool *in_scope) {
  State *s = state();
  pthread_mutex_lock(&s->mu);
  refresh_locked(s);
  bool scope = path_in_scope_locked(s, path);
  bool fault = false;
  if (scope) {
    if (s->mode == MODE_ALL)
      fault = true;
    else if (s->mode == MODE_PERCENT)
      fault = roll_locked(s);
  }
  pthread_mutex_unlock(&s->mu);
  if (in_scope) *in_scope = scope;
  return fault;
}

// Decide a fault for an op on a tracked fd. The untracked case — every
// socket, pipe, and out-of-scope file in the process — must not pay for
// the mutex or control-file refresh, or the interposer would serialize
// the DB's whole I/O hot path and distort the concurrency under test:
// a racy unlocked peek at tracked[] is safe because entries only flip
// on open/close of that same fd (which the caller orders anyway).
bool fault_for_fd(int fd) {
  if (fd < 0 || fd >= kMaxFds) return false;
  State *s = state();
  if (!__atomic_load_n(&s->tracked[fd], __ATOMIC_ACQUIRE)) return false;
  pthread_mutex_lock(&s->mu);
  refresh_locked(s);
  bool fault = false;
  if (s->tracked[fd]) {
    if (s->mode == MODE_ALL)
      fault = true;
    else if (s->mode == MODE_PERCENT)
      fault = roll_locked(s);
  }
  pthread_mutex_unlock(&s->mu);
  return fault;
}

void track_fd(int fd, bool on) {
  if (fd < 0 || fd >= kMaxFds) return;
  State *s = state();
  // cold path (open/close): keep the mutex so untracking an fd
  // happens-before any other thread's use of a recycled fd number —
  // a plain relaxed store could leak a stale 'tracked' into an
  // innocent socket that reuses the fd
  pthread_mutex_lock(&s->mu);
  __atomic_store_n(&s->tracked[fd], on, __ATOMIC_RELEASE);
  pthread_mutex_unlock(&s->mu);
}

}  // namespace

extern "C" {

int open(const char *path, int flags, ...) {
  mode_t mode = 0;
  if (flags & O_CREAT) {
    va_list ap;
    va_start(ap, flags);
    mode = va_arg(ap, mode_t);
    va_end(ap);
  }
  bool in_scope = false;
  if (fault_for_path(path, &in_scope)) {
    errno = EIO;
    return -1;
  }
  static open_fn ropen = real<open_fn>("open");
  int fd = ropen(path, flags, mode);
  if (fd >= 0 && in_scope) track_fd(fd, true);
  return fd;
}

int open64(const char *path, int flags, ...) {
  mode_t mode = 0;
  if (flags & O_CREAT) {
    va_list ap;
    va_start(ap, flags);
    mode = va_arg(ap, mode_t);
    va_end(ap);
  }
  bool in_scope = false;
  if (fault_for_path(path, &in_scope)) {
    errno = EIO;
    return -1;
  }
  static open_fn ropen = real<open_fn>("open64");
  int fd = ropen(path, flags, mode);
  if (fd >= 0 && in_scope) track_fd(fd, true);
  return fd;
}

int openat(int dirfd, const char *path, int flags, ...) {
  mode_t mode = 0;
  if (flags & O_CREAT) {
    va_list ap;
    va_start(ap, flags);
    mode = va_arg(ap, mode_t);
    va_end(ap);
  }
  // Prefix scoping applies to absolute paths; AT_FDCWD-relative paths
  // are resolved against cwd for matching.
  char resolved[8192];
  const char *match = path;
  if (path && path[0] != '/' && dirfd == AT_FDCWD &&
      strlen(path) + 2 < sizeof(resolved)) {
    if (getcwd(resolved, sizeof(resolved) - strlen(path) - 2)) {
      size_t len = strlen(resolved);
      resolved[len] = '/';
      strcpy(resolved + len + 1, path);
      match = resolved;
    }
  }
  bool in_scope = false;
  if (fault_for_path(match, &in_scope)) {
    errno = EIO;
    return -1;
  }
  typedef int (*openat_fn)(int, const char *, int, ...);
  static openat_fn ropenat = real<openat_fn>("openat");
  int fd = ropenat(dirfd, path, flags, mode);
  if (fd >= 0 && in_scope) track_fd(fd, true);
  return fd;
}

int creat(const char *path, mode_t mode) {
  return open(path, O_CREAT | O_WRONLY | O_TRUNC, mode);
}

ssize_t read(int fd, void *buf, size_t count) {
  if (fault_for_fd(fd)) {
    errno = EIO;
    return -1;
  }
  static read_fn rread = real<read_fn>("read");
  return rread(fd, buf, count);
}

ssize_t write(int fd, const void *buf, size_t count) {
  if (fault_for_fd(fd)) {
    errno = EIO;
    return -1;
  }
  typedef ssize_t (*write_fn)(int, const void *, size_t);
  static write_fn rwrite = real<write_fn>("write");
  return rwrite(fd, buf, count);
}

ssize_t pread(int fd, void *buf, size_t count, off_t off) {
  if (fault_for_fd(fd)) {
    errno = EIO;
    return -1;
  }
  typedef ssize_t (*pread_fn)(int, void *, size_t, off_t);
  static pread_fn rpread = real<pread_fn>("pread");
  return rpread(fd, buf, count, off);
}

ssize_t pwrite(int fd, const void *buf, size_t count, off_t off) {
  if (fault_for_fd(fd)) {
    errno = EIO;
    return -1;
  }
  typedef ssize_t (*pwrite_fn)(int, const void *, size_t, off_t);
  static pwrite_fn rpwrite = real<pwrite_fn>("pwrite");
  return rpwrite(fd, buf, count, off);
}

ssize_t pread64(int fd, void *buf, size_t count, off_t off) {
  if (fault_for_fd(fd)) {
    errno = EIO;
    return -1;
  }
  typedef ssize_t (*pread_fn)(int, void *, size_t, off_t);
  static pread_fn rpread = real<pread_fn>("pread64");
  return rpread(fd, buf, count, off);
}

ssize_t pwrite64(int fd, const void *buf, size_t count, off_t off) {
  if (fault_for_fd(fd)) {
    errno = EIO;
    return -1;
  }
  typedef ssize_t (*pwrite_fn)(int, const void *, size_t, off_t);
  static pwrite_fn rpwrite = real<pwrite_fn>("pwrite64");
  return rpwrite(fd, buf, count, off);
}

int fsync(int fd) {
  if (fault_for_fd(fd)) {
    errno = EIO;
    return -1;
  }
  typedef int (*fsync_fn)(int);
  static fsync_fn rfsync = real<fsync_fn>("fsync");
  return rfsync(fd);
}

int fdatasync(int fd) {
  if (fault_for_fd(fd)) {
    errno = EIO;
    return -1;
  }
  typedef int (*fsync_fn)(int);
  static fsync_fn rfdatasync = real<fsync_fn>("fdatasync");
  return rfdatasync(fd);
}

int close(int fd) {
  track_fd(fd, false);
  static close_fn rclose = real<close_fn>("close");
  return rclose(fd);
}

}  // extern "C"
