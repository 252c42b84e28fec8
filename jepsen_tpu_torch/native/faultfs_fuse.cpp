// faultfs_fuse — process-agnostic filesystem fault injection: a FUSE
// passthrough filesystem speaking the RAW kernel protocol over
// /dev/fuse (no libfuse, no thrift), with an EIO fault switch driven
// by the same control file as the LD_PRELOAD interposer (faultfs.cpp).
//
// This is the TPU-era equivalent of the reference's charybdefs
// (charybdefs/src/jepsen/charybdefs.clj:40-85 builds a thrift-driven
// FUSE C++ filesystem on each node and mounts it over the data dir;
// :72-85 are break-all / break-one-percent / clear). Where the
// LD_PRELOAD interposer is a no-op for statically linked executables
// (etcd, consul, cockroach — most Go binaries), a FUSE mount faults
// ANY process's I/O, because the fault lives below the VFS boundary.
//
//   faultfs_fuse <backing_dir> <mountpoint> <ctl_file> [--foreground]
//
// Control file (re-read at most every 100 ms; same grammar as
// faultfs.cpp): first line `off` | `all` | `percent <n>`. "all" fails
// every faultable operation with EIO; "percent n" fails ~n% of them;
// "off" passes everything through. Operations the kernel needs for
// its own bookkeeping (INIT/FORGET/RELEASE/DESTROY/INTERRUPT) are
// never faulted — breaking those leaks kernel references instead of
// simulating a broken disk.
//
// Implementation notes:
// - The protocol structs come from the kernel uapi <linux/fuse.h>;
//   we negotiate down to the header's minor version in INIT and the
//   kernel handles compatibility.
// - Files open with FOPEN_DIRECT_IO so every read/write round-trips
//   to the daemon — an EIO storm must not be absorbed by the page
//   cache (the DB's own caching is above us and unaffected).
// - Inodes: nodeid -> O_PATH fd, deduped by (st_dev, st_ino) with
//   nlookup refcounts (FORGET closes at zero). I/O fds reopen via
//   /proc/self/fd — the standard passthrough trick.
// - Readdir snapshots the directory at offset 0 and serves by index,
//   sidestepping telldir cookie semantics.

#include <linux/fuse.h>

#include <dirent.h>
#include <errno.h>
#include <fcntl.h>
#include <signal.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <sys/mount.h>
#include <sys/stat.h>
#include <sys/statfs.h>
#include <sys/time.h>
#include <sys/types.h>
#include <time.h>
#include <unistd.h>

#include <cstdint>
#include <map>
#include <string>
#include <utility>
#include <vector>

namespace {

constexpr size_t kBufSize = 1 << 20;  // >= max_write + headers
constexpr uint32_t kMaxWrite = 128 * 1024;

// ---------------------------------------------------------------- ctl
struct Ctl {
  std::string path;
  int mode = 0;  // 0 off, 1 all, 2 percent
  int pct = 0;
  uint32_t rng = 0x9E3779B9u;
  struct timespec last = {0, 0};

  void refresh() {
    struct timespec now;
    clock_gettime(CLOCK_MONOTONIC, &now);
    long ms = (now.tv_sec - last.tv_sec) * 1000 +
              (now.tv_nsec - last.tv_nsec) / 1000000;
    if (last.tv_sec != 0 && ms >= 0 && ms < 100) return;
    last = now;
    int fd = open(path.c_str(), O_RDONLY);
    if (fd < 0) {
      mode = 0;
      return;
    }
    char buf[128];
    ssize_t n = read(fd, buf, sizeof buf - 1);
    close(fd);
    if (n <= 0) {
      mode = 0;
      return;
    }
    buf[n] = 0;
    char word[32];
    int p = 0;
    if (sscanf(buf, "%31s %d", word, &p) < 1) {
      mode = 0;
    } else if (strcmp(word, "all") == 0) {
      mode = 1;
    } else if (strcmp(word, "percent") == 0) {
      mode = 2;
      pct = p < 0 ? 0 : (p > 100 ? 100 : p);
    } else {
      mode = 0;
    }
  }

  bool fault() {
    refresh();
    if (mode == 1) return true;
    if (mode != 2) return false;
    rng = rng * 1664525u + 1013904223u;
    return (int)((rng >> 16) % 100u) < pct;
  }
};

// ------------------------------------------------------------- inodes
struct Inode {
  int path_fd = -1;  // O_PATH handle
  uint64_t nlookup = 0;
  dev_t dev = 0;
  ino_t ino = 0;
};

struct DirSnapshot {
  int fd = -1;  // backing dir fd (owned)
  struct Ent {
    std::string name;
    uint64_t ino;
    uint32_t type;
  };
  std::vector<Ent> ents;
  bool loaded = false;
};

struct Fs {
  std::map<uint64_t, Inode> inodes;                 // nodeid -> inode
  std::map<std::pair<dev_t, ino_t>, uint64_t> ids;  // (dev,ino) -> nodeid
  std::map<uint64_t, DirSnapshot*> dirs;            // fh -> snapshot
  uint64_t next_id = 2;  // 1 is the root
  Ctl ctl;

  int fd_of(uint64_t nodeid) {
    auto it = inodes.find(nodeid);
    return it == inodes.end() ? -1 : it->second.path_fd;
  }
};

Fs fs;

void attr_from_stat(const struct stat& st, fuse_attr* a) {
  memset(a, 0, sizeof *a);
  a->ino = st.st_ino;
  a->size = st.st_size;
  a->blocks = st.st_blocks;
  a->atime = st.st_atim.tv_sec;
  a->mtime = st.st_mtim.tv_sec;
  a->ctime = st.st_ctim.tv_sec;
  a->atimensec = st.st_atim.tv_nsec;
  a->mtimensec = st.st_mtim.tv_nsec;
  a->ctimensec = st.st_ctim.tv_nsec;
  a->mode = st.st_mode;
  a->nlink = st.st_nlink;
  a->uid = st.st_uid;
  a->gid = st.st_gid;
  a->rdev = st.st_rdev;
  a->blksize = st.st_blksize;
}

// register/lookup an inode for a child; bumps nlookup
int make_entry(int parent_fd, const char* name, fuse_entry_out* out) {
  int pfd = openat(parent_fd, name, O_PATH | O_NOFOLLOW);
  if (pfd < 0) return -errno;
  struct stat st;
  if (fstatat(pfd, "", &st, AT_EMPTY_PATH | AT_SYMLINK_NOFOLLOW) < 0) {
    int e = errno;
    close(pfd);
    return -e;
  }
  auto key = std::make_pair(st.st_dev, st.st_ino);
  uint64_t id;
  auto it = fs.ids.find(key);
  if (it != fs.ids.end()) {
    id = it->second;
    fs.inodes[id].nlookup++;
    close(pfd);
  } else {
    id = fs.next_id++;
    fs.ids[key] = id;
    Inode ino;
    ino.path_fd = pfd;
    ino.nlookup = 1;
    ino.dev = st.st_dev;
    ino.ino = st.st_ino;
    fs.inodes[id] = ino;
  }
  memset(out, 0, sizeof *out);
  out->nodeid = id;
  out->attr_valid = 1;
  out->entry_valid = 1;
  attr_from_stat(st, &out->attr);
  return 0;
}

void forget_one(uint64_t nodeid, uint64_t n) {
  auto it = fs.inodes.find(nodeid);
  if (it == fs.inodes.end() || nodeid == FUSE_ROOT_ID) return;
  if (it->second.nlookup <= n) {
    fs.ids.erase(std::make_pair(it->second.dev, it->second.ino));
    close(it->second.path_fd);
    fs.inodes.erase(it);
  } else {
    it->second.nlookup -= n;
  }
}

int reopen(int path_fd, int flags) {
  char p[64];
  snprintf(p, sizeof p, "/proc/self/fd/%d", path_fd);
  return open(p, flags);
}

// ------------------------------------------------------------ replies
int dev_fd = -1;

void send_reply(uint64_t unique, int error, const void* data, size_t size) {
  fuse_out_header h;
  h.len = (uint32_t)(sizeof h + size);
  h.error = error;
  h.unique = unique;
  struct iovec {
    const void* base;
    size_t len;
  };
  char out[kBufSize];
  memcpy(out, &h, sizeof h);
  if (size) memcpy(out + sizeof h, data, size);
  ssize_t r = write(dev_fd, out, sizeof h + size);
  (void)r;  // ENOENT from a raced INTERRUPT is fine
}

void reply_err(uint64_t unique, int negerrno) {
  send_reply(unique, negerrno, nullptr, 0);
}

// faultable-op gate: one check per request
bool faulted(uint64_t unique) {
  if (!fs.ctl.fault()) return false;
  reply_err(unique, -EIO);
  return true;
}

bool setup_root(const char* backing) {
  int fd = open(backing, O_PATH | O_DIRECTORY);
  if (fd < 0) return false;
  struct stat st;
  fstat(fd, &st);
  Inode root;
  root.path_fd = fd;
  root.nlookup = 1;
  root.dev = st.st_dev;
  root.ino = st.st_ino;
  fs.inodes[FUSE_ROOT_ID] = root;
  fs.ids[std::make_pair(st.st_dev, st.st_ino)] = FUSE_ROOT_ID;
  return true;
}

volatile sig_atomic_t stop_flag = 0;
void on_term(int) { stop_flag = 1; }

}  // namespace

int main(int argc, char** argv) {
  if (argc < 4) {
    fprintf(stderr,
            "usage: %s <backing_dir> <mountpoint> <ctl_file> "
            "[--foreground]\n",
            argv[0]);
    return 2;
  }
  const char* backing = argv[1];
  const char* mnt = argv[2];
  fs.ctl.path = argv[3];
  bool foreground = argc > 4 && strcmp(argv[4], "--foreground") == 0;

  if (!setup_root(backing)) {
    perror("backing dir");
    return 2;
  }
  dev_fd = open("/dev/fuse", O_RDWR);
  if (dev_fd < 0) {
    perror("/dev/fuse");
    return 2;
  }
  char opts[256];
  snprintf(opts, sizeof opts,
           "fd=%d,rootmode=40000,user_id=0,group_id=0,allow_other,"
           "default_permissions",
           dev_fd);
  if (mount("faultfs", mnt, "fuse.faultfs", MS_NOSUID | MS_NODEV, opts)) {
    perror("mount");
    return 2;
  }
  if (!foreground) {
    if (fork() > 0) return 0;  // parent: mount is live
    setsid();
    // detach stdio: the daemon inherits the launcher's pipes, and a
    // captured exec would otherwise block on EOF forever
    int devnull = open("/dev/null", O_RDWR);
    dup2(devnull, 0);
    dup2(devnull, 1);
    dup2(devnull, 2);
    if (devnull > 2) close(devnull);
  }
  // sigaction WITHOUT SA_RESTART: the main loop blocks in
  // read(dev_fd), and glibc's signal() would transparently restart it
  // so an idle daemon never observes stop_flag — EINTR must surface.
  struct sigaction sa;
  memset(&sa, 0, sizeof sa);
  sa.sa_handler = on_term;
  sigaction(SIGTERM, &sa, nullptr);
  sigaction(SIGINT, &sa, nullptr);

  std::vector<char> buf(kBufSize);
  while (!stop_flag) {
    ssize_t n = read(dev_fd, buf.data(), buf.size());
    if (n < 0) {
      if (errno == EINTR || errno == EAGAIN) continue;
      break;  // ENODEV: unmounted
    }
    if ((size_t)n < sizeof(fuse_in_header)) continue;
    auto* in = (fuse_in_header*)buf.data();
    char* arg = buf.data() + sizeof(fuse_in_header);

    switch (in->opcode) {
      case FUSE_INIT: {
        auto* ii = (fuse_init_in*)arg;
        fuse_init_out out;
        memset(&out, 0, sizeof out);
        out.major = FUSE_KERNEL_VERSION;
        out.minor = FUSE_KERNEL_MINOR_VERSION < ii->minor
                        ? FUSE_KERNEL_MINOR_VERSION
                        : ii->minor;
        out.max_readahead = ii->max_readahead;
        out.flags = 0;
        out.max_background = 16;
        out.congestion_threshold = 12;
        out.max_write = kMaxWrite;
        out.time_gran = 1;
        send_reply(in->unique, 0, &out, sizeof out);
        break;
      }
      case FUSE_DESTROY:
        send_reply(in->unique, 0, nullptr, 0);
        stop_flag = 1;
        break;
      case FUSE_FORGET: {
        auto* f = (fuse_forget_in*)arg;
        forget_one(in->nodeid, f->nlookup);
        break;  // no reply
      }
      case FUSE_BATCH_FORGET: {
        auto* bf = (fuse_batch_forget_in*)arg;
        auto* items = (fuse_forget_one*)(arg + sizeof *bf);
        for (uint32_t i = 0; i < bf->count; i++)
          forget_one(items[i].nodeid, items[i].nlookup);
        break;  // no reply
      }
      case FUSE_INTERRUPT:
        break;  // best-effort: we never block anyway
      case FUSE_LOOKUP: {
        if (faulted(in->unique)) break;
        fuse_entry_out out;
        int e = make_entry(fs.fd_of(in->nodeid), arg, &out);
        if (e)
          reply_err(in->unique, e);
        else
          send_reply(in->unique, 0, &out, sizeof out);
        break;
      }
      case FUSE_GETATTR: {
        if (faulted(in->unique)) break;
        struct stat st;
        int r = fstatat(fs.fd_of(in->nodeid), "", &st,
                        AT_EMPTY_PATH | AT_SYMLINK_NOFOLLOW);
        if (r < 0) {
          reply_err(in->unique, -errno);
          break;
        }
        fuse_attr_out out;
        memset(&out, 0, sizeof out);
        out.attr_valid = 1;
        attr_from_stat(st, &out.attr);
        send_reply(in->unique, 0, &out, sizeof out);
        break;
      }
      case FUSE_SETATTR: {
        if (faulted(in->unique)) break;
        auto* s = (fuse_setattr_in*)arg;
        int pfd = fs.fd_of(in->nodeid);
        int e = 0;
        int rw = -1;  // lazily opened read-write fd for truncate
        if (!e && (s->valid & FATTR_MODE))
          if (fchmod(rw = (rw >= 0 ? rw : reopen(pfd, O_RDONLY)),
                     s->mode) < 0)
            e = -errno;
        if (!e && (s->valid & (FATTR_UID | FATTR_GID))) {
          uid_t u = (s->valid & FATTR_UID) ? s->uid : (uid_t)-1;
          gid_t g = (s->valid & FATTR_GID) ? s->gid : (gid_t)-1;
          char p[64];
          snprintf(p, sizeof p, "/proc/self/fd/%d", pfd);
          if (chown(p, u, g) < 0) e = -errno;
        }
        if (!e && (s->valid & FATTR_SIZE)) {
          int tfd = (s->valid & FATTR_FH) ? (int)s->fh
                                          : reopen(pfd, O_WRONLY);
          if (tfd < 0 || ftruncate(tfd, s->size) < 0) e = -errno;
          if (!(s->valid & FATTR_FH) && tfd >= 0) close(tfd);
        }
        if (!e && (s->valid & (FATTR_ATIME | FATTR_MTIME))) {
          struct timespec ts[2];
          ts[0].tv_nsec = UTIME_OMIT;
          ts[1].tv_nsec = UTIME_OMIT;
          if (s->valid & FATTR_ATIME) {
            ts[0].tv_sec = s->atime;
            ts[0].tv_nsec = (s->valid & FATTR_ATIME_NOW) ? UTIME_NOW
                                                         : s->atimensec;
          }
          if (s->valid & FATTR_MTIME) {
            ts[1].tv_sec = s->mtime;
            ts[1].tv_nsec = (s->valid & FATTR_MTIME_NOW) ? UTIME_NOW
                                                         : s->mtimensec;
          }
          char p[64];
          snprintf(p, sizeof p, "/proc/self/fd/%d", pfd);
          if (utimensat(AT_FDCWD, p, ts, 0) < 0) e = -errno;
        }
        if (rw >= 0) close(rw);
        if (e) {
          reply_err(in->unique, e);
          break;
        }
        struct stat st;
        fstatat(pfd, "", &st, AT_EMPTY_PATH | AT_SYMLINK_NOFOLLOW);
        fuse_attr_out out;
        memset(&out, 0, sizeof out);
        out.attr_valid = 1;
        attr_from_stat(st, &out.attr);
        send_reply(in->unique, 0, &out, sizeof out);
        break;
      }
      case FUSE_READLINK: {
        if (faulted(in->unique)) break;
        char target[4096];
        ssize_t r = readlinkat(fs.fd_of(in->nodeid), "", target,
                               sizeof target - 1);
        if (r < 0)
          reply_err(in->unique, -errno);
        else
          send_reply(in->unique, 0, target, r);
        break;
      }
      case FUSE_MKDIR: {
        if (faulted(in->unique)) break;
        auto* m = (fuse_mkdir_in*)arg;
        const char* name = arg + sizeof *m;
        if (mkdirat(fs.fd_of(in->nodeid), name, m->mode) < 0) {
          reply_err(in->unique, -errno);
          break;
        }
        fuse_entry_out out;
        int e = make_entry(fs.fd_of(in->nodeid), name, &out);
        if (e)
          reply_err(in->unique, e);
        else
          send_reply(in->unique, 0, &out, sizeof out);
        break;
      }
      case FUSE_MKNOD: {
        if (faulted(in->unique)) break;
        auto* m = (fuse_mknod_in*)arg;
        const char* name = arg + sizeof *m;
        if (mknodat(fs.fd_of(in->nodeid), name, m->mode, m->rdev) < 0) {
          reply_err(in->unique, -errno);
          break;
        }
        fuse_entry_out out;
        int e = make_entry(fs.fd_of(in->nodeid), name, &out);
        if (e)
          reply_err(in->unique, e);
        else
          send_reply(in->unique, 0, &out, sizeof out);
        break;
      }
      case FUSE_SYMLINK: {
        if (faulted(in->unique)) break;
        const char* name = arg;
        const char* target = arg + strlen(name) + 1;
        if (symlinkat(target, fs.fd_of(in->nodeid), name) < 0) {
          reply_err(in->unique, -errno);
          break;
        }
        fuse_entry_out out;
        int e = make_entry(fs.fd_of(in->nodeid), name, &out);
        if (e)
          reply_err(in->unique, e);
        else
          send_reply(in->unique, 0, &out, sizeof out);
        break;
      }
      case FUSE_LINK: {
        if (faulted(in->unique)) break;
        auto* l = (fuse_link_in*)arg;
        const char* name = arg + sizeof *l;
        char p[64];
        snprintf(p, sizeof p, "/proc/self/fd/%d",
                 fs.fd_of(l->oldnodeid));
        if (linkat(AT_FDCWD, p, fs.fd_of(in->nodeid), name,
                   AT_SYMLINK_FOLLOW) < 0) {
          reply_err(in->unique, -errno);
          break;
        }
        fuse_entry_out out;
        int e = make_entry(fs.fd_of(in->nodeid), name, &out);
        if (e)
          reply_err(in->unique, e);
        else
          send_reply(in->unique, 0, &out, sizeof out);
        break;
      }
      case FUSE_UNLINK: {
        if (faulted(in->unique)) break;
        reply_err(in->unique,
                  unlinkat(fs.fd_of(in->nodeid), arg, 0) < 0 ? -errno : 0);
        break;
      }
      case FUSE_RMDIR: {
        if (faulted(in->unique)) break;
        reply_err(in->unique,
                  unlinkat(fs.fd_of(in->nodeid), arg, AT_REMOVEDIR) < 0
                      ? -errno
                      : 0);
        break;
      }
      case FUSE_RENAME:
      case FUSE_RENAME2: {
        if (faulted(in->unique)) break;
        uint64_t newdir;
        const char* oldname;
        if (in->opcode == FUSE_RENAME2) {
          auto* r = (fuse_rename2_in*)arg;
          newdir = r->newdir;
          oldname = arg + sizeof *r;
        } else {
          auto* r = (fuse_rename_in*)arg;
          newdir = r->newdir;
          oldname = arg + sizeof(fuse_rename_in);
        }
        const char* newname = oldname + strlen(oldname) + 1;
        reply_err(in->unique,
                  renameat(fs.fd_of(in->nodeid), oldname,
                           fs.fd_of(newdir), newname) < 0
                      ? -errno
                      : 0);
        break;
      }
      case FUSE_OPEN: {
        if (faulted(in->unique)) break;
        auto* o = (fuse_open_in*)arg;
        int f = reopen(fs.fd_of(in->nodeid),
                       o->flags & ~(O_NOFOLLOW | O_CREAT));
        if (f < 0) {
          reply_err(in->unique, -errno);
          break;
        }
        fuse_open_out out;
        memset(&out, 0, sizeof out);
        out.fh = f;
        out.open_flags = FOPEN_DIRECT_IO;  // every I/O hits the daemon
        send_reply(in->unique, 0, &out, sizeof out);
        break;
      }
      case FUSE_CREATE: {
        if (faulted(in->unique)) break;
        auto* c = (fuse_create_in*)arg;
        const char* name = arg + sizeof *c;
        int f = openat(fs.fd_of(in->nodeid), name,
                       (c->flags | O_CREAT) & ~O_NOFOLLOW, c->mode);
        if (f < 0) {
          reply_err(in->unique, -errno);
          break;
        }
        struct {
          fuse_entry_out e;
          fuse_open_out o;
        } out;
        int e = make_entry(fs.fd_of(in->nodeid), name, &out.e);
        if (e) {
          close(f);
          reply_err(in->unique, e);
          break;
        }
        memset(&out.o, 0, sizeof out.o);
        out.o.fh = f;
        out.o.open_flags = FOPEN_DIRECT_IO;
        send_reply(in->unique, 0, &out, sizeof out);
        break;
      }
      case FUSE_READ: {
        if (faulted(in->unique)) break;
        auto* r = (fuse_read_in*)arg;
        std::vector<char> data(r->size);
        ssize_t got = pread((int)r->fh, data.data(), r->size, r->offset);
        if (got < 0)
          reply_err(in->unique, -errno);
        else
          send_reply(in->unique, 0, data.data(), got);
        break;
      }
      case FUSE_WRITE: {
        if (faulted(in->unique)) break;
        auto* w = (fuse_write_in*)arg;
        const char* data = arg + sizeof *w;
        ssize_t put = pwrite((int)w->fh, data, w->size, w->offset);
        if (put < 0) {
          reply_err(in->unique, -errno);
          break;
        }
        fuse_write_out out;
        memset(&out, 0, sizeof out);
        out.size = (uint32_t)put;
        send_reply(in->unique, 0, &out, sizeof out);
        break;
      }
      case FUSE_FLUSH:
        send_reply(in->unique, 0, nullptr, 0);
        break;
      case FUSE_RELEASE: {
        auto* rl = (fuse_release_in*)arg;
        close((int)rl->fh);
        send_reply(in->unique, 0, nullptr, 0);
        break;
      }
      case FUSE_FSYNC:
      case FUSE_FSYNCDIR: {
        if (faulted(in->unique)) break;
        auto* fy = (fuse_fsync_in*)arg;
        int fd = (int)fy->fh;
        if (in->opcode == FUSE_FSYNCDIR) {
          auto it = fs.dirs.find(fy->fh);
          fd = it == fs.dirs.end() ? -1 : it->second->fd;
        }
        int r = (fy->fsync_flags & 1) ? fdatasync(fd) : fsync(fd);
        reply_err(in->unique, r < 0 ? -errno : 0);
        break;
      }
      case FUSE_OPENDIR: {
        if (faulted(in->unique)) break;
        int f = reopen(fs.fd_of(in->nodeid), O_RDONLY | O_DIRECTORY);
        if (f < 0) {
          reply_err(in->unique, -errno);
          break;
        }
        auto* snap = new DirSnapshot();
        snap->fd = f;
        fuse_open_out out;
        memset(&out, 0, sizeof out);
        out.fh = (uint64_t)(uintptr_t)snap;
        fs.dirs[out.fh] = snap;
        send_reply(in->unique, 0, &out, sizeof out);
        break;
      }
      case FUSE_READDIR: {
        if (faulted(in->unique)) break;
        auto* r = (fuse_read_in*)arg;
        auto it = fs.dirs.find(r->fh);
        if (it == fs.dirs.end()) {
          reply_err(in->unique, -EBADF);
          break;
        }
        DirSnapshot* snap = it->second;
        if (r->offset == 0 || !snap->loaded) {
          snap->ents.clear();
          DIR* d = fdopendir(dup(snap->fd));
          if (d) {
            rewinddir(d);
            while (struct dirent* de = readdir(d))
              snap->ents.push_back(
                  {de->d_name, de->d_ino, (uint32_t)de->d_type});
            closedir(d);
          }
          snap->loaded = true;
        }
        std::vector<char> out;
        size_t idx = (size_t)r->offset;
        while (idx < snap->ents.size()) {
          const auto& e = snap->ents[idx];
          size_t entlen = FUSE_NAME_OFFSET + e.name.size();
          size_t padded = FUSE_DIRENT_ALIGN(entlen);
          if (out.size() + padded > r->size) break;
          size_t base = out.size();
          out.resize(base + padded, 0);
          auto* de = (fuse_dirent*)(out.data() + base);
          de->ino = e.ino;
          de->off = idx + 1;  // cookie: next index
          de->namelen = (uint32_t)e.name.size();
          de->type = e.type;
          memcpy(de->name, e.name.data(), e.name.size());
          idx++;
        }
        send_reply(in->unique, 0, out.data(), out.size());
        break;
      }
      case FUSE_RELEASEDIR: {
        auto* rl = (fuse_release_in*)arg;
        auto it = fs.dirs.find(rl->fh);
        if (it != fs.dirs.end()) {
          close(it->second->fd);
          delete it->second;
          fs.dirs.erase(it);
        }
        send_reply(in->unique, 0, nullptr, 0);
        break;
      }
      case FUSE_STATFS: {
        if (faulted(in->unique)) break;
        struct statfs st;
        char p[64];
        snprintf(p, sizeof p, "/proc/self/fd/%d", fs.fd_of(in->nodeid));
        if (statfs(p, &st) < 0) {
          reply_err(in->unique, -errno);
          break;
        }
        fuse_statfs_out out;
        memset(&out, 0, sizeof out);
        out.st.blocks = st.f_blocks;
        out.st.bfree = st.f_bfree;
        out.st.bavail = st.f_bavail;
        out.st.files = st.f_files;
        out.st.ffree = st.f_ffree;
        out.st.bsize = st.f_bsize;
        out.st.namelen = st.f_namelen;
        out.st.frsize = st.f_frsize;
        send_reply(in->unique, 0, &out, sizeof out);
        break;
      }
      case FUSE_ACCESS: {
        if (faulted(in->unique)) break;
        auto* a = (fuse_access_in*)arg;
        char p[64];
        snprintf(p, sizeof p, "/proc/self/fd/%d", fs.fd_of(in->nodeid));
        reply_err(in->unique, access(p, a->mask) < 0 ? -errno : 0);
        break;
      }
      case FUSE_FALLOCATE: {
        if (faulted(in->unique)) break;
        auto* fa = (fuse_fallocate_in*)arg;
        reply_err(in->unique,
                  fallocate((int)fa->fh, fa->mode, fa->offset,
                            fa->length) < 0
                      ? -errno
                      : 0);
        break;
      }
      case FUSE_GETXATTR:
      case FUSE_SETXATTR:
      case FUSE_LISTXATTR:
      case FUSE_REMOVEXATTR:
      case FUSE_GETLK:
      case FUSE_SETLK:
      case FUSE_SETLKW:
      default:
        reply_err(in->unique, -ENOSYS);
        break;
    }
  }
  umount2(mnt, MNT_DETACH);
  return 0;
}
