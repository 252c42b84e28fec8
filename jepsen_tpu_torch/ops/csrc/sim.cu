// The list-append cluster simulator on the card: the counterpart of K4,
// the JAX package's jitted simulator (jepsen_tpu/fuzz/sim.py `_sim_math`,
// hash `_make_hi`), which computes every (mop, mop) and (mop, node, fault
// slot) combination of a cluster as dense tensors. The outputs need far
// fewer: a valid append's position counts only the valid appends of its
// key, a valid read's prefix length walks only those, and a delivery time
// moves only for a valid append at a node other than its sender, through
// the fault slots that hold a delivery rule. One block a cluster; every
// table in dynamic shared memory, laid out by `layout` below (fuzz/sim.py
// `smem_bytes` computes the same size).
//
// Phases, a barrier after each:
//   (0) warp 0 compacts the fault slots, in slot order, into the rules
//       that act on a txn (clock, kill, pause) and the delivery rules
//       (partition, kill, pause, corruption, packet); per work slot, the
//       coordinator and mop count; per mop, its hash's b-stage and key.
//   (1) per mop, the txn rules covering its coordinator (failed, pause,
//       clock), its kind, eff and validity; each valid append takes a
//       place in its key's bucket (a shared atomicAdd on the bucket's
//       count).
//   (2) every warp scans the 32 bucket counts itself (shuffles, no
//       barrier) and scatters its valid appends into the buckets: entry =
//       bucket start + place. An entry packs (eff, mop index, sender) into
//       one 64-bit word, so one compare orders two entries by (eff, mop
//       index), as the JAX package ranks them.
//   (3) per entry, its rank: the entries of its bucket below it; per
//       (entry, node other than the sender), the delivery cascade over the
//       compacted rules in slot order (each rule tests the time the rule
//       before it wrote; a packet rule hashes with the slot's original
//       index f and the mop's index m); the sender's own node gets eff.
//   (4) per valid read, its prefix length over its bucket's entries
//       against their delivery times at its coordinator; every output.
// Buckets are key & 31: for K <= 32 a bucket is one key's list; past 32
// the walks also compare keys. Which thread takes an entry's place in a
// bucket depends on the order the atomics land, but every later use of a
// bucket (a count of smaller entries, a minimum, a total) is an order-free
// function of its set of entries, so the outputs do not depend on it.
// Pads and the mops of failed txns enter no bucket and get -1.
//
// The hash hi(w, c, a, b) is a chain of four murmur3 finalizers: the
// first depends on w alone, the second on a, the third on b, the last on
// c. A mop's key, kind and jitter share its b-stage, a (mop, node) pair's
// packet tests theirs. The jitter hash is taken only where a clock fault
// sets an amplitude, the kind hash only for a mop the txn runs. Divisions
// by N, K, L and N - 1 are a multiply and a shift (`Div`).
//
// What bounds it on the H100 (chip_smoke.py `sim_bound`, counting the
// hash stages, rank and visibility pairs and cascade steps this run's
// data needs): at the default spec the bytes, ~2.4 KB a cluster of
// schedule in and outputs out over HBM bandwidth, about twice the time of
// the ~6,000 int32 operations a cluster. Neither is what the kernel
// meets. Each phase is a short chain of shared-memory loads, hash stages
// and branches, the first of them waiting on the schedule's and the
// seed's loads from device memory, and a block's five phases run one
// after another. At the fuzz loop's 256 clusters and the bench's 1,024
// (less than a wave) the time is that chain and the launch (a launch of
// one warp's short loop, closure_word's `floor_ms`, takes about half of
// the 256-cluster time); at 16,384 it is that chain over the blocks an
// SM holds at once (ptxas's register count allows 10 of 128 threads,
// against the 16 the SM's threads would). Threads a
// block (fuzz/sim.py `block_threads`, timed at 32, 64, 128 and 256 at
// each of the three batch sizes, chip_smoke.py `threads_ms`): 256 while
// the launch holds a couple of clusters an SM (the most threads shorten
// the chain: phase (3)'s ~140 items a cluster fit one pass), one a mop
// at the bench's batch, one a pair of mops past 16 clusters an SM (two
// blocks resident for each one of a mop a thread, fewer idle lanes).
// All arithmetic is int32 but the hash's (uint32); every % has a
// non-negative left operand and a positive modulus, so C's % is Python's.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_THREADS = 256;
constexpr int MAX_DEVICES = 64;
constexpr int BUCKETS = 32;
constexpr int32_t BIG = 1 << 28;
constexpr int KIND_APPEND = 0, KIND_READ = 1, KIND_PAD = 2;
constexpr int PARTITION = 1, CLOCK = 2, KILL = 3, PAUSE = 4, CORRUPT = 5,
              PACKET = 6;
// a mop's flag word: its kind in the low two bits, then these
constexpr int VALID_APPEND = 4, VALID_READ = 8;
// a slot's flag word
constexpr int FAILED = 1, PAUSED = 2;

__device__ __forceinline__ uint32_t fmix(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  return h ^ (h >> 16);
}

// hi(w, c, a, b) = hash_c(hash_b(hash_a(hash_w(w), a), b), c), in
// [0, 2^31)
__device__ __forceinline__ uint32_t hash_w(uint32_t w) {
  return fmix(w ^ 0x9E3779B9u);
}
__device__ __forceinline__ uint32_t hash_a(uint32_t h, uint32_t a) {
  return fmix(h ^ (a * 0x85EBCA6Bu));
}
__device__ __forceinline__ uint32_t hash_b(uint32_t h, uint32_t b) {
  return fmix(h ^ (b * 0xC2B2AE35u));
}
__device__ __forceinline__ uint32_t hash_c(uint32_t h, uint32_t c) {
  return fmix(h ^ (c * 0x27D4EB2Fu)) & 0x7FFFFFFFu;
}

// n / d for 0 <= n < 2^31 as a multiply and a shift, d fixed for the
// launch (Granlund and Montgomery's round-up method: m = ceil(2^(31 + l)
// / d) with 2^l >= d is exact for every 31-bit n), in place of the ~20
// instructions of a division by a value the compiler does not know
struct Div {
  uint32_t m;
  int shift;
};

inline Div div_by(uint32_t d) {
  int l = 0;
  while ((1ull << l) < d) ++l;
  return {(uint32_t)(((1ull << (31 + l)) + d - 1) / d), 31 + l};
}

__device__ __forceinline__ int quot(uint32_t n, Div v) {
  return (int)(((uint64_t)n * v.m) >> v.shift);
}

struct Spec {
  int N, K, T, L, F, St, audit_t0;
  Div byN, byK, byL, byR;  // R = N - 1 (1 when N == 1)
};

// byte offsets of the block's tables in dynamic shared memory:
//   rule_a, rule_b [F] int4   delivery rules: (family, mask, t0*L, t1*L),
//                             (p0, p1*L, slot f, t0*L - p1*L)
//   slot_a, slot_b [F] int4   slot rules: (family, mask, t0, t1), (p0, p1)
//   pk    [M] uint64          entries: eff << 32 | mop << 4 | sender
//   hdr   [4]                 slot rules, delivery rules, entries
//   cnt, start [BUCKETS]      bucket sizes and starts
//   slot  [3 * St]            coordinator, mop count, failed
//   mop   [5 * M]             key, eff, b-stage hash, flags, place / entry
//   ent   [2 * M]             entry key, entry rank
//   deliv [M * N]             entry delivery time at each node
struct Layout {
  int rule_a, rule_b, slot_a, slot_b, pk, hdr, cnt, start, slot, mop, ent,
      deliv, bytes;
};

__host__ __device__ inline Layout layout(const Spec& sp) {
  const int M = sp.St * sp.L;
  Layout o;
  int at = 0;
  o.rule_a = at, at += 16 * sp.F;
  o.rule_b = at, at += 16 * sp.F;
  o.slot_a = at, at += 16 * sp.F;
  o.slot_b = at, at += 16 * sp.F;
  o.pk = at, at += 8 * M;
  o.hdr = at, at += 4 * 4;
  o.cnt = at, at += 4 * BUCKETS;
  o.start = at, at += 4 * BUCKETS;
  o.slot = at, at += 4 * 3 * sp.St;
  o.mop = at, at += 4 * 5 * M;
  o.ent = at, at += 4 * 2 * M;
  o.deliv = at, at += 4 * M * sp.N;
  o.bytes = at;
  return o;
}

__global__ void __launch_bounds__(MAX_THREADS)
sim_kernel(const int32_t* __restrict__ scheds,
           const int32_t* __restrict__ wseeds, Spec sp,
           int32_t* __restrict__ o_coord, uint8_t* __restrict__ o_failed,
           int32_t* __restrict__ o_kind, int32_t* __restrict__ o_key,
           int32_t* __restrict__ o_eff, int32_t* __restrict__ o_pos,
           int32_t* __restrict__ o_rlen) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int N = sp.N, K = sp.K, T = sp.T, L = sp.L, F = sp.F, St = sp.St;
  const int M = St * L;
  const Layout lo = layout(sp);
  int4* rule_a = reinterpret_cast<int4*>(smem + lo.rule_a);
  int4* rule_b = reinterpret_cast<int4*>(smem + lo.rule_b);
  int4* slot_a = reinterpret_cast<int4*>(smem + lo.slot_a);
  int4* slot_b = reinterpret_cast<int4*>(smem + lo.slot_b);
  uint64_t* pk = reinterpret_cast<uint64_t*>(smem + lo.pk);
  int* hdr = reinterpret_cast<int*>(smem + lo.hdr);
  int* cnt = reinterpret_cast<int*>(smem + lo.cnt);
  int* start = reinterpret_cast<int*>(smem + lo.start);
  int* s_coord = reinterpret_cast<int*>(smem + lo.slot);
  int* s_nmops = s_coord + St;
  int* s_flags = s_nmops + St;
  int* m_key = reinterpret_cast<int*>(smem + lo.mop);
  int* m_eff = m_key + M;
  uint32_t* m_hb = reinterpret_cast<uint32_t*>(m_eff + M);
  int* m_flag = reinterpret_cast<int*>(m_hb + M);
  int* m_ent = m_flag + M;
  int* e_key = reinterpret_cast<int*>(smem + lo.ent);
  int* e_pos = e_key + M;
  int* deliv = reinterpret_cast<int*>(smem + lo.deliv);

  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const long long c = blockIdx.x;
  const uint32_t w = (uint32_t)wseeds[c];
  const bool exact = K <= BUCKETS;

  // (0) the compacted rules; per work slot, coordinator and mop count;
  // per mop, b-stage hash and key. Slots go to the block's last threads,
  // mops to its first.
  if (tid < BUCKETS) cnt[tid] = 0;
  if (warp == 0) {
    int n_slot = 0, n_rule = 0;
    for (int f0 = 0; f0 < F; f0 += 32) {
      const int f = f0 + lane;
      int q[6] = {0, 0, 0, 0, 0, 0};
      if (f < F)
        for (int i = 0; i < 6; ++i) q[i] = scheds[(c * F + f) * 6 + i];
      const int fam = q[0];
      const bool on_slot = fam == CLOCK || fam == KILL || fam == PAUSE;
      const bool on_delivery = fam == PARTITION || fam == KILL ||
                               fam == PAUSE || fam == CORRUPT ||
                               fam == PACKET;
      const unsigned bs = __ballot_sync(FULL, on_slot);
      const unsigned bd = __ballot_sync(FULL, on_delivery);
      const unsigned below = (1u << lane) - 1u;
      if (on_slot) {
        const int at = n_slot + __popc(bs & below);
        slot_a[at] = make_int4(fam, q[1], q[2], q[3]);
        slot_b[at] = make_int4(q[4], q[5], 0, 0);
      }
      if (on_delivery) {
        const int at = n_rule + __popc(bd & below);
        rule_a[at] = make_int4(fam, q[1], q[2] * L, q[3] * L);
        rule_b[at] = make_int4(q[4], q[5] * L, f, q[2] * L - q[5] * L);
      }
      n_slot += __popc(bs);
      n_rule += __popc(bd);
    }
    if (lane == 0) {
      hdr[0] = n_slot;
      hdr[1] = n_rule;
    }
  }
  for (int s = nt - 1 - tid; s < St; s += nt) {
    int coord = 0, nmops = L;
    if (s < T) {
      const uint32_t hb = hash_b(hash_a(hash_w(w), s), 0);
      const uint32_t h11 = hash_c(hb, 11), h12 = hash_c(hb, 12);
      coord = h11 - quot(h11, sp.byN) * N;
      nmops = 1 + h12 - quot(h12, sp.byL) * L;
    }
    s_coord[s] = coord;
    s_nmops[s] = nmops;
    s_flags[s] = 0;
  }
  for (int m = tid; m < M; m += nt) {
    const int s = quot(m, sp.byL), j = m - s * L;
    if (s < T) {
      const uint32_t hb = hash_b(hash_a(hash_w(w), s), j);
      const uint32_t h14 = hash_c(hb, 14);
      m_key[m] = h14 - quot(h14, sp.byK) * K;
      m_hb[m] = hb;
    } else {
      const int akey = (s - T) * L + j;
      m_key[m] = min(akey, K - 1);
      m_flag[m] = akey < K ? KIND_READ : KIND_PAD;
      m_eff[m] = (sp.audit_t0 + s - T) * L + j;
    }
  }
  __syncthreads();

  // (1) per mop, the faults covering its txn's coordinator, its kind, eff
  // and validity; valid appends take bucket places
  for (int m = tid; m < M; m += nt) {
    const int s = quot(m, sp.byL), j = m - s * L;
    int kind, flags = 0;
    if (s < T) {
      const int coord = s_coord[s], n_slot = hdr[0];
      int pend = 0, psplit = 0, coff = 0, camp = 0;
      for (int r = 0; r < n_slot; ++r) {
        const int4 a = slot_a[r];
        if (!(((a.y >> coord) & 1) && a.z <= s && s < a.w)) continue;
        const int4 b = slot_b[r];
        if (a.x == KILL) flags |= FAILED;
        if (a.x == PAUSE) {
          flags |= PAUSED;
          pend = max(pend, a.w);
          psplit = max(psplit, b.x);
        }
        if (a.x == CLOCK) {
          coff += b.x;
          camp = max(camp, b.y);
        }
      }
      if (j == 0) s_flags[s] = flags & FAILED;
      const uint32_t hb = m_hb[m];
      kind = j >= s_nmops[s]           ? KIND_PAD
             : (hash_c(hb, 13) & 1u) ? KIND_READ
                                       : KIND_APPEND;
      const bool defer = (flags & PAUSED) && j >= psplit;
      const int basew = defer ? pend * L + j : m;
      const int jit =
          camp ? (int)(hash_c(hb, 16) % (uint32_t)(2 * camp + 1)) - camp : 0;
      m_eff[m] = max(basew + coff + jit, 0);
    } else {
      kind = m_flag[m];
    }
    const bool failed = flags & FAILED;
    int flag = kind;
    if (!failed && kind == KIND_APPEND) {
      flag |= VALID_APPEND;
      m_ent[m] = atomicAdd(&cnt[m_key[m] & (BUCKETS - 1)], 1);
    }
    if (!failed && kind == KIND_READ) flag |= VALID_READ;
    m_flag[m] = flag;
  }
  __syncthreads();

  // (2) bucket starts (each warp scans the counts itself) and the entries
  {
    const int v = cnt[lane];
    int incl = v;
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_up_sync(FULL, incl, d);
      if (lane >= d) incl += u;
    }
    const int excl = incl - v;
    if (warp == 0) {
      start[lane] = excl;
      if (lane == 31) hdr[2] = incl;
    }
    for (int base = warp * 32; base < M; base += nt) {
      const int m = base + lane;
      const bool app = m < M && (m_flag[m] & VALID_APPEND);
      const int key = app ? m_key[m] : 0;
      const int at = __shfl_sync(FULL, excl, key & (BUCKETS - 1));
      if (app) {
        const int e = at + m_ent[m];
        pk[e] = ((uint64_t)(uint32_t)m_eff[m] << 32) | ((uint32_t)m << 4) |
                (uint32_t)s_coord[quot(m, sp.byL)];
        e_key[e] = key;
        m_ent[m] = e;
      }
    }
  }
  __syncthreads();

  // (3) per (entry, other node), the delivery cascade; per entry, its
  // rank and its own node's delivery time
  {
    const int A = hdr[2], R = N - 1, n_rule = hdr[1];
    const int pairs = A * R;
    for (int i = tid; i < pairs + A; i += nt) {
      if (i < pairs) {
        const int e = quot(i, sp.byR), r = i - e * R;
        const uint64_t p = pk[e];
        const int send = (int)(p & 15), m = (int)((uint32_t)p >> 4);
        const int n = r + (r >= send);
        int d = (int)(p >> 32);
        uint32_t hb = 0;
        bool hashed = false;
        for (int q = 0; q < n_rule; ++q) {
          const int4 a = rule_a[q];
          const int sb = (a.y >> send) & 1, rb = (a.y >> n) & 1;
          if (!(sb | rb)) continue;
          const bool in = a.z <= d && d < a.w;
          if (a.x == PARTITION) {
            if (sb != rb && in) d = a.w;
          } else if (a.x == PACKET) {
            if (in) {
              const int4 b = rule_b[q];
              if (!hashed) {
                hb = hash_b(hash_a(hash_w(w), m), n);
                hashed = true;
              }
              const uint32_t hd = hash_c(hb, 170 + b.z);
              if ((int)(hd & 15u) < b.x)
                d += 1 + (int)((hd >> 4) % (uint32_t)max(b.y, 1));
            }
          } else if (a.x == CORRUPT) {
            const int4 b = rule_b[q];
            if (rb && e_key[e] == b.x && b.w <= d && d < a.z) d = a.z + 1;
          } else if (rb && in) {  // kill, pause
            d = a.w;
          }
        }
        deliv[e * N + n] = d;
      } else {
        const int e = i - pairs;
        const uint64_t p = pk[e];
        const int key = e_key[e], b = key & (BUCKETS - 1);
        const int k0 = start[b], k1 = k0 + cnt[b];
        int pos = 0;
        if (exact) {
#pragma unroll 4
          for (int k = k0; k < k1; ++k) pos += pk[k] < p;
        } else {
#pragma unroll 4
          for (int k = k0; k < k1; ++k) pos += e_key[k] == key && pk[k] < p;
        }
        e_pos[e] = pos;
        deliv[e * N + (int)(p & 15)] = (int)(p >> 32);
      }
    }
  }
  __syncthreads();

  // (4) per valid read, its prefix length; every output
  const long long base = c * M;
  for (int m = tid; m < M; m += nt) {
    const int flag = m_flag[m], key = m_key[m], eff = m_eff[m];
    int rlen = -1;
    if (flag & VALID_READ) {
      const int at = s_coord[quot(m, sp.byL)], b = key & (BUCKETS - 1);
      const int k0 = start[b], k1 = k0 + cnt[b];
      int minpos = BIG, total = 0;
#pragma unroll 4
      for (int k = k0; k < k1; ++k) {
        const int d = deliv[k * N + at], pos = e_pos[k];
        const int km = (int)((uint32_t)pk[k] >> 4);
        if (!exact && e_key[k] != key) continue;
        ++total;
        if (!(d < eff || (d == eff && km < m))) minpos = min(minpos, pos);
      }
      rlen = min(minpos, total);
    }
    o_kind[base + m] = flag & 3;
    o_key[base + m] = key;
    o_eff[base + m] = eff;
    o_pos[base + m] = (flag & VALID_APPEND) ? e_pos[m_ent[m]] : -1;
    o_rlen[base + m] = rlen;
  }
  for (int s = tid; s < St; s += nt) {
    o_coord[c * St + s] = s_coord[s];
    o_failed[c * St + s] = (uint8_t)(s_flags[s] & FAILED);
  }
}

// shared bytes each device's kernel has been opted in to, by this library
int opted[MAX_DEVICES];

}  // namespace

extern "C" {

// scheds: [S, F, 6] int32 canonical schedules; wseeds: [S] int32
// (non-negative); outputs: coord [S, St] int32, failed [S, St] bool (one
// byte), kind/key/eff/pos/rlen [S, St, L] int32. smem: the block's dynamic
// shared bytes, which must equal `layout`'s; threads: a multiple of 32 up
// to MAX_THREADS (else cudaErrorInvalidValue). The kernel is opted in to
// its shared bytes once per device and size, at the first launch that
// needs more than it has.
int sim_launch(const void* scheds, const void* wseeds, int S, int N, int K,
               int T, int L, int F, int St, int audit_t0, void* coord,
               void* failed, void* kind, void* key, void* eff, void* pos,
               void* rlen, int smem, int threads, void* stream) {
  if (S <= 0) return 0;
  const Spec sp{N, K, T, L, F, St, audit_t0, div_by(N), div_by(K), div_by(L),
                div_by(N > 1 ? N - 1 : 1)};
  if (smem != layout(sp).bytes || threads < 32 || threads > MAX_THREADS ||
      threads % 32 != 0 || N < 1 || N > 16)
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES || smem > opted[dev]) {
    err = cudaFuncSetAttribute(
        sim_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < MAX_DEVICES) opted[dev] = smem;
  }
  sim_kernel<<<S, threads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)scheds, (const int32_t*)wseeds, sp, (int32_t*)coord,
      (uint8_t*)failed, (int32_t*)kind, (int32_t*)key, (int32_t*)eff,
      (int32_t*)pos, (int32_t*)rlen);
  return (int)cudaGetLastError();
}

}  // extern "C"
