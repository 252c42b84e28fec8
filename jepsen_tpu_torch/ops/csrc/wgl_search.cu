// WGL linearizability search for lanes of any length (a batch pads to a
// power of two) and a vector model state, one warp per lane, the whole
// depth-first search inside one launch.
//
// Replaces the JAX package's K2 engine, jepsen_tpu/ops/wgl_tpu.py::
// _search_one (an XLA while-loop vmapped over lanes), and computes exactly
// what it computes — the same verdict, step count and depth for every
// lane — for all five kernel models of models/jit.py:
//   - scalar models (cas-register, register, mutex): the state is one
//     int32, saved on the undo stack at each lift and restored on a pop;
//   - unordered-queue: a count vector of n_state words (one counter per
//     distinct value of the lane), left out of the memo key (the bitset
//     determines it), undone by the inverse step;
//   - fifo-queue: a ring of n_state-2 value ids with head and tail
//     cursors; the memo key holds its canonical form (the live window at
//     offset 0, dead slots zero, then count and 0), the offsets do not
//     enter it; undone by the inverse step (cursor decrements).
// The memo: 2^cache_bits slots per lane, each an exact key (the lane's
// ceil(n_pad/32) bitset words, then the canonical state when the model
// keys on it); a lookup probes N_PROBES consecutive slots from the key's
// hash, finds the key iff some used probe holds it whole, and a lift
// inserts it at the first unused probe, else at the last. The hash is
// wgl_tpu's _mix_hash: the incremental Zobrist bitset hash (from the FNV
// basis), folded word by word with the canonical state as (h ^ s) * FNV
// prime, then an avalanche, all in uint32. Verdicts: a lane with no
// completed op is VALID before any step, one still running at its step
// budget is UNKNOWN.
//
// What bounds it on an H100: a search step is a chain of dependent reads
// (node -> its entry -> the entry's facts -> the hash -> the memo probe ->
// the list neighbours) by one warp, so the kernel is bound by that chain's
// latency, far above both the bytes and the operations a step needs. The
// design shortens each link:
//
// Where the tables live. A lane's tables (Table below, ranked by the reads
// a step makes of them) go into the lane's slice of the block's dynamic
// shared memory in rank order while the block's budget lasts (the device's
// opt-in limit, 232,448 bytes on the H100); a table that does not fit stays
// in the lane's slice of one scratch tensor in device memory, and the next
// is tried. ops/wgl_search.py::_smem_plan and _layout compute that plan
// and pass it whole (`Plan`); the launch checks its offsets' bounds and
// alignment and instantiates the kernel for its table widths. Every table
// is read through one generic pointer, so the same kernel reads each table
// from where the plan put it. By tier (cas-register, cache_bits 13): up to
// n_pad 4096 every table is in shared memory (so is every fifo table at
// n_pad 2048 with n_state 1024: 65,840 bytes a lane); at n_pad 8192 all
// but the stack's states (the models without v2 keep all); at n_pad 16384
// the bitset, fingerprints, node map, nxt and facts; at n_pad 32768 the
// bitset, fingerprints and node map. At cache_bits >= 17 the fingerprints
// alone are 256 KB or more and stay in device memory. The bitset is
// always in shared memory. v1 and v2 that do not fit are read in place
// from the packed input. The Zobrist table is not stored at all: its word
// for entry e is splitmix64(e + 1), computed in registers while the
// entry's facts load.
//   - The memo's fingerprints are uint16, (hh >> 16) | 1 of the key a slot
//     holds (hh its hash; 0 when unused). Equal keys have equal hashes, so
//     a differing fingerprint cannot hold the key, and a matching one is
//     only a cue to compare the row: the found/insert decisions are exact
//     whatever the fingerprint's width. Threads 0-7 read the 8 probes'
//     fingerprints at once; two ballots give the used and the matching
//     probes.
//   - The memo's key rows (2^cache_bits x key words) are always in device
//     memory and are never zeroed: a row is read only where its slot's
//     fingerprint matches the new key's, and only as far as the key it
//     last received was written (below).
//   - The undo stack holds each lift's call node (and, for the scalar
//     models, the state before it). Its top — call node, entry, facts,
//     v1, Zobrist word, state — is kept in registers, so a pop reads no
//     stack; the pop refills the registers from the new top while the
//     search goes on.
//   - A call step issues every read that needs only the node and its
//     entry at once (facts, v1, nxt and prv of the node, the entry's
//     bitset word) and computes the Zobrist word while they load; a lift
//     then reads the return node's list words before it hashes, and
//     applies both unlinks from those values exactly as the sequential
//     writes would (write B sees write A); a pop the same for its
//     relinks. The list head nxt[0] is tracked in a register. The key
//     words a thread writes or compares are loaded CHUNK at a time.
//
// Fifo keys store only what can differ. Every key is canonical: the
// ring's dead slots are zero and the last word is 0 in every key, so two
// keys with equal bitset words and equal count words are equal iff their
// first `count` ring words are equal. A lift therefore writes only the
// bitset words, the live window and the count word of its row; a probe
// compares the count word, the bitset words and the first `count` ring
// words of the new key. A row's words past the window of the key it last
// received are stale and never read, so the memo's decisions, and the
// step counts, are those of whole-row keys.
//
// The fifo's FNV fold is serial over the live window (the hash cannot be
// split); it reads the ring from shared memory, unrolled so the loads run
// ahead of the multiply chain. The dead slots fold as one multiply by
// p^(ring - count), kept in a register and moved by p or p^-1 as the count
// changes (p is odd, so p^-1 mod 2^32 exists and the product is exact).
//
// The search's scalars (node, depth, hash, cursors, ...) are kept by every
// thread alike; every thread issues the same stores of the same values
// (idempotent within a step), a __syncwarp() ends each step, and the one
// read-modify-write that is not idempotent (the unordered queue's counter)
// reads before a __syncwarp() and writes after it.
//
// One lane a block, one warp. The fingerprints alone take 16 KB of shared
// memory a lane at the default 8192 slots, so an SM's shared memory, not
// the 32 blocks it may hold, sets how many lanes it runs at once, and
// packing lanes into blocks cannot add any (on the H100, 4096 lanes of
// n_pad 64 ran no faster at 2 to 8 lanes a block than at 1).

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int32_t RUNNING = 0, VALID = 1, INVALID = 2, UNKNOWN = 3;
constexpr int32_t NIL32 = 1 << 30;
constexpr int N_PROBES = 8;
constexpr int WARP = 32;
constexpr int CHUNK = 8;  // key words a thread loads at once
constexpr uint32_t FULL = 0xFFFFFFFFu;
constexpr uint32_t FNV_BASIS = 2166136261u;
constexpr uint32_t FNV_PRIME = 16777619u;
constexpr uint32_t FNV_PRIME_INV = 0x359C449Bu;  // FNV_PRIME^-1 mod 2^32

// model ids, as ops/wgl_search.py's MODEL_IDS
constexpr int CAS_REGISTER = 0, REGISTER = 1, MUTEX = 2, UNORDERED_QUEUE = 3,
              FIFO_QUEUE = 4;

// A lane's tables in rank order (ops/wgl_search.py's TABLES).
enum Table {
  LIN, FP, STATE, NMAP, NXT, FACT, V1, PRV, V2, STACK, STACK_S, N_TABLES
};

// Where a launch's tables live, as ops/wgl_search.py::_plan_words gives it:
// one int64 each, in this order.
struct Plan {
  long long smem;           // bit k: table k in the lane's shared memory
  long long off[N_TABLES];  // its byte offset there, or in the scratch (-1:
                            // absent, or v1/v2 read from the packed input)
  long long lane_bytes;     // shared bytes of one lane
  long long keys;           // byte offset of the key rows in the scratch
  long long lane_words;     // one lane's scratch in int32 words
  long long ent_bytes;      // a node map word: 2 or 4
  long long node_bytes;     // a node id (nxt, prv, the stack): 2 or 4
};

// Whether `p` can be launched: every table the model reads is placed, at
// a 16-byte aligned offset inside the lane's shared block or before the
// key rows, which fit the lane's scratch; the widths hold every entry and
// node id.
inline bool plan_ok(const Plan& p, int model, int n_pad, int m_pad,
                    int key_words, int cache_bits) {
  const bool scalar = model <= MUTEX;
  if (p.smem < 0 || p.smem >> N_TABLES || p.lane_bytes <= 0 ||
      p.lane_bytes % 16 || p.keys < 0 || p.keys % 16 ||
      p.keys + 4 * ((long long)key_words << cache_bits) > 4 * p.lane_words)
    return false;
  for (int k = 0; k < N_TABLES; ++k) {
    const long long o = p.off[k];
    const bool needed = k != V1 && k != V2 && (k != STATE || !scalar) &&
                        (k != STACK_S || scalar);
    if ((p.smem >> k) & 1) {
      if (o < 0 || o % 16 || o >= p.lane_bytes) return false;
    } else if (o >= 0) {
      if (k == V1 || k == V2 || o % 16 || o >= p.keys) return false;
    } else if (needed) {
      return false;
    }
  }
  return (p.ent_bytes == 4 || (p.ent_bytes == 2 && n_pad <= 32768)) &&
         (p.node_bytes == 4 || (p.node_bytes == 2 && m_pad <= 65536)) &&
         !(p.ent_bytes == 4 && p.node_bytes == 2);
}

struct Params {
  const int32_t* packed;  // (lanes, rows), `_pack` layout
  const int32_t* msteps;  // (lanes,) step budgets
  int32_t* small;         // (3, lanes): verdict, steps, depth
  unsigned char* scratch; // (lanes, lane_words) per-lane device tables
  Plan plan;
  int lanes, n_pad, m_pad, rows, n_state, cache_bits, nw, init_state;
};

__device__ __forceinline__ uint32_t avalanche(uint32_t h) {
  h = (h ^ (h >> 15)) * 0x85EBCA6Bu;
  return h ^ (h >> 13);
}

// The Zobrist word of entry e (ops/wgl_search.py::_zobrist_table).
__device__ __forceinline__ uint32_t zobrist(int e) {
  uint64_t x = (uint64_t)(e + 1) * 0x9E3779B97F4A7C15ull;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
  return (uint32_t)(x ^ (x >> 31));
}

// FNV_PRIME^k mod 2^32.
__device__ __forceinline__ uint32_t prime_pow(int k) {
  uint32_t r = 1u, b = FNV_PRIME;
  while (k > 0) {
    if (k & 1) r *= b;
    b *= b;
    k >>= 1;
  }
  return r;
}

// One instantiation per model and table width, so a step carries no branch
// on them: NodeT holds node ids (nxt, prv, the stack), EntT the node map
// (entry << 1 | is_call).
template <int MODEL, typename NodeT, typename EntT>
__global__ void __launch_bounds__(WARP) wgl_search_kernel(Params p) {
  constexpr bool SCALAR = MODEL <= MUTEX;
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = threadIdx.x;
  const int lane = blockIdx.x;
  const int n = p.n_pad, m = p.m_pad, S = p.n_state, nw = p.nw;
  const int kw = nw + (SCALAR ? 1 : MODEL == FIFO_QUEUE ? S : 0);
  const int slots = 1 << p.cache_bits;
  const uint32_t mask = (uint32_t)slots - 1;
  const int wr = S - 2;  // fifo: ring slots (head and tail follow)

  const int32_t* in = p.packed + (size_t)lane * p.rows;
  unsigned char* sb = smem;
  unsigned char* gb = p.scratch + (size_t)lane * p.plan.lane_words * 4;
  auto at = [&](int k) -> unsigned char* {
    return ((p.plan.smem >> k) & 1u ? sb : gb) + p.plan.off[k];
  };
  uint32_t* lin = reinterpret_cast<uint32_t*>(at(LIN));
  uint16_t* fp = reinterpret_cast<uint16_t*>(at(FP));
  int32_t* st = reinterpret_cast<int32_t*>(at(STATE));
  EntT* nmap = reinterpret_cast<EntT*>(at(NMAP));
  NodeT* nxt = reinterpret_cast<NodeT*>(at(NXT));
  NodeT* prv = reinterpret_cast<NodeT*>(at(PRV));
  int32_t* facts = reinterpret_cast<int32_t*>(at(FACT));
  const bool v1_smem = (p.plan.smem >> V1) & 1u;
  const bool v2_smem = (p.plan.smem >> V2) & 1u;
  int32_t* v1s = v1_smem ? reinterpret_cast<int32_t*>(at(V1)) : nullptr;
  int32_t* v2s = v2_smem ? reinterpret_cast<int32_t*>(at(V2)) : nullptr;
  const int32_t* v1_of = v1_smem ? v1s : in + n;
  const int32_t* v2_of = v2_smem ? v2s : in + 2 * n;
  NodeT* stack = reinterpret_cast<NodeT*>(at(STACK));
  int32_t* stack_s = reinterpret_cast<int32_t*>(at(STACK_S));
  uint32_t* keys = reinterpret_cast<uint32_t*>(gb + p.plan.keys);

  const int32_t* nodes = in + 6 * n;  // node_entry, node_is_call, nxt0, prv0
  const int32_t ncomp = nodes[4 * m];
  const int32_t max_steps = p.msteps[lane];
  int32_t verdict = ncomp == 0 ? VALID : RUNNING;
  int32_t steps = 0, depth = 0;

  if (verdict == RUNNING && steps < max_steps) {
    // decode the lane (columns f, v1, v2, crashed, call, ret; then
    // node_entry, node_is_call, nxt0, prv0) into its tables, the loads of
    // CHUNK rows a thread issued before their stores
    for (int i0 = t; i0 < n; i0 += CHUNK * WARP) {
      int32_t a[CHUNK], b[CHUNK], c[CHUNK], d[CHUNK], g[CHUNK];
#pragma unroll
      for (int j = 0; j < CHUNK; ++j) {
        const int i = i0 + j * WARP;
        if (i < n) {
          a[j] = in[i];
          b[j] = in[3 * n + i];
          c[j] = in[5 * n + i];
          if (v1_smem) d[j] = in[n + i];
          if (MODEL == CAS_REGISTER && v2_smem) g[j] = in[2 * n + i];
        }
      }
#pragma unroll
      for (int j = 0; j < CHUNK; ++j) {
        const int i = i0 + j * WARP;
        if (i < n) {
          facts[i] = a[j] | ((b[j] != 0) << 2) | (c[j] << 3);
          if (v1_smem) v1s[i] = d[j];
          if (MODEL == CAS_REGISTER && v2_smem) v2s[i] = g[j];
        }
      }
    }
    for (int i0 = t; i0 < m; i0 += CHUNK * WARP) {
      int32_t a[CHUNK], b[CHUNK], c[CHUNK], d[CHUNK];
#pragma unroll
      for (int j = 0; j < CHUNK; ++j) {
        const int i = i0 + j * WARP;
        if (i < m) {
          a[j] = nodes[i];
          b[j] = nodes[m + i];
          c[j] = nodes[2 * m + i];
          d[j] = nodes[3 * m + i];
        }
      }
#pragma unroll
      for (int j = 0; j < CHUNK; ++j) {
        const int i = i0 + j * WARP;
        if (i < m) {
          nmap[i] = (EntT)((a[j] << 1) | (b[j] != 0));
          nxt[i] = (NodeT)c[j];
          prv[i] = (NodeT)d[j];
        }
      }
    }
    // the memo starts empty: only the fingerprints are cleared
    for (int i = t; i < slots; i += WARP) fp[i] = 0;
    for (int i = t; i < nw; i += WARP) lin[i] = 0u;
    if (!SCALAR)
      for (int i = t; i < S; i += WARP) st[i] = 0;
    __syncwarp();
  }

  int32_t node = nodes[2 * m];  // nxt0[0]
  int32_t first = node;         // nxt[0], as the list changes
  int32_t state = p.init_state; // scalar models
  int32_t head = 0, tail = 0;   // fifo cursors
  // fifo: FNV_PRIME^(ring slots - count), the dead slots' fold
  uint32_t dead_pow = MODEL == FIFO_QUEUE ? prime_pow(wr) : 1u;
  uint32_t h = FNV_BASIS;
  int32_t completed = 0;
  // the undo stack's top (valid while depth > 0)
  int32_t top_node = 0, top_e = 0, top_fact = 0, top_v1 = 0, top_s = 0;
  uint32_t top_z = 0u;

  while (verdict == RUNNING && steps < max_steps) {
    const int en = nmap[node];
    const int e = en >> 1;
    const bool is_call = node != 0 && (en & 1);

    if (is_call) {
      // every read that needs only the node and its entry, issued at once
      const int32_t fact = facts[e];
      const int32_t v1 = v1_of[e];
      const int32_t qa = nxt[node];  // the next node, also write A's
      const int32_t pa = prv[node];
      const int word = e >> 5;
      const uint32_t lw = lin[word];
      const uint32_t z = zobrist(e);  // while those loads are in flight
      const int f = fact & 3;
      bool ok;
      int32_t new_state = state;  // scalar models
      int slot = 0;               // unordered: the value's counter
      int32_t count_now = 0;      // ... and its count
      bool enq = false;           // fifo: this lift enqueues
      if (MODEL == CAS_REGISTER) {
        const bool match = state == v1;
        ok = (f == 0 && (v1 == NIL32 || match)) || f == 1 || (f == 2 && match);
        new_state = f == 1 ? v1 : state;
        if (f == 2 && match) new_state = v2_of[e];
      } else if (MODEL == REGISTER) {
        ok = f == 1 || (f == 0 && (v1 == NIL32 || state == v1));
        new_state = f == 1 ? v1 : state;
      } else if (MODEL == MUTEX) {
        ok = (f == 0 && state == 0) || (f == 1 && state == 1);
        new_state = ok ? (f == 0 ? 1 : 0) : state;
      } else if (MODEL == UNORDERED_QUEUE) {
        slot = v1 < 0 ? 0 : (v1 > S - 1 ? S - 1 : v1);
        count_now = st[slot];
        ok = f == 0 || (f == 1 && count_now > 0);
      } else {  // FIFO_QUEUE
        const int front = head < 0 ? 0 : (head > wr - 1 ? wr - 1 : head);
        enq = f == 0 && tail < wr;
        ok = enq || (f == 1 && head < tail && st[front] == v1);
      }

      bool lifted = false;
      if (ok) {
        // the return node's list words this lift rewrites, read before
        // the hash
        const int rn = fact >> 3;
        const int32_t prn = prv[rn], nrn = nxt[rn];
        const uint32_t bit = 1u << (e & 31);
        const uint32_t new_h = h ^ z;
        // the fifo state after this step: window [nh, nt)
        const int nh = head + (enq ? 0 : 1);
        const int nt = tail + (enq ? 1 : 0);
        const int cnt = nt - nh;
        const uint32_t new_pow =
            MODEL == FIFO_QUEUE ? dead_pow * (enq ? FNV_PRIME_INV : FNV_PRIME)
                                : 1u;
        uint32_t hh = new_h;
        if (SCALAR) {
          hh = (hh ^ (uint32_t)new_state) * FNV_PRIME;
        } else if (MODEL == FIFO_QUEUE) {
#pragma unroll 8
          for (int j = nh; j < tail; ++j) hh = (hh ^ (uint32_t)st[j]) * FNV_PRIME;
          if (enq) hh = (hh ^ (uint32_t)v1) * FNV_PRIME;
          hh *= new_pow;                              // the dead slots
          hh = (hh ^ (uint32_t)cnt) * FNV_PRIME;      // count
          hh *= FNV_PRIME;                            // 0
        }
        hh = avalanche(hh);
        const uint16_t fpn = (uint16_t)((hh >> 16) | 1u);
        // ring word i of the new key's live window
        auto ring = [&](int i) -> uint32_t {
          const int j = nh + i;
          return (uint32_t)(enq && j == tail ? v1 : st[j]);
        };

        // the probes' fingerprints, one per thread 0..N_PROBES-1
        const uint16_t mine =
            t < N_PROBES ? fp[(hh + (uint32_t)t) & mask] : (uint16_t)0;
        const uint32_t used = __ballot_sync(FULL, mine != 0);
        uint32_t hit = __ballot_sync(FULL, mine == fpn);

        bool found = false;
        while (hit && !found) {
          const int pr = __ffs(hit) - 1;
          hit &= hit - 1;
          const uint32_t* r = keys + (size_t)((hh + (uint32_t)pr) & mask) * kw;
          // the words this thread compares, loaded CHUNK at a time
          uint32_t diff = 0u;
          for (int w0 = t; w0 < nw; w0 += CHUNK * WARP) {
            uint32_t a[CHUNK], b[CHUNK];
#pragma unroll
            for (int j = 0; j < CHUNK; ++j) {
              const int w = w0 + j * WARP;
              a[j] = w < nw ? r[w] : 0u;
              b[j] = w < nw ? lin[w] | (w == word ? bit : 0u) : 0u;
            }
#pragma unroll
            for (int j = 0; j < CHUNK; ++j) diff |= a[j] ^ b[j];
          }
          if (SCALAR) {
            diff |= r[nw] ^ (uint32_t)new_state;
          } else if (MODEL == FIFO_QUEUE) {
            diff |= r[nw + wr] ^ (uint32_t)cnt;
            for (int i = t; i < cnt; i += WARP) diff |= r[nw + i] ^ ring(i);
          }
          found = __all_sync(FULL, diff == 0u);
        }

        if (!found) {
          lifted = true;
          // memo insert at the first unused probe, else the last: the
          // bitset words, then the state (the fifo's live window and count)
          const uint32_t free_probes = ~used & ((1u << N_PROBES) - 1);
          const int pr = free_probes ? __ffs(free_probes) - 1 : N_PROBES - 1;
          const uint32_t ins = (hh + (uint32_t)pr) & mask;
          uint32_t* r = keys + (size_t)ins * kw;
          for (int w0 = t; w0 < nw; w0 += CHUNK * WARP) {
            uint32_t v[CHUNK];
#pragma unroll
            for (int j = 0; j < CHUNK; ++j) {
              const int w = w0 + j * WARP;
              v[j] = w < nw ? lin[w] : 0u;
            }
#pragma unroll
            for (int j = 0; j < CHUNK; ++j) {
              const int w = w0 + j * WARP;
              if (w < nw) r[w] = v[j] | (w == word ? bit : 0u);
            }
          }
          if (SCALAR) {
            if (t == 0) r[nw] = (uint32_t)new_state;
          } else if (MODEL == FIFO_QUEUE) {
            for (int i = t; i < cnt; i += WARP) r[nw + i] = ring(i);
            if (t == 0) r[nw + wr] = (uint32_t)cnt;
          }
          fp[ins] = fpn;
          // push, then apply the step
          const int dpush = depth < n - 1 ? depth : n - 1;
          stack[dpush] = (NodeT)node;
          if (SCALAR) {
            stack_s[dpush] = state;
            top_s = state;
            state = new_state;
          } else if (MODEL == UNORDERED_QUEUE) {
            __syncwarp();  // every thread has read count_now
            st[slot] = count_now + (f == 0 ? 1 : -1);
          } else {
            if (enq) st[tail] = v1;
            head = nh;
            tail = nt;
            dead_pow = new_pow;
          }
          top_node = node;
          top_e = e;
          top_fact = fact;
          top_v1 = v1;
          top_z = z;
          lin[word] = lw | bit;
          h = new_h;
          depth += 1;
          completed += (fact >> 2) & 1 ? 0 : 1;

          // unlink the call node (write A), then the return node (write
          // B, on the list as A left it)
          nxt[pa] = (NodeT)qa;
          prv[qa] = (NodeT)pa;
          const int32_t pb = rn == qa ? pa : prn;
          const int32_t qb = rn == pa ? qa : nrn;
          nxt[pb] = (NodeT)qb;
          prv[qb] = (NodeT)pb;
          first = pb == 0 ? qb : (pa == 0 ? qa : first);
          node = first;
          if (completed == ncomp) verdict = VALID;
        }
      }
      if (!lifted) node = qa;  // advance
    } else if (depth == 0) {
      // a return event with nothing to pop: no order linearizes
      verdict = INVALID;
    } else {
      // backtrack: pop the last lift (the top, in registers) and undo it
      const int cn2 = top_node, rn2 = top_fact >> 3, e2 = top_e;
      const int32_t pa = prv[rn2], qa = nxt[rn2];
      const int32_t pc = prv[cn2], nc = nxt[cn2];
      const uint32_t lw2 = lin[e2 >> 5];
      const int f2 = top_fact & 3;
      if (SCALAR) {
        state = top_s;
      } else if (MODEL == UNORDERED_QUEUE) {
        const int s2 = top_v1 < 0 ? 0 : (top_v1 > S - 1 ? S - 1 : top_v1);
        const int32_t c2 = st[s2];
        __syncwarp();  // every thread has read c2
        st[s2] = c2 + (f2 == 0 ? -1 : 1);
      } else {
        if (f2 == 1) {
          head -= 1;
          dead_pow *= FNV_PRIME_INV;
        }
        if (f2 == 0) {
          tail -= 1;
          dead_pow *= FNV_PRIME;
        }
      }
      lin[e2 >> 5] = lw2 & ~(1u << (e2 & 31));
      h ^= top_z;
      depth -= 1;
      completed -= (top_fact >> 2) & 1 ? 0 : 1;

      // relink the return node (write A), then the call node (write B, on
      // the list as A left it)
      nxt[pa] = (NodeT)rn2;
      prv[qa] = (NodeT)rn2;
      const int32_t pb = cn2 == qa ? rn2 : pc;
      const int32_t qb = cn2 == pa ? rn2 : nc;
      nxt[pb] = (NodeT)cn2;
      prv[qb] = (NodeT)cn2;
      node = pb == cn2 ? cn2 : qb;  // nxt[cn2] after write B
      first = pb == 0 ? cn2 : (pa == 0 ? rn2 : first);

      // the new top, into registers for the next pop
      if (depth > 0) {
        top_node = stack[depth - 1];
        top_e = nmap[top_node] >> 1;
        top_fact = facts[top_e];
        top_z = zobrist(top_e);
        if (MODEL == UNORDERED_QUEUE) top_v1 = v1_of[top_e];
        if (SCALAR) top_s = stack_s[depth - 1];
      }
    }
    steps += 1;
    __syncwarp();
  }

  if (t == 0) {
    p.small[lane] = verdict == RUNNING ? UNKNOWN : verdict;
    p.small[p.lanes + lane] = steps;
    p.small[2 * p.lanes + lane] = depth;
  }
}

using KernelFn = void (*)(Params);

template <int MODEL>
KernelFn pick(const Plan& p) {
  if (p.node_bytes == 2) return wgl_search_kernel<MODEL, uint16_t, uint16_t>;
  if (p.ent_bytes == 2) return wgl_search_kernel<MODEL, uint32_t, uint16_t>;
  return wgl_search_kernel<MODEL, uint32_t, uint32_t>;
}

}  // namespace

// One block (one warp) a lane: the lane's tables where `plan` (N_TABLES + 6
// int64, `Plan`) places them, in its `lane_bytes` of dynamic shared memory
// or in `scratch`, `lane_words` words a lane. The launch
// refuses a shape or a plan that fails `plan_ok`; past the device's opt-in
// limit cudaFuncSetAttribute fails, and its error is returned; else it
// returns cudaGetLastError().
extern "C" int wgl_search_launch(const void* packed, const void* msteps,
                                 void* small, void* scratch, int lanes,
                                 int n_pad, int m_pad, int rows, int model,
                                 int n_state, int cache_bits, int nw,
                                 int init_state, const long long* plan,
                                 void* stream) {
  if (model < CAS_REGISTER || model > FIFO_QUEUE) return (int)cudaErrorInvalidValue;
  const bool scalar = model <= MUTEX;
  const int kw = nw + (scalar ? 1 : model == FIFO_QUEUE ? n_state : 0);
  Plan pl;
  memcpy(&pl, plan, sizeof pl);
  if (n_pad < 1 || nw != (n_pad + 31) / 32 ||
      m_pad < 2 * n_pad + 1 || m_pad % 8 || rows != 6 * n_pad + 4 * m_pad + 1 ||
      (scalar && n_state != 1) || (model == FIFO_QUEUE && n_state < 3) ||
      n_state < 1 || cache_bits < 3 || cache_bits > 20 ||
      !plan_ok(pl, model, n_pad, m_pad, kw, cache_bits) ||
      pl.lane_bytes > 0x7FFFFFFF)
    return (int)cudaErrorInvalidValue;
  if (lanes == 0) return 0;
  const KernelFn kernel =
      model == CAS_REGISTER      ? pick<CAS_REGISTER>(pl)
      : model == REGISTER        ? pick<REGISTER>(pl)
      : model == MUTEX           ? pick<MUTEX>(pl)
      : model == UNORDERED_QUEUE ? pick<UNORDERED_QUEUE>(pl)
                                 : pick<FIFO_QUEUE>(pl);
  const int smem_bytes = (int)pl.lane_bytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  Params p;
  p.packed = static_cast<const int32_t*>(packed);
  p.msteps = static_cast<const int32_t*>(msteps);
  p.small = static_cast<int32_t*>(small);
  p.scratch = static_cast<unsigned char*>(scratch);
  p.plan = pl;
  p.lanes = lanes;
  p.n_pad = n_pad;
  p.m_pad = m_pad;
  p.rows = rows;
  p.n_state = n_state;
  p.cache_bits = cache_bits;
  p.nw = nw;
  p.init_state = init_state;
  kernel<<<lanes, WARP, smem_bytes, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
