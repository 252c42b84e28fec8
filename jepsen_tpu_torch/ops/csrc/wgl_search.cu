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
// Where the state lives. At n_pad 32768 one lane's linked list alone is
// 2 x 65,544 words, and its memo keys 8192 x 1025 words (33.6 MB), far
// past a block's 227 KB of shared memory. So each lane keeps everything
// it writes in device memory, in its slice of one scratch tensor the
// wrapper allocates per launch (`layout` below; ops/wgl_search.py::_layout
// computes the same offsets, and the launch refuses a disagreeing size):
//   fp       2^cache_bits uint32: per memo slot the fingerprint hh | 1 of
//            the key it holds (hh = the key's hash), 0 when unused
//   lin      the bitset, ceil(n_pad/32) words (rounded to 4)
//   state    n_state words (rounded to 4): the queue's counts or ring
//   nxt, prv the linked list (m_pad words each)
//   stack_e  the undo stack's entries (n_pad)
//   stack_s  the undo stack's states (n_pad; scalar models only)
//   keys     the memo key rows, 2^cache_bits x key words
// The kernel clears fp, lin and state and copies the list in at its start;
// the key rows are never cleared: a row is read only where its slot's
// fingerprint equals the new key's hh | 1, and hh is a function of the
// key, so an unused or differing slot cannot hold the key. The lane's
// packed input (facts, node map) is read in place.
//
// What bounds it on an H100: a search step is a chain of dependent reads
// (node -> entry -> its facts -> the hash -> the memo probe -> the list
// neighbours) by one warp, so the kernel is bound by that chain's latency
// through L1/L2, far above both the bytes and the operations a step needs.
// The warp shares what is wide: threads 0-7 read the 8 probes'
// fingerprints at once (two ballots give the used and the matching
// probes), a matching row is compared word by word strided over the warp
// with one vote, and an insert writes the key row strided the same way.
// The fifo's FNV fold is serial in the live window's length; the words
// past it are zeros, and (h ^ 0) * p = h * p, so they fold as one
// multiply by p^zeros.
//
// The search's scalars (node, depth, hash, cursors, ...) are kept by every
// thread alike; every thread issues the same stores of the same values
// (idempotent within a step), a __syncwarp() ends each step, and the one
// read-modify-write (the unordered queue's counter) reads before a
// __syncwarp() and writes after it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int32_t RUNNING = 0, VALID = 1, INVALID = 2, UNKNOWN = 3;
constexpr int32_t NIL32 = 1 << 30;
constexpr int N_PROBES = 8;
constexpr int WARP = 32;
constexpr uint32_t FULL = 0xFFFFFFFFu;
constexpr uint32_t FNV_BASIS = 2166136261u;
constexpr uint32_t FNV_PRIME = 16777619u;

// model ids, as ops/wgl_search.py's MODEL_IDS
constexpr int CAS_REGISTER = 0, REGISTER = 1, MUTEX = 2, UNORDERED_QUEUE = 3,
              FIFO_QUEUE = 4;

struct Params {
  const int32_t* packed;  // (lanes, rows), `_pack` layout
  const int32_t* ztab;    // (n_pad,) Zobrist table (uint32 bits)
  const int32_t* msteps;  // (lanes,) step budgets
  int32_t* small;         // (3, lanes): verdict, steps, depth
  int32_t* scratch;       // (lanes, lane_words) per-lane tables
  int lanes, n_pad, m_pad, rows, n_state, cache_bits, nw, init_state;
  long long lane_words;
};

__host__ __device__ inline long long round4(long long x) {
  return (x + 3) & ~3LL;
}

// Word offsets of one lane's scratch (ops/wgl_search.py::_layout).
struct Layout {
  long long lin, state, nxt, prv, stack_e, stack_s, keys, words;
};

__host__ __device__ inline Layout layout(int n_pad, int m_pad, int n_state,
                                         int cache_bits, int kw,
                                         bool snapshots) {
  const long long slots = 1LL << cache_bits;
  Layout l;
  l.lin = slots;  // fp at 0
  l.state = l.lin + round4((n_pad + 31) / 32);
  l.nxt = l.state + round4(n_state);
  l.prv = l.nxt + m_pad;
  l.stack_e = l.prv + m_pad;
  l.stack_s = l.stack_e + n_pad;
  l.keys = l.stack_s + (snapshots ? n_pad : 0);
  l.words = round4(l.keys + slots * kw);
  return l;
}

__device__ __forceinline__ uint32_t avalanche(uint32_t h) {
  h = (h ^ (h >> 15)) * 0x85EBCA6Bu;
  return h ^ (h >> 13);
}

// FNV_PRIME^k mod 2^32: k zero words folded in at once.
__device__ __forceinline__ uint32_t prime_pow(int k) {
  uint32_t r = 1u, b = FNV_PRIME;
  while (k > 0) {
    if (k & 1) r *= b;
    b *= b;
    k >>= 1;
  }
  return r;
}

// One instantiation per model, so a step carries no branch on it.
template <int MODEL>
__global__ void __launch_bounds__(WARP) wgl_search_kernel(Params p) {
  constexpr bool SCALAR = MODEL <= MUTEX;
  constexpr bool IN_KEY = MODEL != UNORDERED_QUEUE;
  const int t = threadIdx.x;
  const int lane = blockIdx.x;
  const int n = p.n_pad, m = p.m_pad, S = p.n_state, nw = p.nw;
  const int kw = nw + (IN_KEY ? S : 0);
  const int slots = 1 << p.cache_bits;
  const uint32_t mask = (uint32_t)slots - 1;
  const int wr = S - 2;  // fifo: ring slots (head and tail follow)
  const Layout L = layout(n, m, S, p.cache_bits, kw, SCALAR);

  int32_t* scr = p.scratch + (size_t)lane * p.lane_words;
  uint32_t* fp = reinterpret_cast<uint32_t*>(scr);
  uint32_t* lin = reinterpret_cast<uint32_t*>(scr + L.lin);
  int32_t* st = scr + L.state;
  int32_t* nxt = scr + L.nxt;
  int32_t* prv = scr + L.prv;
  int32_t* stack_e = scr + L.stack_e;
  int32_t* stack_s = scr + L.stack_s;
  const uint32_t* keys = reinterpret_cast<const uint32_t*>(scr + L.keys);
  uint32_t* keys_w = reinterpret_cast<uint32_t*>(scr + L.keys);

  const int32_t* in = p.packed + (size_t)lane * p.rows;
  const int32_t* f_of = in;
  const int32_t* v1_of = in + n;
  const int32_t* v2_of = in + 2 * n;
  const int32_t* crashed_of = in + 3 * n;
  const int32_t* call_of = in + 4 * n;
  const int32_t* ret_of = in + 5 * n;
  const int32_t* node_entry = in + 6 * n;
  const int32_t* node_is_call = node_entry + m;
  const int32_t* nxt0 = node_entry + 2 * m;
  const int32_t* prv0 = node_entry + 3 * m;
  const int32_t ncomp = node_entry[4 * m];

  const int32_t max_steps = p.msteps[lane];
  int32_t verdict = ncomp == 0 ? VALID : RUNNING;
  int32_t steps = 0, depth = 0;

  if (verdict == RUNNING && steps < max_steps) {
    for (int i = t; i < slots; i += WARP) fp[i] = 0u;
    for (int i = t; i < nw; i += WARP) lin[i] = 0u;
    for (int i = t; i < S; i += WARP) st[i] = 0;
    for (int i = t; i < m; i += WARP) {
      nxt[i] = nxt0[i];
      prv[i] = prv0[i];
    }
    __syncwarp();
  }

  int32_t node = nxt0[0];
  int32_t state = p.init_state;  // scalar models
  int32_t head = 0, tail = 0;    // fifo cursors
  uint32_t h = FNV_BASIS;
  int32_t completed = 0;

  while (verdict == RUNNING && steps < max_steps) {
    const int e = node_entry[node];
    const bool is_call = node != 0 && node_is_call[node] != 0;

    if (is_call) {
      const int f = f_of[e];
      const int32_t v1 = v1_of[e];
      bool ok;
      int32_t new_state = state;  // scalar models
      int slot = 0;               // unordered: the value's counter
      int32_t count_now = 0;      // ... and its count
      bool enq = false;           // fifo: this lift enqueues
      if (MODEL == CAS_REGISTER) {
        const bool match = state == v1;
        ok = (f == 0 && (v1 == NIL32 || match)) || f == 1 || (f == 2 && match);
        new_state = f == 1 ? v1 : (f == 2 && match ? v2_of[e] : state);
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
        const int word = e >> 5;
        const uint32_t bit = 1u << (e & 31);
        const uint32_t new_h = h ^ (uint32_t)p.ztab[e];
        // the fifo state after this step: window [nh, nt), and ring slot
        // `tail` reads v1 when it enqueues
        const int nh = head + (enq ? 0 : 1);
        const int nt = tail + (enq ? 1 : 0);
        const int cnt = nt - nh;
        auto ring = [&](int j) -> uint32_t {
          return (uint32_t)(enq && j == tail ? v1 : st[j]);
        };
        uint32_t hh = new_h;
        if (SCALAR) {
          hh = (hh ^ (uint32_t)new_state) * FNV_PRIME;
        } else if (MODEL == FIFO_QUEUE) {
          for (int i = 0; i < cnt; ++i) hh = (hh ^ ring(nh + i)) * FNV_PRIME;
          hh *= prime_pow(wr - cnt);                  // the dead slots
          hh = (hh ^ (uint32_t)cnt) * FNV_PRIME;      // count
          hh *= FNV_PRIME;                            // 0
        }
        hh = avalanche(hh);
        const uint32_t fpn = hh | 1u;

        // word w of the new key: the bitset with e's bit, then the
        // canonical state
        auto key_word = [&](int w) -> uint32_t {
          if (w < nw) return lin[w] | (w == word ? bit : 0u);
          if (SCALAR) return (uint32_t)new_state;
          const int i = w - nw;
          return i < cnt ? ring(nh + i) : (i == wr ? (uint32_t)cnt : 0u);
        };

        // the probes' fingerprints, one per thread 0..N_PROBES-1
        const uint32_t mine =
            t < N_PROBES ? fp[(hh + (uint32_t)t) & mask] : 0u;
        const uint32_t used = __ballot_sync(FULL, mine != 0u);
        const uint32_t hit = __ballot_sync(FULL, mine == fpn);

        bool found = false;
        for (int pr = 0; pr < N_PROBES; ++pr) {
          if ((hit >> pr) & 1u) {
            const uint32_t* r = keys + (size_t)((hh + (uint32_t)pr) & mask) * kw;
            bool eq = true;
            for (int w = t; w < kw; w += WARP) eq = eq && r[w] == key_word(w);
            found = __all_sync(FULL, eq) || found;
          }
        }

        if (!found) {
          lifted = true;
          // memo insert at the first unused probe, else the last
          const uint32_t free_probes = ~used & ((1u << N_PROBES) - 1);
          const int pr = free_probes ? __ffs(free_probes) - 1 : N_PROBES - 1;
          const uint32_t ins = (hh + (uint32_t)pr) & mask;
          uint32_t* r = keys_w + (size_t)ins * kw;
          for (int w = t; w < kw; w += WARP) r[w] = key_word(w);
          fp[ins] = fpn;
          // push, then apply the step
          const int dpush = depth < n - 1 ? depth : n - 1;
          stack_e[dpush] = e;
          if (SCALAR) {
            stack_s[dpush] = state;
            state = new_state;
          } else if (MODEL == UNORDERED_QUEUE) {
            __syncwarp();  // every thread has read count_now
            st[slot] = count_now + (f == 0 ? 1 : -1);
          } else {
            if (enq) st[tail] = v1;
            head = nh;
            tail = nt;
          }
          lin[word] |= bit;
          h = new_h;
          depth += 1;
          completed += crashed_of[e] ? 0 : 1;

          // unlink the call node (write A), then the return node (write B,
          // reading the list as A left it)
          const int cn = call_of[e], rn = ret_of[e];
          const int32_t pa = prv[cn], qa = nxt[cn];
          nxt[pa] = qa;
          prv[qa] = pa;
          const int32_t pb = prv[rn], qb = nxt[rn];
          nxt[pb] = qb;
          prv[qb] = pb;
          node = nxt[0];
          if (completed == ncomp) verdict = VALID;
        }
      }
      if (!lifted) node = nxt[node];  // advance
    } else if (depth == 0) {
      // a return event with nothing to pop: no order linearizes
      verdict = INVALID;
    } else {
      // backtrack: pop the last lift and undo its step
      const int e2 = stack_e[depth - 1];
      if (SCALAR) {
        state = stack_s[depth - 1];
      } else if (MODEL == UNORDERED_QUEUE) {
        const int32_t v = v1_of[e2];
        const int s2 = v < 0 ? 0 : (v > S - 1 ? S - 1 : v);
        const int32_t c2 = st[s2];
        __syncwarp();  // every thread has read c2
        st[s2] = c2 + (f_of[e2] == 0 ? -1 : 1);
      } else {
        if (f_of[e2] == 1) head -= 1;
        if (f_of[e2] == 0) tail -= 1;
      }
      lin[e2 >> 5] &= ~(1u << (e2 & 31));
      h ^= (uint32_t)p.ztab[e2];
      depth -= 1;
      completed -= crashed_of[e2] ? 0 : 1;

      // relink the return node (write A), then the call node (write B)
      const int cn2 = call_of[e2], rn2 = ret_of[e2];
      const int32_t pa = prv[rn2], qa = nxt[rn2];
      nxt[pa] = rn2;
      prv[qa] = rn2;
      const int32_t pb = prv[cn2], qb = nxt[cn2];
      nxt[pb] = cn2;
      prv[qb] = cn2;
      node = nxt[cn2];
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

}  // namespace

// One block of one warp per lane. `scratch` holds `lane_words` words a lane
// (ops/wgl_search.py::_layout); the launch refuses a size or shape that
// disagrees with the layout above, and returns cudaGetLastError().
extern "C" int wgl_search_launch(const void* packed, const void* ztab,
                                 const void* msteps, void* small,
                                 void* scratch, int lanes, int n_pad,
                                 int m_pad, int rows, int model, int n_state,
                                 int cache_bits, int nw, int init_state,
                                 long long lane_words, void* stream) {
  if (model < CAS_REGISTER || model > FIFO_QUEUE) return (int)cudaErrorInvalidValue;
  const bool scalar = model <= MUTEX;
  const int kw = nw + (model != UNORDERED_QUEUE ? n_state : 0);
  const Layout l = layout(n_pad, m_pad, n_state, cache_bits, kw, scalar);
  if (n_pad < 1 || nw != (n_pad + 31) / 32 ||
      m_pad < 2 * n_pad + 1 || m_pad % 8 || rows != 6 * n_pad + 4 * m_pad + 1 ||
      (scalar && n_state != 1) || (model == FIFO_QUEUE && n_state < 3) ||
      n_state < 1 || cache_bits < 3 || cache_bits > 20 ||
      lane_words != l.words)
    return (int)cudaErrorInvalidValue;
  if (lanes == 0) return 0;
  void (*kernel)(Params) =
      model == CAS_REGISTER    ? wgl_search_kernel<CAS_REGISTER>
      : model == REGISTER      ? wgl_search_kernel<REGISTER>
      : model == MUTEX         ? wgl_search_kernel<MUTEX>
      : model == UNORDERED_QUEUE ? wgl_search_kernel<UNORDERED_QUEUE>
                               : wgl_search_kernel<FIFO_QUEUE>;
  Params p;
  p.packed = static_cast<const int32_t*>(packed);
  p.ztab = static_cast<const int32_t*>(ztab);
  p.msteps = static_cast<const int32_t*>(msteps);
  p.small = static_cast<int32_t*>(small);
  p.scratch = static_cast<int32_t*>(scratch);
  p.lanes = lanes;
  p.n_pad = n_pad;
  p.m_pad = m_pad;
  p.rows = rows;
  p.n_state = n_state;
  p.cache_bits = cache_bits;
  p.nw = nw;
  p.init_state = init_state;
  p.lane_words = lane_words;
  kernel<<<lanes, WARP, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
