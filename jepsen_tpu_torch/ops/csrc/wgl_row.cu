// WGL linearizability search for long lanes, one warp per lane, the whole
// depth-first search inside one launch.
//
// Replaces the TPU kernel jepsen_tpu/ops/wgl_pallas.py::_make_kernel (K5)
// and computes exactly what it computes — the same verdict, step count and
// depth for every lane — for the scalar models (cas-register, register,
// mutex) on lanes of up to 4064 entries:
//   - the memo: 2^cache_bits rows per lane, each an exact key (the lane's
//     ceil(n_pad/32) bitset words, then the model state); a lookup probes
//     N_PROBES consecutive slots from the key's hash, finds the key iff
//     some used probe holds it whole (all probes are checked, not only
//     those before the first unused one), and a lift inserts it at the
//     first unused probe, else at the last;
//   - the same hash: the incremental Zobrist bitset hash folded with the
//     state, FNV multiply, avalanche, all in uint32 (K5's int32 multiply
//     wraps and its shifts are logical on the uint32 view);
//   - the same linked-list algebra (write B after, and reading, write A),
//     state snapshots for the undo, and verdict rules: a lane with no
//     completed op is VALID before any step, one still running at its
//     step budget is UNKNOWN.
// K5 keeps its key in one 128-word row (bitset words 0..126, the state in
// word 127). Here each key holds the live words only; the words past the
// lane's last entry are zero in every K5 row, so the compare is the same.
//
// Layout: the wrapper (ops/wgl_row.py) packs each lane's inputs
// contiguously (lane-major, `_pack`), and gives each lane a contiguous
// scratch area: memo keys (slots x key_words), used flags (slots), nxt,
// prv (m_pad each), stack_e, stack_s (n_pad each). The Zobrist table is
// one (n_pad,) array for every lane.
//
// The warp: thread t holds bitset words t, t+32, t+64 and t+96 of the
// current key in registers, so a probe reads one memo row coalesced (each
// thread its own words) and its verdict is one warp vote. The search's
// scalars (node, state, hash, depth, ...) are kept by every thread alike:
// loads of them are broadcasts, stores write the same value from every
// thread, and a __syncwarp() ends each step.
//
// What bounds it on an H100: each step is a chain of dependent loads from
// device memory (node -> entry -> its facts -> memo probe rows -> list
// neighbours), one warp per lane, so it is latency-bound, far above both
// the bytes and the operations it needs. The memo (1 MiB a lane at 4064
// entries) is zeroed at the start of every launch, inside the kernel's
// time, as K5 re-zeroes it for each lane. Later work can keep the list and
// the hot memo rows in shared memory or run several lanes per warp.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int32_t RUNNING = 0, VALID = 1, INVALID = 2, UNKNOWN = 3;
constexpr int32_t NIL32 = 1 << 30;
constexpr int N_PROBES = 8;
constexpr int WARP = 32;
constexpr int WPT = 4;  // key words per thread: keys of up to 128 words
constexpr uint32_t FULL = 0xFFFFFFFFu;
constexpr uint32_t FNV_BASIS = 2166136261u;

// model ids, as ops/wgl_row.py's MODEL_IDS
constexpr int CAS_REGISTER = 0, REGISTER = 1, MUTEX = 2;

struct Params {
  const int32_t* packed;  // (lanes, rows), `_pack` layout
  const int32_t* ztab;    // (n_pad,) Zobrist table (uint32 bits)
  const int32_t* msteps;  // (lanes,) step budgets
  int32_t* small;         // (3, lanes): verdict, steps, depth
  int32_t* scratch;       // (lanes, scratch_rows)
  int lanes, n_pad, m_pad, rows, scratch_rows, model, cache_bits, nw,
      init_state;
};

__device__ __forceinline__ uint32_t mix_hash(uint32_t h_lin, int32_t state) {
  uint32_t h = (h_lin ^ (uint32_t)state) * 16777619u;
  h = (h ^ (h >> 15)) * 0x85EBCA6Bu;
  return h ^ (h >> 13);
}

__global__ void wgl_row_kernel(Params p) {
  const int lane = blockIdx.x;
  const int t = threadIdx.x;
  const int n = p.n_pad, m = p.m_pad;
  const int kw = p.nw + 1;  // key words: bitset, then the state
  const int slots = 1 << p.cache_bits;
  const uint32_t mask = (uint32_t)slots - 1;

  const int32_t* in = p.packed + (size_t)lane * p.rows;
  const int32_t* f_of = in;
  const int32_t* v1_of = in + n;
  const int32_t* v2_of = in + 2 * n;
  const int32_t* crashed_of = in + 3 * n;
  const int32_t* call_of = in + 4 * n;
  const int32_t* ret_of = in + 5 * n;
  const int32_t* node_entry = in + 6 * n;
  const int32_t* node_is_call = node_entry + m;
  const int32_t* nxt0 = node_is_call + m;
  const int32_t* prv0 = nxt0 + m;
  const int32_t ncomp = prv0[m];

  int32_t* s = p.scratch + (size_t)lane * p.scratch_rows;
  int32_t* memo = s;
  int32_t* used = memo + (size_t)slots * kw;
  int32_t* nxt = used + slots;
  int32_t* prv = nxt + m;
  int32_t* stack_e = prv + m;
  int32_t* stack_s = stack_e + n;

  const int32_t max_steps = p.msteps[lane];
  int32_t verdict = ncomp == 0 ? VALID : RUNNING;
  int32_t steps = 0, depth = 0;

  if (verdict == RUNNING && steps < max_steps) {
    // the memo starts empty for every lane (16-byte stores: the wrapper
    // keeps each lane's scratch 16-byte aligned, slots * kw % 4 == 0)
    int4* memo4 = reinterpret_cast<int4*>(memo);
    const int n4 = slots * kw / 4;
    for (int i = t; i < n4; i += WARP) memo4[i] = make_int4(0, 0, 0, 0);
    for (int i = t; i < slots; i += WARP) used[i] = 0;
    for (int i = t; i < m; i += WARP) {
      nxt[i] = nxt0[i];
      prv[i] = prv0[i];
    }
    for (int i = t; i < n; i += WARP) {
      stack_e[i] = 0;
      stack_s[i] = 0;
    }
    __syncwarp();
  }

  uint32_t row[WPT];  // this thread's bitset words: w = t + 32 * j
#pragma unroll
  for (int j = 0; j < WPT; ++j) row[j] = 0;
  int32_t node = nxt0[0];
  int32_t state = p.init_state;
  uint32_t h = FNV_BASIS;
  int32_t completed = 0;

  while (verdict == RUNNING && steps < max_steps) {
    const int e = node_entry[node];
    const bool is_call = node != 0 && node_is_call[node] != 0;

    if (is_call) {
      const int f = f_of[e];
      const int32_t v1 = v1_of[e];
      bool ok;
      int32_t new_state = state;
      if (p.model == CAS_REGISTER) {
        const bool match = state == v1;
        ok = (f == 0 && (v1 == NIL32 || match)) || f == 1 || (f == 2 && match);
        new_state = f == 1 ? v1 : (f == 2 && match ? v2_of[e] : state);
      } else if (p.model == REGISTER) {
        ok = f == 1 || (f == 0 && (v1 == NIL32 || state == v1));
        new_state = f == 1 ? v1 : state;
      } else {  // MUTEX
        ok = (f == 0 && state == 0) || (f == 1 && state == 1);
        new_state = ok ? (f == 0 ? 1 : 0) : state;
      }

      bool lifted = false;
      if (ok) {
        const int word = e >> 5;
        const uint32_t bit = 1u << (e & 31);
        const uint32_t new_h = h ^ (uint32_t)p.ztab[e];
        const uint32_t hh = mix_hash(new_h, new_state);

        // this thread's words of the new key
        uint32_t key[WPT];
#pragma unroll
        for (int j = 0; j < WPT; ++j) {
          const int w = t + WARP * j;
          key[j] = w < p.nw ? (row[j] | (w == word ? bit : 0u))
                            : (uint32_t)new_state;  // w == nw: the state
        }

        bool found = false;
        int ins = -1, last = 0;
        for (int pr = 0; pr < N_PROBES && !found; ++pr) {
          const int slot = (int)((hh + (uint32_t)pr) & mask);
          last = slot;
          if (used[slot]) {
            const int32_t* r = memo + (size_t)slot * kw;
            bool eq = true;
#pragma unroll
            for (int j = 0; j < WPT; ++j) {
              const int w = t + WARP * j;
              if (w < kw && (uint32_t)r[w] != key[j]) eq = false;
            }
            found = __all_sync(FULL, eq);
          } else if (ins < 0) {
            ins = slot;
          }
        }
        if (ins < 0) ins = last;

        if (!found) {
          lifted = true;
          // memo insert, then push
          int32_t* r = memo + (size_t)ins * kw;
#pragma unroll
          for (int j = 0; j < WPT; ++j) {
            const int w = t + WARP * j;
            if (w < kw) r[w] = (int32_t)key[j];
          }
          used[ins] = 1;
          const int dpush = depth < n - 1 ? depth : n - 1;
          stack_e[dpush] = e;
          stack_s[dpush] = state;

          state = new_state;
#pragma unroll
          for (int j = 0; j < WPT; ++j)
            if (t + WARP * j == word) row[j] |= bit;
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
      // backtrack: pop the last lift
      const int e2 = stack_e[depth - 1];
      state = stack_s[depth - 1];
#pragma unroll
      for (int j = 0; j < WPT; ++j)
        if (t + WARP * j == (e2 >> 5)) row[j] &= ~(1u << (e2 & 31));
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

// One block of one warp per lane. The scratch tensor holds, per lane, the
// areas listed above in ops/wgl_row.py::_scratch_rows order.
extern "C" int wgl_row_launch(const void* packed, const void* ztab,
                              const void* msteps, void* small, void* scratch,
                              int lanes, int n_pad, int m_pad, int rows,
                              int scratch_rows, int model, int cache_bits,
                              int nw, int init_state, void* stream) {
  if (nw + 1 > WARP * WPT) return (int)cudaErrorInvalidValue;
  if (lanes == 0) return 0;
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
  p.scratch_rows = scratch_rows;
  p.model = model;
  p.cache_bits = cache_bits;
  p.nw = nw;
  p.init_state = init_state;
  wgl_row_kernel<<<lanes, WARP, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
