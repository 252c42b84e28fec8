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
// What bounds it on an H100, and where each table lives. A search step is
// a chain of dependent reads (node -> entry -> its facts -> memo probe ->
// list neighbours), one warp per lane, so the kernel is bound by the
// latency of that chain, far above both the bytes and the operations it
// needs. So everything a step reads, except the memo's key rows, sits in
// dynamic shared memory (~30 cycles a read instead of an L2 or HBM round
// trip), decoded from the packed lane once at kernel start:
//   block:    the Zobrist table (n_pad uint32), shared by the block's warps
//   per lane: facts (n_pad int32: (f+1) | crashed << 2 | call node << 3
//             | ret node << 16), v1 and v2 (n_pad int32 each), the undo
//             stack's states (n_pad int32), the memo's fingerprints
//             (2^cache_bits uint32: hh | 1 of the key a slot holds, 0 when
//             unused), then as int16 the list nxt, prv (m_pad each), the
//             node map (m_pad: entry << 1 | is_call) and the undo stack's
//             entries (n_pad).
// At n_pad 4064 that is ~146 KB (cache_bits 11) for one lane a block; at
// n_pad <= 2048 several warps share a block (ops/wgl_row.py::_smem_plan
// computes the same layout and the lanes a block takes).
// The key rows (2^cache_bits x key words, 1 MiB a lane at n_pad 4064) stay
// in device memory and are never zeroed: a row is read only where its
// slot's fingerprint equals the new key's hh, which is a function of the
// key (the Zobrist XOR over the set entries, folded with the state), so a
// differing fingerprint cannot hold the key. Threads 0-7 read the 8
// probes' fingerprints at once and two ballots give the used and the
// matching probes; only matching rows are loaded, all in one round trip
// (thread t takes words t, t+32, t+64, t+96 of each), with one warp vote
// per row. A lift writes its key row without waiting on the store.
//
// The warp: thread t holds bitset words t, t+32, t+64 and t+96 of the
// current key in registers. The search's scalars (node, state, hash,
// depth, ...) are kept by every thread alike: shared-memory reads of them
// are broadcasts, stores write the same value from every thread, and a
// __syncwarp() ends each step so no thread runs ahead into the next. Each
// step starts the reads of the next event and of the undo stack's top
// together, so a pop does not wait on the event read before it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int32_t RUNNING = 0, VALID = 1, INVALID = 2, UNKNOWN = 3;
constexpr int32_t NIL32 = 1 << 30;
constexpr int N_PROBES = 8;
constexpr int WARP = 32;
constexpr int WPT = 4;  // key words per thread: keys of up to 128 words
constexpr int MAX_LANES_PER_BLOCK = 8;
constexpr uint32_t FULL = 0xFFFFFFFFu;
constexpr uint32_t FNV_BASIS = 2166136261u;

// model ids, as ops/wgl_row.py's MODEL_IDS
constexpr int CAS_REGISTER = 0, REGISTER = 1, MUTEX = 2;

struct Params {
  const int32_t* packed;  // (lanes, rows), `_pack` layout
  const int32_t* ztab;    // (n_pad,) Zobrist table (uint32 bits)
  const int32_t* msteps;  // (lanes,) step budgets
  int32_t* small;         // (3, lanes): verdict, steps, depth
  int32_t* keys;          // (lanes, 2^cache_bits * key words) memo key rows
  int lanes, n_pad, m_pad, rows, cache_bits, nw, init_state,
      lanes_per_block, lane_bytes;
};

// Bytes of one lane's shared tables (layout above); a multiple of 16 since
// n_pad >= 8 and m_pad % 8 == 0.
__host__ __device__ inline int lane_bytes(int n_pad, int m_pad,
                                          int cache_bits) {
  return 4 * (4 * n_pad + (1 << cache_bits)) + 2 * (3 * m_pad + n_pad);
}

__device__ __forceinline__ uint32_t mix_hash(uint32_t h_lin, int32_t state) {
  uint32_t h = (h_lin ^ (uint32_t)state) * 16777619u;
  h = (h ^ (h >> 15)) * 0x85EBCA6Bu;
  return h ^ (h >> 13);
}

// One instantiation per model, so a step carries no branch on it.
template <int MODEL>
__global__ void __launch_bounds__(WARP * MAX_LANES_PER_BLOCK)
    wgl_row_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = threadIdx.x & (WARP - 1);
  const int wid = threadIdx.x / WARP;
  const int lane = blockIdx.x * p.lanes_per_block + wid;
  const int n = p.n_pad, m = p.m_pad;
  const int kw = p.nw + 1;  // key words: bitset, then the state
  const int slots = 1 << p.cache_bits;
  const uint32_t mask = (uint32_t)slots - 1;

  uint32_t* ztab = reinterpret_cast<uint32_t*>(smem);
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    ztab[i] = (uint32_t)p.ztab[i];
  __syncthreads();
  if (lane >= p.lanes) return;

  unsigned char* base = smem + 4 * n + (size_t)wid * p.lane_bytes;
  int32_t* facts = reinterpret_cast<int32_t*>(base);
  int32_t* v1_of = facts + n;
  int32_t* v2_of = v1_of + n;
  int32_t* stack_s = v2_of + n;
  uint32_t* fp = reinterpret_cast<uint32_t*>(stack_s + n);
  int16_t* nxt = reinterpret_cast<int16_t*>(fp + slots);
  int16_t* prv = nxt + m;
  int16_t* nmap = prv + m;
  int16_t* stack_e = nmap + m;

  const int32_t* in = p.packed + (size_t)lane * p.rows;
  const int32_t ncomp = in[6 * n + 4 * m];
  int32_t* keys = p.keys + (size_t)lane * slots * kw;

  const int32_t max_steps = p.msteps[lane];
  int32_t verdict = ncomp == 0 ? VALID : RUNNING;
  int32_t steps = 0, depth = 0;

  if (verdict == RUNNING && steps < max_steps) {
    // decode the lane (columns f, v1, v2, crashed, call, ret; then
    // node_entry, node_is_call, nxt0, prv0) into the shared tables
    for (int i = t; i < n; i += WARP) {
      facts[i] = (in[i] + 1) | ((in[3 * n + i] != 0) << 2) |
                 (in[4 * n + i] << 3) | (in[5 * n + i] << 16);
      v1_of[i] = in[n + i];
      v2_of[i] = in[2 * n + i];
    }
    const int32_t* nodes = in + 6 * n;
    for (int i = t; i < m; i += WARP) {
      nmap[i] = (int16_t)((nodes[i] << 1) | (nodes[m + i] != 0));
      nxt[i] = (int16_t)nodes[2 * m + i];
      prv[i] = (int16_t)nodes[3 * m + i];
    }
    // the memo starts empty: only the fingerprints are cleared
    for (int i = t; i < slots; i += WARP) fp[i] = 0u;
    stack_e[0] = 0;  // read (as a valid entry) before the first push
    __syncwarp();
  }

  uint32_t row[WPT];  // this thread's bitset words: w = t + 32 * j
#pragma unroll
  for (int j = 0; j < WPT; ++j) row[j] = 0;
  int32_t node = in[6 * n + 2 * m];  // nxt0[0]
  int32_t state = p.init_state;
  uint32_t h = FNV_BASIS;
  int32_t completed = 0;

  while (verdict == RUNNING && steps < max_steps) {
    // the next event's reads and the undo stack top's start together
    const int en = nmap[node];
    const int top = depth > 0 ? depth - 1 : 0;
    const int e2 = stack_e[top];
    const int32_t pop_state = stack_s[top];
    const int32_t fact2 = facts[e2];
    const int e = en >> 1;
    const bool is_call = node != 0 && (en & 1);

    if (is_call) {
      const int32_t fact = facts[e];
      const int f = (fact & 3) - 1;
      const int32_t v1 = v1_of[e];
      bool ok;
      int32_t new_state = state;
      if (MODEL == CAS_REGISTER) {
        const bool match = state == v1;
        ok = (f == 0 && (v1 == NIL32 || match)) || f == 1 || (f == 2 && match);
        new_state = f == 1 ? v1 : (f == 2 && match ? v2_of[e] : state);
      } else if (MODEL == REGISTER) {
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
        const uint32_t new_h = h ^ ztab[e];
        const uint32_t hh = mix_hash(new_h, new_state);
        const uint32_t fpn = hh | 1u;

        // the probes' fingerprints, one per thread 0..N_PROBES-1
        const uint32_t mine = t < N_PROBES ? fp[(hh + (uint32_t)t) & mask] : 0u;
        const uint32_t used = __ballot_sync(FULL, mine != 0u);
        const uint32_t hit = __ballot_sync(FULL, mine == fpn);

        // this thread's words of the new key
        uint32_t key[WPT];
#pragma unroll
        for (int j = 0; j < WPT; ++j) {
          const int w = t + WARP * j;
          key[j] = w < p.nw ? (row[j] | (w == word ? bit : 0u))
                            : (uint32_t)new_state;  // w == nw: the state
        }

        bool found = false;
        if (hit) {
          // every row whose fingerprint matches, loaded in one round trip
          uint32_t got[N_PROBES][WPT];
#pragma unroll
          for (int pr = 0; pr < N_PROBES; ++pr) {
            const uint32_t* r = reinterpret_cast<const uint32_t*>(keys) +
                                (size_t)((hh + (uint32_t)pr) & mask) * kw;
#pragma unroll
            for (int j = 0; j < WPT; ++j) {
              const int w = t + WARP * j;
              got[pr][j] = ((hit >> pr) & 1u) && w < kw ? r[w] : key[j];
            }
          }
#pragma unroll
          for (int pr = 0; pr < N_PROBES; ++pr) {
            if ((hit >> pr) & 1u) {
              bool eq = true;
#pragma unroll
              for (int j = 0; j < WPT; ++j) eq = eq && got[pr][j] == key[j];
              found = __all_sync(FULL, eq) || found;
            }
          }
        }

        if (!found) {
          lifted = true;
          // memo insert at the first unused probe, else the last; then push
          const uint32_t free_probes = ~used & ((1u << N_PROBES) - 1);
          const int pr = free_probes ? __ffs(free_probes) - 1 : N_PROBES - 1;
          const uint32_t ins = (hh + (uint32_t)pr) & mask;
          int32_t* r = keys + (size_t)ins * kw;
#pragma unroll
          for (int j = 0; j < WPT; ++j) {
            const int w = t + WARP * j;
            if (w < kw) r[w] = (int32_t)key[j];
          }
          fp[ins] = fpn;
          const int dpush = depth < n - 1 ? depth : n - 1;
          stack_e[dpush] = (int16_t)e;
          stack_s[dpush] = state;

          state = new_state;
#pragma unroll
          for (int j = 0; j < WPT; ++j)
            if (t + WARP * j == word) row[j] |= bit;
          h = new_h;
          depth += 1;
          completed += (fact >> 2) & 1 ? 0 : 1;

          // unlink the call node (write A), then the return node (write B,
          // reading the list as A left it)
          const int cn = (fact >> 3) & 0x1FFF, rn = fact >> 16;
          const int16_t pa = prv[cn], qa = nxt[cn];
          nxt[pa] = qa;
          prv[qa] = pa;
          const int16_t pb = prv[rn], qb = nxt[rn];
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
      state = pop_state;
#pragma unroll
      for (int j = 0; j < WPT; ++j)
        if (t + WARP * j == (e2 >> 5)) row[j] &= ~(1u << (e2 & 31));
      h ^= ztab[e2];
      depth -= 1;
      completed -= (fact2 >> 2) & 1 ? 0 : 1;

      // relink the return node (write A), then the call node (write B)
      const int cn2 = (fact2 >> 3) & 0x1FFF, rn2 = fact2 >> 16;
      const int16_t pa = prv[rn2], qa = nxt[rn2];
      nxt[pa] = (int16_t)rn2;
      prv[qa] = (int16_t)rn2;
      const int16_t pb = prv[cn2], qb = nxt[cn2];
      nxt[pb] = (int16_t)cn2;
      prv[qb] = (int16_t)cn2;
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

// Blocks of `lanes_per_block` warps, one lane each, with `smem_bytes` of
// dynamic shared memory (the Zobrist table, then each warp's tables); the
// wrapper (ops/wgl_row.py::_smem_plan) computes both, and the launch
// refuses a plan that disagrees with the layout above. Past the device's
// opt-in limit cudaFuncSetAttribute fails, and its error is returned.
// `keys` holds each lane's memo key rows (ops/wgl_row.py::_scratch_rows).
extern "C" int wgl_row_launch(const void* packed, const void* ztab,
                              const void* msteps, void* small, void* keys,
                              int lanes, int n_pad, int m_pad, int rows,
                              int model, int cache_bits, int nw,
                              int init_state, int lanes_per_block,
                              int smem_bytes, void* stream) {
  const int lb = lane_bytes(n_pad, m_pad, cache_bits);
  if (nw + 1 > WARP * WPT || n_pad > 4096 || m_pad > 8192 ||
      lanes_per_block < 1 || lanes_per_block > MAX_LANES_PER_BLOCK ||
      smem_bytes != 4 * n_pad + lanes_per_block * lb)
    return (int)cudaErrorInvalidValue;
  if (lanes == 0) return 0;
  void (*kernel)(Params) = model == CAS_REGISTER ? wgl_row_kernel<CAS_REGISTER>
                          : model == REGISTER   ? wgl_row_kernel<REGISTER>
                          : model == MUTEX      ? wgl_row_kernel<MUTEX>
                                                : nullptr;
  if (!kernel) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  Params p;
  p.packed = static_cast<const int32_t*>(packed);
  p.ztab = static_cast<const int32_t*>(ztab);
  p.msteps = static_cast<const int32_t*>(msteps);
  p.small = static_cast<int32_t*>(small);
  p.keys = static_cast<int32_t*>(keys);
  p.lanes = lanes;
  p.n_pad = n_pad;
  p.m_pad = m_pad;
  p.rows = rows;
  p.cache_bits = cache_bits;
  p.nw = nw;
  p.init_state = init_state;
  p.lanes_per_block = lanes_per_block;
  p.lane_bytes = lb;
  const int blocks = (lanes + lanes_per_block - 1) / lanes_per_block;
  kernel<<<blocks, WARP * lanes_per_block, smem_bytes,
           static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
