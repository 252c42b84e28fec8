// WGL linearizability search over a batch of independent lanes, one CUDA
// thread per lane, the whole depth-first search inside one launch.
//
// Replaces the TPU kernel jepsen_tpu/ops/wgl_pallas_vec.py::_make_kernel
// (K1), and computes exactly what it computes — the same verdict, step
// count, depth, best depth, stuck entry and counterexample prefix for
// every lane:
//   - the same memo: `cache_slots` exact full-key slots per lane (128, or
//     fewer for wide fifo keys), a key found iff some used slot holds it
//     whole, insert at hm & (slots-1) with always-overwrite;
//   - the same zmix / hm hash constants, with int32 wraparound done in
//     uint32 and the arithmetic right shifts done on the signed value;
//   - the same linked-list algebra (write B after, and winning over,
//     write A), undo rules (state snapshot for the scalar models, exact
//     inverse step for the two queues), counterexample tracking at every
//     return event, and verdict rules.
// Where K1 emulates every data-dependent read with a one-hot masked
// reduction (Mosaic has no dynamic indexing), this kernel does plain
// indexed loads: node -> entry is a per-lane inverse map built at kernel
// start (valid because call/ret positions are a permutation, which
// _encode_flats asserts). K1 rewrites row 0 of nxt/prv with its own
// value on every iteration where a lane neither lifts nor pops; that
// write is a no-op and is skipped here.
//
// Layout: every array is [rows][width] int32, element (r, l) at
// r*width + l, so a warp's 32 lanes touch 32 neighbouring words of one
// row and the accesses coalesce. Inputs are the bit-packed buffer of
// wgl_vec._layout (the same row format K1 unpacks) and a per-lane step
// budget; outputs the 5-row result block and the best stack; the
// wrapper allocates all scratch (one [rows][width] tensor).
//
// What bounds it on an H100: each step is a chain of dependent loads
// from device memory through L1/L2 (node -> entry -> packed facts ->
// memo slot -> list neighbours), and lanes of a warp finish after
// different step counts (a warp runs until its slowest lane ends). It is
// neither bandwidth- nor ALU-bound in the roofline sense: it is
// latency-bound. K1's dominant cost, comparing the key against all
// slots x key_words memo words, is cut to one slot for the scalar models
// and the unordered queue (see the lookup below; fifo lanes still scan).
// Later work can hold the memo and the list in shared memory, run
// several lanes' loads in flight per thread, or regroup surviving lanes
// so warps stay full.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int32_t RUNNING = 0, VALID = 1, INVALID = 2, UNKNOWN = 3;
constexpr int32_t NIL32 = 1 << 30;
constexpr int32_t NIL16 = 32767;

// model ids, as ops/wgl_vec.py's MODEL_IDS
constexpr int CAS_REGISTER = 0, REGISTER = 1, MUTEX = 2,
              UNORDERED_QUEUE = 3, FIFO_QUEUE = 4;

struct Params {
  const int32_t* packed;  // (rows, width): meta, values, last row n|ncomp
  const int32_t* msteps;  // (width,) per-lane step budget
  int32_t* small;         // (5, width): verdict, steps, depth, bestd, stuck
  int32_t* best;          // (n_pad, width): best stack prefix, zero above
  int32_t* nxt;           // (m_pad, width) linked list of event nodes
  int32_t* prv;           // (m_pad, width)
  int32_t* ent;           // (m_pad, width) node -> (entry << 1) | is_call
  int32_t* stack_e;       // (n_pad, width) undo stack: entries
  int32_t* stack_s;       // (n_pad, width) undo stack: scalar states
  int32_t* cache;         // (slots * key_words, width) memo keys
  int32_t* cache_used;    // (slots, width)
  int32_t* lin;           // (nw, width) linearized bitset
  int32_t* qstate;        // (n_state, width) queue state rows
  int width, n_pad, m_pad, v16, model, n_state, slots, nw, key_words,
      init_state;
};

__device__ __forceinline__ int32_t zmix(int32_t x) {
  // splitmix-style diffusion, int32 wraparound as in K1
  uint32_t u = ((uint32_t)x + 0x9E3779B9u) * 0x9E3779B1u;
  int32_t s = (int32_t)u;
  u = (uint32_t)(s ^ (s >> 15)) * 0x85EBCA6Bu;
  s = (int32_t)u;
  return s ^ (s >> 13);
}

__device__ __forceinline__ int32_t fold(int32_t x) {
  // hm = x * 16777619 (wrapping); hm ^ (hm >> 15) on the signed value
  int32_t hm = (int32_t)((uint32_t)x * 16777619u);
  return hm ^ (hm >> 15);
}

__global__ void wgl_vec_kernel(Params p) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= p.width) return;
  const size_t W = (size_t)p.width;
#define AT(arr, r) (arr)[(size_t)(r) * W + l]

  const bool scalar = p.model <= MUTEX;
  const bool fifo = p.model == FIFO_QUEUE;
  const bool uq = p.model == UNORDERED_QUEUE;
  const int S = fifo ? p.n_state - 8 : 0;  // fifo ring capacity
  const int32_t last = AT(p.packed, (p.v16 ? 2 : 3) * p.n_pad);
  const int nn = last & 0xFFFF;
  const int32_t ncomp = last >> 16;
  const int32_t max_steps = p.msteps[l];

  for (int r = 0; r < p.n_pad; ++r) AT(p.best, r) = 0;
  int32_t verdict = ncomp == 0 ? VALID : RUNNING;
  int32_t steps = 0, depth = 0, bestd = -1, stuck = -1;

  if (verdict == RUNNING && steps < max_steps) {
    for (int i = 0; i < p.m_pad; ++i) {
      AT(p.nxt, i) = i < 2 * nn ? i + 1 : 0;
      AT(p.prv, i) = (i >= 1 && i <= 2 * nn) ? i - 1 : 0;
      AT(p.ent, i) = 0;
    }
    for (int e = 0; e < nn; ++e) {
      const int32_t meta = AT(p.packed, e);
      AT(p.ent, (meta >> 4) & 0xFFF) = (e << 1) | 1;
      AT(p.ent, (meta >> 16) & 0xFFF) = e << 1;
    }
    for (int s = 0; s < p.slots; ++s) AT(p.cache_used, s) = 0;
    for (int w = 0; w < p.nw; ++w) AT(p.lin, w) = 0;
    if (!scalar)
      for (int r = 0; r < p.n_state; ++r) AT(p.qstate, r) = 0;
  }

  // per-entry facts straight from the packed rows
  auto f_of = [&](int e) { return (AT(p.packed, e) & 7) - 1; };
  auto crashed_of = [&](int e) { return (AT(p.packed, e) >> 3) & 1; };
  auto cn_of = [&](int e) { return (AT(p.packed, e) >> 4) & 0xFFF; };
  auto rn_of = [&](int e) { return (AT(p.packed, e) >> 16) & 0xFFF; };
  auto v1_of = [&](int e) -> int32_t {
    if (!p.v16) return AT(p.packed, p.n_pad + e);
    const int32_t lo = (int32_t)(int16_t)(AT(p.packed, p.n_pad + e) & 0xFFFF);
    return lo == NIL16 ? NIL32 : lo;
  };
  auto v2_of = [&](int e) -> int32_t {
    if (!p.v16) return AT(p.packed, 2 * p.n_pad + e);
    const int32_t hi = AT(p.packed, p.n_pad + e) >> 16;
    return hi == NIL16 ? NIL32 : hi;
  };

  int32_t node = nn > 0 ? 1 : 0;
  int32_t state = p.init_state;  // scalar models
  int32_t h = 0, completed = 0;

  while (verdict == RUNNING && steps < max_steps) {
    const int32_t en = AT(p.ent, node);
    const int e = en >> 1;
    const bool is_call = node != 0 && (en & 1);
    bool lifted = false;

    if (is_call) {
      const int f = f_of(e);
      const int32_t v1 = v1_of(e);
      bool ok;
      int32_t new_state = state;  // scalar models
      int qrow = -1;              // fifo: the ring row the step changes
      int32_t qval = 0;
      if (p.model == CAS_REGISTER) {
        const bool match = state == v1;
        ok = (f == 0 && (v1 == NIL32 || match)) || f == 1 || (f == 2 && match);
        new_state = f == 1 ? v1 : (f == 2 && match ? v2_of(e) : state);
      } else if (p.model == REGISTER) {
        ok = f == 1 || (f == 0 && (v1 == NIL32 || state == v1));
        new_state = f == 1 ? v1 : state;
      } else if (p.model == MUTEX) {
        ok = (f == 0 && state == 0) || (f == 1 && state == 1);
        new_state = ok ? (f == 0 ? 1 : 0) : state;
      } else if (uq) {
        const int32_t cnt =
            (v1 >= 0 && v1 < p.n_state) ? AT(p.qstate, v1) : 0;
        ok = f == 0 || (f == 1 && cnt > 0);
      } else {  // fifo
        const int32_t head = AT(p.qstate, S), tail = AT(p.qstate, S + 1);
        const int32_t front =
            (head >= 0 && head < p.n_state) ? AT(p.qstate, head) : 0;
        const bool enq_ok = f == 0 && tail < S;
        const bool deq_ok = f == 1 && head < tail && front == v1 + 1;
        ok = enq_ok || deq_ok;
        qrow = enq_ok ? tail : head;
        qval = enq_ok ? v1 + 1 : 0;
      }

      if (ok) {
        const int word = e >> 5;
        const int32_t bit = (int32_t)(1u << (e & 31));
        const int32_t new_h = h ^ zmix(e);
        const int32_t hm = scalar ? fold(new_h ^ new_state)
                           : fifo ? fold(new_h ^ zmix(v1))
                                  : fold(new_h);
        const int slot = hm & (p.slots - 1);

        // exact full-key compare of slot s against the new key
        auto matches = [&](int s) {
          if (!AT(p.cache_used, s)) return false;
          const int base = s * p.key_words;
          for (int w = 0; w < p.nw; ++w)
            if (AT(p.cache, base + w) != (AT(p.lin, w) | (w == word ? bit : 0)))
              return false;
          if (scalar && AT(p.cache, base + p.nw) != new_state) return false;
          if (fifo)
            for (int j = 0; j < S; ++j)
              if (AT(p.cache, base + p.nw + j) !=
                  (j == qrow ? qval : AT(p.qstate, j)))
                return false;
          return true;
        };
        // K1 compares every used slot. For the scalar models and the
        // unordered queue one slot is enough: h is the XOR of zmix over
        // the entries set in the bitset, so hm (and the insert slot) is a
        // function of the key itself, every key sits in the slot its own
        // hash picks, and a key held anywhere is held at `slot`. The fifo
        // hash also folds in the stepped value, which the key does not
        // determine, so fifo lanes compare every slot as K1 does.
        bool found = false;
        if (fifo) {
          for (int s = 0; s < p.slots && !found; ++s) found = matches(s);
        } else {
          found = matches(slot);
        }

        if (!found) {
          lifted = true;
          // memo insert (always overwrite), then push
          const int base = slot * p.key_words;
          for (int w = 0; w < p.nw; ++w)
            AT(p.cache, base + w) = AT(p.lin, w) | (w == word ? bit : 0);
          if (scalar) AT(p.cache, base + p.nw) = new_state;
          if (fifo)
            for (int j = 0; j < S; ++j)
              AT(p.cache, base + p.nw + j) = j == qrow ? qval : AT(p.qstate, j);
          AT(p.cache_used, slot) = 1;
          AT(p.stack_e, depth) = e;
          if (scalar) AT(p.stack_s, depth) = state;

          // apply the step
          if (scalar) {
            state = new_state;
          } else if (uq) {
            if (v1 >= 0 && v1 < p.n_state) AT(p.qstate, v1) += f == 0 ? 1 : -1;
          } else {
            AT(p.qstate, qrow) = qval;
            if (f == 0) AT(p.qstate, S + 1) += 1; else AT(p.qstate, S) += 1;
          }
          AT(p.lin, word) |= bit;
          h = new_h;
          depth += 1;
          completed += crashed_of(e) ? 0 : 1;

          // unlink the call node (write A), then the return node (write B,
          // reading the list as A left it)
          const int cn = cn_of(e), rn = rn_of(e);
          int32_t pa = AT(p.prv, cn), qa = AT(p.nxt, cn);
          AT(p.nxt, pa) = qa;
          AT(p.prv, qa) = pa;
          int32_t pb = AT(p.prv, rn), qb = AT(p.nxt, rn);
          AT(p.nxt, pb) = qb;
          AT(p.prv, qb) = pb;
          node = AT(p.nxt, 0);
          if (completed == ncomp) verdict = VALID;
        }
      }
      if (!lifted) node = AT(p.nxt, node);  // advance
    } else {
      // a return event (or the end): nothing minimal linearizes here
      if (depth > bestd) {
        bestd = depth;
        stuck = node == 0 ? -1 : e;
        for (int r = 0; r < depth; ++r) AT(p.best, r) = AT(p.stack_e, r);
      }
      if (depth == 0) {
        verdict = INVALID;
      } else {
        const int e2 = AT(p.stack_e, depth - 1);
        if (scalar) {
          state = AT(p.stack_s, depth - 1);
        } else if (uq) {
          const int32_t v = v1_of(e2);
          if (v >= 0 && v < p.n_state) AT(p.qstate, v) += f_of(e2) == 0 ? -1 : 1;
        } else {
          const int f2 = f_of(e2);
          if (f2 == 0) {
            const int32_t tail = AT(p.qstate, S + 1);
            AT(p.qstate, tail - 1) = 0;
            AT(p.qstate, S + 1) = tail - 1;
          } else if (f2 == 1) {
            const int32_t head = AT(p.qstate, S);
            AT(p.qstate, head - 1) = v1_of(e2) + 1;
            AT(p.qstate, S) = head - 1;
          }
        }
        AT(p.lin, e2 >> 5) &= ~(int32_t)(1u << (e2 & 31));
        h ^= zmix(e2);
        depth -= 1;
        completed -= crashed_of(e2) ? 0 : 1;

        // relink the return node (write A), then the call node (write B)
        const int cn2 = cn_of(e2), rn2 = rn_of(e2);
        int32_t pa = AT(p.prv, rn2), qa = AT(p.nxt, rn2);
        AT(p.nxt, pa) = rn2;
        AT(p.prv, qa) = rn2;
        int32_t pb = AT(p.prv, cn2), qb = AT(p.nxt, cn2);
        AT(p.nxt, pb) = cn2;
        AT(p.prv, qb) = cn2;
        node = AT(p.nxt, cn2);
      }
    }
    steps += 1;
  }

  AT(p.small, 0) = verdict == RUNNING ? UNKNOWN : verdict;
  AT(p.small, 1) = steps;
  AT(p.small, 2) = depth;
  AT(p.small, 3) = bestd;
  AT(p.small, 4) = stuck;
#undef AT
}

}  // namespace

// The scratch tensor holds, in rows of `width` int32 words:
// nxt, prv, ent (m_pad each), stack_e (n_pad), stack_s (n_pad for the
// scalar models, else 1), cache (slots * key_words), cache_used (slots),
// lin (nw), qstate (n_state) — ops/wgl_vec.py::_scratch_rows.
extern "C" int wgl_vec_launch(const void* packed, const void* msteps,
                              void* small, void* best, void* scratch,
                              int width, int n_pad, int m_pad, int v16,
                              int model, int n_state, int slots, int nw,
                              int key_words, int init_state, int threads,
                              void* stream) {
  Params p;
  p.packed = static_cast<const int32_t*>(packed);
  p.msteps = static_cast<const int32_t*>(msteps);
  p.small = static_cast<int32_t*>(small);
  p.best = static_cast<int32_t*>(best);
  int32_t* s = static_cast<int32_t*>(scratch);
  const size_t W = (size_t)width;
  const bool scalar = model <= MUTEX;
  p.nxt = s;             s += (size_t)m_pad * W;
  p.prv = s;             s += (size_t)m_pad * W;
  p.ent = s;             s += (size_t)m_pad * W;
  p.stack_e = s;         s += (size_t)n_pad * W;
  p.stack_s = s;         s += (size_t)(scalar ? n_pad : 1) * W;
  p.cache = s;           s += (size_t)slots * key_words * W;
  p.cache_used = s;      s += (size_t)slots * W;
  p.lin = s;             s += (size_t)nw * W;
  p.qstate = s;
  p.width = width;
  p.n_pad = n_pad;
  p.m_pad = m_pad;
  p.v16 = v16;
  p.model = model;
  p.n_state = n_state;
  p.slots = slots;
  p.nw = nw;
  p.key_words = key_words;
  p.init_state = init_state;
  const int blocks = (width + threads - 1) / threads;
  wgl_vec_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
