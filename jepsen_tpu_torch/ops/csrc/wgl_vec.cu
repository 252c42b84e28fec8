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
// What bounds it on an H100: each search step is a chain of dependent
// reads (node -> entry -> its facts -> memo slot -> list neighbours), and
// the lanes of a warp finish after different step counts (a warp runs
// until its slowest lane ends). So the kernel is bound by the latency of
// that chain, not by bytes or operations. Every table a step reads
// therefore lives in dynamic shared memory: a block is one warp holding
// L <= 32 lanes (thread t runs lane blockIdx.x * L + t), and each table
// is [rows][L], lane-minor, so the 32 threads' 4-byte reads of any rows
// fall in 32 different banks when L is 32. The block first holds
// zmix(e) for every entry e (n_pad int32, shared by its lanes); then per
// lane (rows of the table):
//   int32: meta (n_pad: (f+1) | crashed<<3 | call<<4 | ret<<16 as
//          packed), v1, v2 (n_pad each, decoded from either packing),
//          the undo stack's states (n_pad for the scalar models, else 1),
//          lin (nw bitset words), the queue state (n_state), one
//          fingerprint per memo slot (the key's hash | 1, 0 when unused),
//          and the memo keys (slots x key words);
//   int16: nxt, prv, the node map (m_pad each), the undo stack's entries
//          and the best stack (n_pad each).
// Lanes of one warp that take different branches (lift, advance, pop)
// run them one after another, so a warp of many deep lanes steps more
// slowly than a warp of one. The wrapper therefore packs lanes into
// warps only as far as the launch fills the card (16 warps an SM); a
// launch of few lanes runs one lane a warp. The step itself starts the
// reads of the next event and of the undo stack's top together, and a
// lift and a pop share one list update.
// ops/wgl_vec.py::_smem_plan computes the same layout and picks L; every
// shape the router admits fits at least four lanes a block (n_pad 1024:
// ~50 KB a lane), so nothing stays in device memory but the inputs and
// outputs. A slot's keys are compared only where its fingerprint
// matches. The fingerprint is a function of the key: for the
// scalar models and the unordered queue hm itself (h is the XOR of zmix
// over the entries set in the bitset), so the one slot hm picks is
// compared only when its stored hm equals the new one; the fifo hash also
// folds in the stepped value, which the key does not determine, so fifo
// lanes scan every slot as K1 does, but keep the bitset hash h as the
// fingerprint and compare only the slots whose h matches.
// The best stack is kept in shared memory and written to device memory
// once at the end; at a new best depth only the rows pushed since the
// last copy are copied (rows below the lowest push since then are equal).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int32_t RUNNING = 0, VALID = 1, INVALID = 2, UNKNOWN = 3;
constexpr int32_t NIL32 = 1 << 30;
constexpr int32_t NIL16 = 32767;
constexpr int WARP = 32;

// model ids, as ops/wgl_vec.py's MODEL_IDS
constexpr int CAS_REGISTER = 0, REGISTER = 1, MUTEX = 2,
              UNORDERED_QUEUE = 3, FIFO_QUEUE = 4;

struct Params {
  const int32_t* packed;  // (rows, width): meta, values, last row n|ncomp
  const int32_t* msteps;  // (width,) per-lane step budget
  int32_t* small;         // (5, width): verdict, steps, depth, bestd, stuck
  int32_t* best;          // (n_pad, width): best stack prefix, zero above
  int width, n_pad, m_pad, v16, n_state, slots, nw, key_words, init_state,
      lanes_per_block;
};

// Bytes of one lane's shared tables (layout above; the block adds the
// n_pad-word zmix table in front).
inline int lane_bytes(int n_pad, int m_pad, int model, int n_state,
                      int slots, int nw, int key_words) {
  const int stack_s = model <= MUTEX ? n_pad : 1;
  return 4 * (3 * n_pad + stack_s + nw + n_state + slots * (1 + key_words)) +
         2 * (3 * m_pad + 2 * n_pad);
}

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

// One instantiation per model, so a step carries no branch on it.
template <int MODEL>
__global__ void __launch_bounds__(WARP) wgl_vec_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = threadIdx.x;
  const int L = p.lanes_per_block;
  const int l0 = blockIdx.x * L;
  const int cols = min(L, p.width - l0);  // lanes of this block
  const size_t W = (size_t)p.width;
  const int n = p.n_pad, m = p.m_pad;
  constexpr bool scalar = MODEL <= MUTEX;
  constexpr bool fifo = MODEL == FIFO_QUEUE;
  constexpr bool uq = MODEL == UNORDERED_QUEUE;
  const int S = fifo ? p.n_state - 8 : 0;  // fifo ring capacity
  const int slots = p.slots, nw = p.nw, kw = p.key_words;

  int32_t* zm = reinterpret_cast<int32_t*>(smem);  // zmix of each entry
  int32_t* meta = zm + n;
  int32_t* v1t = meta + n * L;
  int32_t* v2t = v1t + n * L;
  int32_t* stk_s = v2t + n * L;
  int32_t* lin = stk_s + (scalar ? n : 1) * L;
  int32_t* qst = lin + nw * L;
  int32_t* fps = qst + p.n_state * L;
  int32_t* kcs = fps + slots * L;
  int16_t* nxt = reinterpret_cast<int16_t*>(kcs + slots * kw * L);
  int16_t* prv = nxt + m * L;
  int16_t* ent = prv + m * L;
  int16_t* stk_e = ent + m * L;
  int16_t* bst = stk_e + n * L;

  // the block's warp decodes its lanes into the shared tables together
  const int last_row = (p.v16 ? 2 : 3) * n;
  for (int i = t; i < n; i += WARP) zm[i] = zmix(i);
  for (int i = t; i < n * L; i += WARP) {
    const int r = i / L, c = i - r * L;
    if (c >= cols) continue;
    const size_t g = (size_t)r * W + l0 + c;
    meta[i] = __ldg(p.packed + g);
    if (p.v16) {
      const int32_t raw = __ldg(p.packed + n * W + g);
      const int32_t lo = (int32_t)(int16_t)(raw & 0xFFFF);
      const int32_t hi = raw >> 16;
      v1t[i] = lo == NIL16 ? NIL32 : lo;
      v2t[i] = hi == NIL16 ? NIL32 : hi;
    } else {
      v1t[i] = __ldg(p.packed + n * W + g);
      v2t[i] = __ldg(p.packed + 2 * n * W + g);
    }
  }
  for (int i = t; i < m * L; i += WARP) {
    const int r = i / L, c = i - r * L;
    const int nn =
        c < cols ? __ldg(p.packed + last_row * W + l0 + c) & 0xFFFF : 0;
    nxt[i] = (int16_t)(r < 2 * nn ? r + 1 : 0);
    prv[i] = (int16_t)((r >= 1 && r <= 2 * nn) ? r - 1 : 0);
    ent[i] = 0;
  }
  for (int i = t; i < slots * L; i += WARP) fps[i] = 0;
  for (int i = t; i < nw * L; i += WARP) lin[i] = 0;
  for (int i = t; i < p.n_state * L; i += WARP) qst[i] = 0;
  // the undo stack's bottom row is read before any push (see the step)
  for (int i = t; i < L; i += WARP) stk_e[i] = 0;
  __syncwarp();
  if (t >= cols) return;

#define A(tab, r) (tab)[(r) * L + t]
  const int l = l0 + t;
  const int32_t last = __ldg(p.packed + last_row * W + l);
  const int nn = last & 0xFFFF;
  const int32_t ncomp = last >> 16;
  const int32_t max_steps = p.msteps[l];

  // node -> (entry << 1) | is_call
  for (int e = 0; e < nn; ++e) {
    const int32_t mt = A(meta, e);
    A(ent, (mt >> 4) & 0xFFF) = (int16_t)((e << 1) | 1);
    A(ent, (mt >> 16) & 0xFFF) = (int16_t)(e << 1);
  }

  int32_t verdict = ncomp == 0 ? VALID : RUNNING;
  int32_t steps = 0, depth = 0, bestd = -1, stuck = -1;
  int32_t node = nn > 0 ? 1 : 0;
  int32_t state = p.init_state;  // scalar models
  int32_t h = 0, completed = 0;
  int dirty = 0;  // best stack rows below this equal the undo stack's

  // One step, laid out so the lanes of a warp stay together: the reads
  // of both the next event (node -> entry -> facts) and the top of the
  // undo stack (entry -> facts) start at once, only the memo probe and
  // the lift's and pop's own bookkeeping branch, and a lift and a pop
  // share one list update (write A, then write B reading A's result).
  while (verdict == RUNNING && steps < max_steps) {
    const int en = A(ent, node);
    const int top = depth > 0 ? depth - 1 : 0;
    const int e2 = A(stk_e, top);  // a valid entry: row 0 starts zeroed
    const int32_t pop_state = scalar ? A(stk_s, top) : 0;
    const int e = en >> 1;
    const bool is_call = node != 0 && (en & 1);
    const int32_t mt = A(meta, e);
    const int32_t mt2 = A(meta, e2);
    const int f = (mt & 7) - 1;
    const int32_t v1 = A(v1t, e);

    bool ok;
    int32_t new_state = state;  // scalar models
    int qrow = -1;              // fifo: the ring row the step changes
    int32_t qval = 0;
    if (MODEL == CAS_REGISTER) {
      const bool match = state == v1;
      ok = (f == 0 && (v1 == NIL32 || match)) || f == 1 || (f == 2 && match);
      new_state = f == 1 ? v1 : (f == 2 && match ? A(v2t, e) : state);
    } else if (MODEL == REGISTER) {
      ok = f == 1 || (f == 0 && (v1 == NIL32 || state == v1));
      new_state = f == 1 ? v1 : state;
    } else if (MODEL == MUTEX) {
      ok = (f == 0 && state == 0) || (f == 1 && state == 1);
      new_state = ok ? (f == 0 ? 1 : 0) : state;
    } else if (uq) {
      const int32_t cnt = (v1 >= 0 && v1 < p.n_state) ? A(qst, v1) : 0;
      ok = f == 0 || (f == 1 && cnt > 0);
    } else {  // fifo
      const int32_t head = A(qst, S), tail = A(qst, S + 1);
      const int32_t front =
          (head >= 0 && head < p.n_state) ? A(qst, head) : 0;
      const bool enq_ok = f == 0 && tail < S;
      const bool deq_ok = f == 1 && head < tail && front == v1 + 1;
      ok = enq_ok || deq_ok;
      qrow = enq_ok ? tail : head;
      qval = enq_ok ? v1 + 1 : 0;
    }

    const int word = e >> 5;
    const int32_t bit = (int32_t)(1u << (e & 31));
    const int32_t new_h = h ^ zm[e];
    bool lift = false;
    if (is_call && ok) {
      const int32_t hm = scalar ? fold(new_h ^ new_state)
                         : fifo ? fold(new_h ^ zmix(v1))
                                : fold(new_h);
      const int slot = hm & (slots - 1);
      // the fingerprint a slot holding the new key carries
      const int32_t kfp = (fifo ? new_h : hm) | 1;

      // word w of the new key (zero past the key's words)
      auto key_word = [&](int w) -> int32_t {
        if (w < nw) return A(lin, w) | (w == word ? bit : 0);
        if (scalar) return w == nw ? new_state : 0;
        const int j = w - nw;
        if (fifo && j < S) return j == qrow ? qval : A(qst, j);
        return 0;
      };
      // exact full-key compare of slot s against the new key
      auto same_key = [&](int s) -> bool {
        bool eq = true;
#pragma unroll 4
        for (int w = 0; w < kw; ++w)
          eq = eq & (A(kcs, s * kw + w) == key_word(w));
        return eq;
      };
      // K1 compares every used slot. For the scalar models and the
      // unordered queue one slot is enough: hm (and the insert slot) is
      // a function of the key itself, every key sits in the slot its own
      // hash picks, and a key held anywhere is held at `slot`. Fifo
      // lanes compare every slot whose fingerprint matches.
      bool found = false;
      if (fifo) {
        for (int s = 0; s < slots && !found; ++s)
          found = A(fps, s) == kfp && same_key(s);
      } else {
        found = A(fps, slot) == kfp && same_key(slot);
      }

      if (!found) {
        lift = true;
        // memo insert (always overwrite), then push
        for (int w = 0; w < kw; ++w) A(kcs, slot * kw + w) = key_word(w);
        A(fps, slot) = kfp;
      }
    }
    const bool back = !is_call && depth > 0;

    if (!is_call) {
      // a return event (or the end): nothing minimal linearizes here
      if (depth > bestd) {
        for (int r = dirty; r < depth; ++r) A(bst, r) = A(stk_e, r);
        dirty = depth;
        bestd = depth;
        stuck = node == 0 ? -1 : e;
      }
      if (depth == 0) verdict = INVALID;
    }

    if (lift) {
      // push, then apply the step
      A(stk_e, depth) = (int16_t)e;
      if (depth < dirty) dirty = depth;
      if (scalar) {
        A(stk_s, depth) = state;
        state = new_state;
      } else if (uq) {
        if (v1 >= 0 && v1 < p.n_state) A(qst, v1) += f == 0 ? 1 : -1;
      } else {
        A(qst, qrow) = qval;
        if (f == 0) A(qst, S + 1) += 1; else A(qst, S) += 1;
      }
      A(lin, word) |= bit;
      h = new_h;
      depth += 1;
      completed += (mt >> 3) & 1 ? 0 : 1;
    } else if (back) {
      // pop the last lift: undo its step
      if (scalar) {
        state = pop_state;
      } else if (uq) {
        const int32_t v = A(v1t, e2);
        if (v >= 0 && v < p.n_state) A(qst, v) += (mt2 & 7) == 1 ? -1 : 1;
      } else {
        const int f2 = (mt2 & 7) - 1;
        if (f2 == 0) {
          const int32_t tail = A(qst, S + 1);
          A(qst, tail - 1) = 0;
          A(qst, S + 1) = tail - 1;
        } else if (f2 == 1) {
          const int32_t head = A(qst, S);
          A(qst, head - 1) = A(v1t, e2) + 1;
          A(qst, S) = head - 1;
        }
      }
      A(lin, e2 >> 5) &= ~(int32_t)(1u << (e2 & 31));
      h ^= zm[e2];
      depth -= 1;
      completed -= (mt2 >> 3) & 1 ? 0 : 1;
    }

    // the list: a lift unlinks its call node (write A), then its return
    // node (write B); a pop relinks the return node (A), then the call
    // node (B)
    const int cn = (mt >> 4) & 0xFFF, rn = (mt >> 16) & 0xFFF;
    const int cn2 = (mt2 >> 4) & 0xFFF, rn2 = (mt2 >> 16) & 0xFFF;
    if (lift || back) {
      const int src = lift ? cn : rn2, tgt = lift ? rn : cn2;
      const int pa = A(prv, src), qa = A(nxt, src);
      A(nxt, pa) = (int16_t)(lift ? qa : rn2);
      A(prv, qa) = (int16_t)(lift ? pa : rn2);
      const int pb = A(prv, tgt), qb = A(nxt, tgt);
      A(nxt, pb) = (int16_t)(lift ? qb : cn2);
      A(prv, qb) = (int16_t)(lift ? pb : cn2);
    }
    // the next node reads the list as this step left it: after a lift
    // the head's successor, after a pop the call node's, else (an
    // advance) this node's
    if (is_call || back) node = A(nxt, lift ? 0 : back ? cn2 : node);
    if (lift && completed == ncomp) verdict = VALID;
    steps += 1;
  }

  p.small[l] = verdict == RUNNING ? UNKNOWN : verdict;
  p.small[W + l] = steps;
  p.small[2 * W + l] = depth;
  p.small[3 * W + l] = bestd;
  p.small[4 * W + l] = stuck;
  for (int r = 0; r < n; ++r) p.best[r * W + l] = r < bestd ? A(bst, r) : 0;
#undef A
}

}  // namespace

// Blocks of one warp holding `lanes_per_block` lanes, with `smem_bytes` of
// dynamic shared memory (the zmix table, then the lanes' tables); the
// wrapper (ops/wgl_vec.py::_smem_plan) computes both, and the launch refuses
// a plan that disagrees with the layout above. Past the device's opt-in
// limit cudaFuncSetAttribute fails, and its error is returned.
extern "C" int wgl_vec_launch(const void* packed, const void* msteps,
                              void* small, void* best, int width, int n_pad,
                              int m_pad, int v16, int model, int n_state,
                              int slots, int nw, int key_words,
                              int init_state, int lanes_per_block,
                              int smem_bytes, void* stream) {
  const int lb =
      lane_bytes(n_pad, m_pad, model, n_state, slots, nw, key_words);
  if (lanes_per_block < 1 || lanes_per_block > WARP || n_pad > 2048 ||
      m_pad > 4096 || smem_bytes != 4 * n_pad + lanes_per_block * lb)
    return (int)cudaErrorInvalidValue;
  if (width == 0) return 0;
  Params p;
  p.packed = static_cast<const int32_t*>(packed);
  p.msteps = static_cast<const int32_t*>(msteps);
  p.small = static_cast<int32_t*>(small);
  p.best = static_cast<int32_t*>(best);
  p.width = width;
  p.n_pad = n_pad;
  p.m_pad = m_pad;
  p.v16 = v16;
  p.n_state = n_state;
  p.slots = slots;
  p.nw = nw;
  p.key_words = key_words;
  p.init_state = init_state;
  p.lanes_per_block = lanes_per_block;
  const int blocks = (width + lanes_per_block - 1) / lanes_per_block;
  void (*kernel)(Params) =
      model == CAS_REGISTER      ? wgl_vec_kernel<CAS_REGISTER>
      : model == REGISTER        ? wgl_vec_kernel<REGISTER>
      : model == MUTEX           ? wgl_vec_kernel<MUTEX>
      : model == UNORDERED_QUEUE ? wgl_vec_kernel<UNORDERED_QUEUE>
      : model == FIFO_QUEUE      ? wgl_vec_kernel<FIFO_QUEUE>
                                 : nullptr;
  if (!kernel) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, WARP, smem_bytes, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
