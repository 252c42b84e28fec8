// The list-append cluster simulator on the card: the counterpart of K4,
// the JAX package's jitted simulator (jepsen_tpu/fuzz/sim.py `_sim_math`,
// hash `_make_hi`). One block a cluster, THREADS threads striding over
// the cluster's slots, mops and (mop, node) pairs; every table of the
// cluster in dynamic shared memory (fuzz/sim.py `smem_bytes` computes the
// same size):
//
//   sched  [F * 6]   the cluster's canonical fault schedule
//   slot   [8 * St]  per txn slot: coordinator, mop count, failed,
//                    pause end, pause split, paused, clock offset, clock
//                    amplitude
//   mop    [6 * M]   per mop (m = s*L + j): kind, key, eff, valid append,
//                    valid read, position in its key's final order
//   deliv  [M * N]   delivery time of each append at each node
//
// Phases, with a barrier between each: (1) per slot, the coordinator and
// the faults covering it; (2) per mop, kind, key and effective time; (3)
// per mop, its rank among the valid appends of its key by (eff, mop
// index); (4) per (mop, node), the fault cascade in fault-slot order,
// each rule testing the delivery time the previous one wrote; (5) per
// mop, the read's prefix length, and every output. All arithmetic is
// int32 but the hash's, which is uint32 (murmur3 finalizers); every %
// has a non-negative left operand and a positive modulus, so C's % is
// Python's.
//
// What bounds it on the H100: operations (the 2*M^2 rank and visibility
// loop steps and the M*N*F cascade steps a cluster), not bytes (a few KB
// a cluster in and out). Each block's loops are chains of shared-memory
// loads and compares, so a block is latency-bound; the design keeps
// every table in shared memory and relies on many resident blocks (16
// an SM at the default spec) to hide that latency. The cascade stays
// sequential over fault slots inside one thread, since each rule reads
// the delivery time the previous one wrote.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int32_t BIG = 1 << 28;
constexpr int KIND_APPEND = 0, KIND_READ = 1, KIND_PAD = 2;
constexpr int PARTITION = 1, CLOCK = 2, KILL = 3, PAUSE = 4, CORRUPT = 5,
              PACKET = 6;

__device__ __forceinline__ uint32_t fmix(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  return h ^ (h >> 16);
}

// hash(workload seed, stream constant, index a, index b) in [0, 2^31)
__device__ __forceinline__ int32_t hi(uint32_t w, uint32_t c, uint32_t a,
                                      uint32_t b) {
  uint32_t h = fmix(w ^ 0x9E3779B9u);
  h = fmix(h ^ (a * 0x85EBCA6Bu));
  h = fmix(h ^ (b * 0xC2B2AE35u));
  h = fmix(h ^ (c * 0x27D4EB2Fu));
  return (int32_t)(h & 0x7FFFFFFFu);
}

struct Spec {
  int N, K, T, L, F, St, audit_t0;
};

__global__ void __launch_bounds__(THREADS)
sim_kernel(const int32_t* __restrict__ scheds,
           const int32_t* __restrict__ wseeds, Spec sp,
           int32_t* __restrict__ o_coord, uint8_t* __restrict__ o_failed,
           int32_t* __restrict__ o_kind, int32_t* __restrict__ o_key,
           int32_t* __restrict__ o_eff, int32_t* __restrict__ o_pos,
           int32_t* __restrict__ o_rlen) {
  extern __shared__ int32_t smem[];
  const int N = sp.N, K = sp.K, T = sp.T, L = sp.L, F = sp.F, St = sp.St;
  const int M = St * L;
  const long long c = blockIdx.x;
  int32_t* sched = smem;
  int32_t* s_coord = sched + 6 * F;
  int32_t* s_nmops = s_coord + St;
  int32_t* s_failed = s_nmops + St;
  int32_t* s_pend = s_failed + St;
  int32_t* s_psplit = s_pend + St;
  int32_t* s_paused = s_psplit + St;
  int32_t* s_coff = s_paused + St;
  int32_t* s_camp = s_coff + St;
  int32_t* m_kind = s_camp + St;
  int32_t* m_key = m_kind + M;
  int32_t* m_eff = m_key + M;
  int32_t* m_app = m_eff + M;
  int32_t* m_read = m_app + M;
  int32_t* m_pos = m_read + M;
  int32_t* deliv = m_pos + M;  // [M][N]

  const uint32_t w = (uint32_t)wseeds[c];
  for (int i = threadIdx.x; i < 6 * F; i += THREADS)
    sched[i] = scheds[c * 6 * F + i];
  __syncthreads();

  // (1) per slot
  for (int s = threadIdx.x; s < St; s += THREADS) {
    const bool audit = s >= T;
    const int coord = audit ? 0 : hi(w, 11, s, 0) % N;
    const int nmops = audit ? L : 1 + hi(w, 12, s, 0) % L;
    int failed = 0, pend = 0, psplit = 0, paused = 0, coff = 0, camp = 0;
    for (int f = 0; f < F; ++f) {
      const int32_t* q = sched + 6 * f;
      const bool cwin = ((q[1] >> coord) & 1) && q[2] <= s && s < q[3] &&
                        !audit;
      if (!cwin) continue;
      if (q[0] == KILL) failed = 1;
      if (q[0] == PAUSE) {
        paused = 1;
        pend = max(pend, q[3]);
        psplit = max(psplit, q[4]);
      }
      if (q[0] == CLOCK) {
        coff += q[4];
        camp = max(camp, q[5]);
      }
    }
    s_coord[s] = coord;
    s_nmops[s] = nmops;
    s_failed[s] = failed;
    s_pend[s] = pend;
    s_psplit[s] = psplit;
    s_paused[s] = paused;
    s_coff[s] = coff;
    s_camp[s] = camp;
  }
  __syncthreads();

  // (2) per mop
  for (int m = threadIdx.x; m < M; m += THREADS) {
    const int s = m / L, j = m % L;
    const bool audit = s >= T;
    const int rd = hi(w, 13, s, j) % 2;
    int key = hi(w, 14, s, j) % K;
    const int akey = (s - T) * L + j;
    const bool active = audit ? akey < K : j < s_nmops[s];
    if (audit) key = min(max(akey, 0), K - 1);
    const int kind = !active ? KIND_PAD
                     : (audit || rd == 1) ? KIND_READ : KIND_APPEND;
    int eff;
    if (audit) {
      eff = (sp.audit_t0 + s - T) * L + j;
    } else {
      const bool defer = s_paused[s] && j >= s_psplit[s];
      const int basew = defer ? s_pend[s] * L + j : s * L + j;
      const int camp = s_camp[s];
      const int jit = hi(w, 16, s, j) % (2 * camp + 1) - camp;
      eff = max(basew + s_coff[s] + jit, 0);
    }
    const bool fail = s_failed[s];
    m_kind[m] = kind;
    m_key[m] = key;
    m_eff[m] = eff;
    m_app[m] = kind == KIND_APPEND && !fail;
    m_read[m] = kind == KIND_READ && !fail;
  }
  __syncthreads();

  // (3) per mop: its rank among its key's valid appends, by (eff, index)
  for (int m = threadIdx.x; m < M; m += THREADS) {
    const int key = m_key[m], eff = m_eff[m];
    int pos = 0;
    for (int k = 0; k < M; ++k)
      pos += m_app[k] && m_key[k] == key &&
             (m_eff[k] < eff || (m_eff[k] == eff && k < m));
    m_pos[m] = pos;
  }

  // (4) per (mop, node): the fault cascade, in fault-slot order
  for (int i = threadIdx.x; i < M * N; i += THREADS) {
    const int m = i / N, n = i % N;
    const int send = s_coord[m / L];
    int d = m_eff[m];
    if (!m_app[m]) {
      d = BIG;
    } else if (n != send) {
      for (int f = 0; f < F; ++f) {
        const int32_t* q = sched + 6 * f;
        const int fa = q[0];
        if (fa == 0) continue;
        const int mk = q[1], a0 = q[2] * L, a1 = q[3] * L, q0 = q[4],
                  q1 = q[5];
        const bool sb = (mk >> send) & 1, rb = (mk >> n) & 1;
        if (fa == PARTITION && (sb != rb) && a0 <= d && d < a1) d = a1;
        if (fa == PACKET && (sb || rb) && a0 <= d && d < a1) {
          const int32_t hd = hi(w, 170 + f, m, n);
          if (hd % 16 < q0) d += 1 + (hd >> 4) % max(q1 * L, 1);
        }
        if (fa == KILL && rb && a0 <= d && d < a1) d = a1;
        if (fa == PAUSE && rb && a0 <= d && d < a1) d = a1;
        if (fa == CORRUPT && rb && m_key[m] == q0 && a0 - q1 * L <= d &&
            d < a0)
          d = a0 + 1;
      }
    }
    deliv[i] = d;
  }
  __syncthreads();

  // (5) per mop: the read's prefix length, and the outputs
  const long long base = c * M;
  for (int m = threadIdx.x; m < M; m += THREADS) {
    int rlen = -1;
    if (m_read[m]) {
      const int key = m_key[m], eff = m_eff[m];
      const int at = s_coord[m / L];
      int minpos = BIG, total = 0;
      for (int k = 0; k < M; ++k) {
        if (!m_app[k] || m_key[k] != key) continue;
        ++total;
        const int d = deliv[k * N + at];
        const bool vis = d < eff || (d == eff && k < m);
        if (!vis) minpos = min(minpos, m_pos[k]);
      }
      rlen = min(minpos, total);
    }
    o_kind[base + m] = m_kind[m];
    o_key[base + m] = m_key[m];
    o_eff[base + m] = m_eff[m];
    o_pos[base + m] = m_app[m] ? m_pos[m] : -1;
    o_rlen[base + m] = rlen;
  }
  for (int s = threadIdx.x; s < St; s += THREADS) {
    o_coord[c * St + s] = s_coord[s];
    o_failed[c * St + s] = (uint8_t)s_failed[s];
  }
}

}  // namespace

extern "C" {

// scheds: [S, F, 6] int32; wseeds: [S] int32 (non-negative); outputs:
// coord [S, St] int32, failed [S, St] bool (one byte), kind/key/eff/pos/
// rlen [S, St, L] int32. smem: the block's dynamic shared bytes, which
// must equal the layout above (else cudaErrorInvalidValue).
int sim_launch(const void* scheds, const void* wseeds, int S, int N, int K,
               int T, int L, int F, int St, int audit_t0, void* coord,
               void* failed, void* kind, void* key, void* eff, void* pos,
               void* rlen, int smem, void* stream) {
  if (S <= 0) return 0;
  const int M = St * L;
  if (smem != 4 * (6 * F + 8 * St + 6 * M + M * N))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      sim_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  Spec sp{N, K, T, L, F, St, audit_t0};
  sim_kernel<<<S, THREADS, smem, (cudaStream_t)stream>>>(
      (const int32_t*)scheds, (const int32_t*)wseeds, sp, (int32_t*)coord,
      (uint8_t*)failed, (int32_t*)kind, (int32_t*)key, (int32_t*)eff,
      (int32_t*)pos, (int32_t*)rlen);
  return (int)cudaGetLastError();
}

}  // extern "C"
