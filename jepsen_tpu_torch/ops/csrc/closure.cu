// Boolean transitive closure by repeated squaring: the hand-written
// passes of the port's counterpart of K3, the JAX package's XLA closure
// engine (jepsen_tpu/ops/closure_tpu.py: _closure_packed :72,
// _closure_packed_word :98). Wrappers, plain PyTorch versions and the
// fixpoint loop are in ops/closure.py.
//
// A closure batch is a packed bit matrix [b, p, p/32]: p a power of two
// >= 32, bit k of word w of a row is column 32*w + k, words stored as
// int32 and read here as uint32. One round is R <- R | (R.R > 0):
//
//   closure_word       the p == 32 bucket's whole fixpoint in one launch:
//                      one warp per matrix, lane i holding row i as one
//                      word; a round ORs into row i the rows that its set
//                      bits select (fetched by __shfl_sync), and
//                      __all_sync on "unchanged" ends the loop (at most
//                      `rounds` rounds). No float round trip, no host
//                      sync. Bound: reading and writing b*32 words, a few
//                      microseconds at any batch this path sees.
//   unpack             packed words -> a 0/1 bf16 [b, p, p] operand for
//                      the product (torch.matmul, outside this file).
//                      Bound by the bytes it writes (2*b*p*p); a thread
//                      turns one byte of a word into 8 bf16 values, one
//                      16-byte store, so a warp writes 512 contiguous
//                      bytes an instruction.
//   or_threshold_pack  the product and the old words -> new words
//                      = old | (prod > 0), packed, and one device flag
//                      raised when any word changed (the counterpart of
//                      `jnp.all(nxt == words)`). Bound by the bytes it
//                      reads (2*b*p*p); a thread reads 8 bf16 values in
//                      one 16-byte load and makes one byte, and four
//                      neighbouring lanes OR their bytes into a word.
//
// Every launch goes on the caller's stream (the one torch.matmul uses)
// and returns cudaGetLastError(); nothing here allocates or syncs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 132 * 16;

__global__ void closure_word_kernel(const uint32_t* __restrict__ in,
                                    uint32_t* __restrict__ out,
                                    int32_t* __restrict__ taken,
                                    int b, int rounds) {
    const int lane = threadIdx.x & 31;
    const int g = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
    if (g >= b) return;  // the whole warp leaves together
    uint32_t row = in[(size_t)g * 32 + lane];
    int t = 0;
    while (t < rounds) {
        uint32_t prod = 0;
#pragma unroll
        for (int k = 0; k < 32; ++k) {
            const uint32_t rk = __shfl_sync(FULL, row, k);
            if ((row >> k) & 1u) prod |= rk;
        }
        const uint32_t nxt = row | prod;
        const bool same = __all_sync(FULL, nxt == row);
        row = nxt;
        ++t;
        if (same) break;
    }
    out[(size_t)g * 32 + lane] = row;
    if (lane == 0) taken[g] = t;
}

// bf16 1.0 is 0x3F80; two bf16 values per uint32, the lower column in
// the low half
__device__ __forceinline__ uint32_t pair(uint32_t byte, int k) {
    return (((byte >> k) & 1u) ? 0x3F80u : 0u)
         | (((byte >> (k + 1)) & 1u) ? 0x3F800000u : 0u);
}

__global__ void unpack_kernel(const uint32_t* __restrict__ words,
                              uint4* __restrict__ out, long long n_bytes) {
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < n_bytes; i += stride) {
        const uint32_t byte = (words[i >> 2] >> (8 * (i & 3))) & 0xffu;
        out[i] = make_uint4(pair(byte, 0), pair(byte, 2), pair(byte, 4),
                            pair(byte, 6));
    }
}

// bf16 bits h hold a value > 0 iff 0 < h <= 0x7F80 (+inf included, NaN
// and the negative half excluded): the comparison torch's `prod > 0`
// makes
__device__ __forceinline__ uint32_t positive(uint32_t x) {
    const uint32_t lo = x & 0xffffu, hi = x >> 16;
    return (uint32_t)(lo != 0u && lo <= 0x7F80u)
         | ((uint32_t)(hi != 0u && hi <= 0x7F80u) << 1);
}

// n_bytes is a multiple of 32 (the wrapper checks), and the grid-stride
// loop's start and stride are too, so the lanes of a warp run the loop
// the same number of times and every shuffle has all 32
__global__ void or_threshold_pack_kernel(const uint4* __restrict__ prod,
                                         const uint32_t* words,
                                         uint32_t* out,
                                         int32_t* __restrict__ flag,
                                         long long n_bytes) {
    const long long stride = (long long)gridDim.x * blockDim.x;
    const int q = threadIdx.x & 3;
    bool changed = false;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < n_bytes; i += stride) {
        const uint4 v = prod[i];
        uint32_t m = positive(v.x) | (positive(v.y) << 2)
                   | (positive(v.z) << 4) | (positive(v.w) << 6);
        m <<= 8 * q;
        m |= __shfl_xor_sync(FULL, m, 1);
        m |= __shfl_xor_sync(FULL, m, 2);
        if (q == 0) {
            const uint32_t old = words[i >> 2];
            const uint32_t nxt = old | m;
            out[i >> 2] = nxt;
            changed |= nxt != old;
        }
    }
    if (__any_sync(FULL, changed) && (threadIdx.x & 31) == 0) *flag = 1;
}

int blocks_for(long long n) {
    const long long b = (n + THREADS - 1) / THREADS;
    return (int)(b < MAX_BLOCKS ? (b < 1 ? 1 : b) : MAX_BLOCKS);
}

}  // namespace

extern "C" {

// in, out: [b, 32] words (may alias); taken: [b] rounds each matrix ran
int closure_word_launch(const void* in, void* out, void* taken, int b,
                        int rounds, void* stream) {
    if (b <= 0) return 0;
    const int warps = THREADS / 32;
    closure_word_kernel<<<(b + warps - 1) / warps, THREADS, 0,
                          (cudaStream_t)stream>>>(
        (const uint32_t*)in, (uint32_t*)out, (int32_t*)taken, b, rounds);
    return (int)cudaGetLastError();
}

// words: n_words packed words; out: 32 * n_words bf16 values (16-byte
// aligned)
int closure_unpack_launch(const void* words, void* out, long long n_words,
                          void* stream) {
    const long long n_bytes = 4 * n_words;
    if (n_bytes <= 0) return 0;
    unpack_kernel<<<blocks_for(n_bytes), THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)words, (uint4*)out, n_bytes);
    return (int)cudaGetLastError();
}

// prod: 32 * n_words bf16 values (16-byte aligned); words, out: n_words
// (out may alias words); flag: one int32, set to 1 if any word changed
// and otherwise left as it was
int closure_or_threshold_pack_launch(const void* prod, const void* words,
                                     void* out, void* flag,
                                     long long n_words, void* stream) {
    const long long n_bytes = 4 * n_words;
    if (n_bytes <= 0) return 0;
    if (n_bytes % 32 != 0) return (int)cudaErrorInvalidValue;
    or_threshold_pack_kernel<<<blocks_for(n_bytes), THREADS, 0,
                               (cudaStream_t)stream>>>(
        (const uint4*)prod, (const uint32_t*)words, (uint32_t*)out,
        (int32_t*)flag, n_bytes);
    return (int)cudaGetLastError();
}

}  // extern "C"
