// Boolean transitive closure by repeated squaring: the hand-written
// passes of the port's counterpart of K3, the JAX package's XLA closure
// engine (jepsen_tpu/ops/closure_tpu.py: _closure_packed :72,
// _closure_packed_word :98). Wrappers, plain PyTorch versions and the
// fixpoint loop are in ops/closure.py.
//
// A closure batch is a packed bit matrix [b, p, p/32]: p a power of two
// >= 32, bit k of word w of a row is column 32*w + k, words stored as
// int32 and read here as uint32. One round is R <- R | (R.R > 0). Byte
// j of the words (global byte index, little-endian within a word) is
// columns 8*(j % (p/8)) .. +7 of its row, and so the 16-byte chunk j of
// a bf16 [b, p, p] matrix: the operand and the product share the
// words' order chunk for chunk.
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
//                      Run once a bucket, before the first round. Bound
//                      by the bytes it writes (2*b*p*p).
//   or_threshold_pack  the threshold pass: the product,
//                      the old words and the operand the product has just
//                      read -> new words = old | pack(prod > 0), one
//                      device flag raised when any word changed (the
//                      counterpart of `jnp.all(nxt == words)`), and the
//                      operand refreshed in place: the 16-byte chunk of
//                      every byte that gained bits is rewritten from the
//                      new byte, and nothing else is written there, so
//                      the operand equals unpack(new words) and the next
//                      round needs no unpack. The closure only sets bits,
//                      so late rounds rewrite little and the round that
//                      observes the fixpoint rewrites nothing. Bound by
//                      the bytes it moves: 2*b*p*p of product read, the
//                      words read and written, 16 bytes a changed byte.
//
// Why closure_word's body stays as it is. A launch of it costs about
// what an empty kernel's launch costs on the H100 (0.0052 ms against
// 0.0047 ms, both behind a GPU spin), while its work is a nanosecond's
// worth of bytes and shuffles: one warp a matrix, a lane a row, at most
// six rounds of 32 __shfl_sync, which is already Hopper's natural shape
// for a 32 x 32 bit matrix and has nothing to gain from shared memory,
// tensor cores or TMA. What a faster body could save is below the launch
// floor. The cost is in how the kernel is fed: the cycle checker ran it
// once a caller, a few matrices at a time, each launch with its own
// pageable copies. So the launch was redesigned instead, in
// ops/closure.py (`_WordQueue`): concurrent callers' one-word buckets
// share one launch over their concatenated words, through one pinned
// copy each way. A matrix's fixpoint and its rounds depend on its own 32
// words alone, so a merged launch gives each caller what its own launch
// gave. The grid has one block of 8 warps for every 8 matrices ((b + 7)
// / 8 blocks, far below the 2^31 - 1 a grid may have for any int b), so
// a merged batch of any size keeps one warp a matrix.
//
// Design of unpack and the threshold pass for Hopper. A warp works on a
// tile of TILE_WORDS (32) words at a time = 128 chunks = 2 KB of bf16:
// lanes 0..7 bring the tile's words in as eight 16-byte loads and stage
// them in the warp's 128 bytes of shared memory; lane l takes chunks
// 32*k + l, k < TILE_LOADS, so each of a lane's TILE_LOADS 16-byte
// product loads (all issued before any is used) or operand stores is
// one coalesced 512-byte access of the warp, and the chunk's byte is
// byte 32*k + l of the staged tile (byte loads of 32 consecutive bytes:
// no bank conflict). The pass ORs its byte into the staged word in
// place and writes the operand chunk at the product chunk's offset only
// when the byte gained bits; lanes 0..7 then store the tile's new words
// as eight coalesced 16-byte stores. No shuffles, no atomics: one vote a
// warp for the flag at the end. The product is read and unpack's operand
// written with the streaming (evict-first) hint, __ldcs / __stcs: each
// of those bytes is touched once a launch, so they need not displace
// what L2 holds (it matters at [3, 4096], whose 100 MB product is twice
// L2, and not at [3, 16384], which streams either way). The grid is
// persistent: as many blocks as the SMs hold at once (132 x occupancy),
// each warp striding over the tiles, so a launch at [3, 4096] does not
// spend its ~30 µs of traffic ramping 2112 blocks up and down. A
// variant that staged the product in shared memory by cp.async.bulk (one
// producer thread, an mbarrier ring of 3 stages) reached a few per cent
// more of the bound at [3, 16384] and clearly less at [3, 4096], where
// its pipeline's fill and drain weigh on a ~40 µs launch, so the
// register design is the only one.
//
// Every launch goes on the caller's stream (the one torch.matmul uses)
// and returns cudaGetLastError(); nothing here allocates or syncs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
// 16-byte product loads (or operand stores) a lane keeps in flight
constexpr int TILE_LOADS = 4;
constexpr int TILE_CHUNKS = 32 * TILE_LOADS;   // = bytes of words a tile
constexpr int TILE_WORDS = TILE_CHUNKS / 4;
constexpr int TILE_VECS = TILE_WORDS / 4;      // 16-byte word loads a tile

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

// the 8 bf16 values of one byte of a word
__device__ __forceinline__ uint4 chunk_of(uint32_t byte) {
    return make_uint4(pair(byte, 0), pair(byte, 2), pair(byte, 4),
                      pair(byte, 6));
}

// bf16 bits h hold a value > 0 iff 0 < h <= 0x7F80 (+inf included, NaN
// and the negative half excluded): the comparison torch's `prod > 0`
// makes
__device__ __forceinline__ uint32_t positive(uint32_t x) {
    const uint32_t lo = x & 0xffffu, hi = x >> 16;
    return (uint32_t)(lo != 0u && lo <= 0x7F80u)
         | ((uint32_t)(hi != 0u && hi <= 0x7F80u) << 1);
}

// the byte of pack(prod > 0) that 8 bf16 values of the product make
__device__ __forceinline__ uint32_t byte_of(uint4 v) {
    return positive(v.x) | (positive(v.y) << 2) | (positive(v.z) << 4)
         | (positive(v.w) << 6);
}

// words: n_tiles * TILE_VECS; out: n_tiles * TILE_CHUNKS chunks
__global__ void __launch_bounds__(THREADS)
unpack_kernel(const uint4* __restrict__ words, uint4* __restrict__ out,
              long long n_tiles) {
    __shared__ uint4 stage[WARPS][TILE_VECS];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const unsigned char* bytes =
        reinterpret_cast<const unsigned char*>(stage[warp]);
    const long long step = (long long)gridDim.x * WARPS;
    for (long long t = (long long)blockIdx.x * WARPS + warp; t < n_tiles;
         t += step) {
        if (lane < TILE_VECS) stage[warp][lane] = words[t * TILE_VECS + lane];
        __syncwarp();
        uint4 c[TILE_LOADS];
#pragma unroll
        for (int k = 0; k < TILE_LOADS; ++k)
            c[k] = chunk_of(bytes[32 * k + lane]);
        __syncwarp();  // the next tile's words go where these were read
        uint4* dst = out + t * TILE_CHUNKS + lane;
#pragma unroll
        for (int k = 0; k < TILE_LOADS; ++k) __stcs(&dst[32 * k], c[k]);
    }
}

// prod, operand: n_tiles * TILE_CHUNKS chunks; words, out: n_tiles *
// TILE_VECS (out may alias words: a lane reads a 16-byte word vector
// before it writes the same one)
__global__ void __launch_bounds__(THREADS)
threshold_refresh_kernel(const uint4* __restrict__ prod, const uint4* words,
                         uint4* out, uint4* __restrict__ operand,
                         int32_t* __restrict__ flag, long long n_tiles) {
    __shared__ uint4 stage[WARPS][TILE_VECS];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    unsigned char* bytes = reinterpret_cast<unsigned char*>(stage[warp]);
    const long long step = (long long)gridDim.x * WARPS;
    bool changed = false;
    for (long long t = (long long)blockIdx.x * WARPS + warp; t < n_tiles;
         t += step) {
        const long long c0 = t * TILE_CHUNKS + lane;
        uint4 v[TILE_LOADS];
#pragma unroll
        for (int k = 0; k < TILE_LOADS; ++k) v[k] = __ldcs(&prod[c0 + 32 * k]);
        if (lane < TILE_VECS) stage[warp][lane] = words[t * TILE_VECS + lane];
        __syncwarp();
#pragma unroll
        for (int k = 0; k < TILE_LOADS; ++k) {
            const uint32_t old = bytes[32 * k + lane];
            const uint32_t m = byte_of(v[k]);
            if (m & ~old) {
                const uint32_t nxt = old | m;
                bytes[32 * k + lane] = (unsigned char)nxt;
                operand[c0 + 32 * k] = chunk_of(nxt);
                changed = true;
            }
        }
        __syncwarp();
        // a lane < TILE_VECS reads back only the vector it staged, so the
        // next tile may overwrite it without another barrier
        if (lane < TILE_VECS) out[t * TILE_VECS + lane] = stage[warp][lane];
    }
    if (__any_sync(FULL, changed) && lane == 0) *flag = 1;
}

// blocks of a persistent launch over n_tiles warp tiles, into *blocks:
// as many as the device's SMs hold at once, and no more than the tiles
// need; returns the error of the query that failed
template <typename K>
cudaError_t persistent_blocks(K kernel, long long n_tiles, int* blocks) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          THREADS, 0);
    if (e != cudaSuccess) return e;
    const long long cap = (long long)(sms < 1 ? 1 : sms)
                        * (per_sm < 1 ? 1 : per_sm);
    const long long want = (n_tiles + WARPS - 1) / WARPS;
    *blocks = (int)(want < cap ? want : cap);
    return cudaSuccess;
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

// words: n_words packed words, a multiple of 32 (16-byte aligned); out:
// 32 * n_words bf16 values (16-byte aligned)
int closure_unpack_launch(const void* words, void* out, long long n_words,
                          void* stream) {
    if (n_words <= 0) return 0;
    if (n_words % TILE_WORDS != 0) return (int)cudaErrorInvalidValue;
    const long long n_tiles = n_words / TILE_WORDS;
    int blocks = 0;
    const cudaError_t e = persistent_blocks(unpack_kernel, n_tiles, &blocks);
    if (e != cudaSuccess) return (int)e;
    unpack_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const uint4*)words, (uint4*)out, n_tiles);
    return (int)cudaGetLastError();
}

// prod: 32 * n_words bf16 values; words, out: n_words (out may alias
// words), a multiple of 32; flag: one int32, set to 1 if any word changed
// and otherwise left as it was; operand: 32 * n_words bf16 values, the
// matrix the product read, refreshed in place to unpack(out) (required:
// NULL is cudaErrorInvalidValue). Every pointer but flag 16-byte
// aligned.
int closure_or_threshold_pack_launch(const void* prod, const void* words,
                                     void* out, void* flag, void* operand,
                                     long long n_words, void* stream) {
    if (n_words <= 0) return 0;
    if (n_words % TILE_WORDS != 0 || operand == nullptr)
        return (int)cudaErrorInvalidValue;
    const long long n_tiles = n_words / TILE_WORDS;
    int blocks = 0;
    const cudaError_t e =
        persistent_blocks(threshold_refresh_kernel, n_tiles, &blocks);
    if (e != cudaSuccess) return (int)e;
    threshold_refresh_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const uint4*)prod, (const uint4*)words, (uint4*)out,
        (uint4*)operand, (int32_t*)flag, n_tiles);
    return (int)cudaGetLastError();
}

}  // extern "C"
