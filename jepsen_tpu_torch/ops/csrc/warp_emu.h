// A host emulation of the CUDA features wgl_search.cu, closure.cu and
// sim.cu use, so that a kernel's own source can run on a CPU against the
// plain PyTorch version (tests/test_torch_wgl_search_emu.py,
// tests/test_torch_closure_emu.py, tests/test_torch_sim_emu.py): one
// std::thread a CUDA thread, one std::barrier a warp and one a block
// (__syncthreads), the blocks of a launch one after another, a block's
// dynamic shared memory one static buffer filled with garbage before each
// block, and a kernel's static `__shared__` arrays function statics (one
// copy, which the blocks, run one at a time, share in turn). A test
// rewrites the source's `extern __shared__` declaration to `g_smem` and
// each `<<<...>>>` launch to `emu_launch(kernel, blocks, threads, smem,
// args...)`, then compiles it with g++ -std=c++20 against this header.
#pragma once
#include <algorithm>
#include <barrier>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __shared__ static
#define __align__(n)

struct emu_dim3 {
  unsigned x, y, z;
};
inline thread_local emu_dim3 threadIdx, blockIdx, blockDim, gridDim;

struct alignas(16) uint4 {
  unsigned x, y, z, w;
};
inline uint4 make_uint4(unsigned x, unsigned y, unsigned z, unsigned w) {
  return {x, y, z, w};
}
struct alignas(16) int4 {
  int x, y, z, w;
};
inline int4 make_int4(int x, int y, int z, int w) { return {x, y, z, w}; }
using std::max;
using std::min;

typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
enum { cudaDevAttrMultiProcessorCount = 16 };

// an emulated device of EMU_SMS SMs that hold one block each, so that a
// persistent grid is small and its warps stride over several tiles
constexpr int EMU_SMS = 2;

// the H100's opt-in limit of dynamic shared memory a block
constexpr int EMU_SMEM_OPTIN = 232448;
alignas(16) inline unsigned char g_smem[EMU_SMEM_OPTIN];

struct EmuWarp {
  std::barrier<> bar{32};
  bool votes[32];
  unsigned vals[32];
};
inline thread_local EmuWarp* emu_warp;
inline thread_local std::barrier<>* emu_block;

inline void __syncthreads() { emu_block->arrive_and_wait(); }
inline int atomicAdd(int* p, int v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}
inline int __popc(unsigned x) { return __builtin_popcount(x); }

inline unsigned __ballot_sync(unsigned, bool pred) {
  EmuWarp* w = emu_warp;
  w->votes[threadIdx.x & 31] = pred;
  w->bar.arrive_and_wait();
  unsigned r = 0;
  for (int i = 0; i < 32; ++i) r |= (w->votes[i] ? 1u : 0u) << i;
  w->bar.arrive_and_wait();
  return r;
}
inline bool __all_sync(unsigned m, bool pred) {
  return __ballot_sync(m, pred) == 0xFFFFFFFFu;
}
inline bool __any_sync(unsigned m, bool pred) {
  return __ballot_sync(m, pred) != 0u;
}
inline unsigned emu_exchange(unsigned v, int src) {
  EmuWarp* w = emu_warp;
  w->vals[threadIdx.x & 31] = v;
  w->bar.arrive_and_wait();
  const unsigned r = w->vals[src & 31];
  w->bar.arrive_and_wait();
  return r;
}
inline unsigned __shfl_sync(unsigned, unsigned v, int src) {
  return emu_exchange(v, src);
}
inline unsigned __shfl_xor_sync(unsigned, unsigned v, int mask) {
  return emu_exchange(v, (int)(threadIdx.x & 31) ^ mask);
}
inline unsigned __shfl_up_sync(unsigned, unsigned v, int delta) {
  const int lane = threadIdx.x & 31;
  return emu_exchange(v, lane >= delta ? lane - delta : lane);
}
inline void __syncwarp() { emu_warp->bar.arrive_and_wait(); }
// cache hints: plain loads and stores on the host
template <typename T>
T __ldcs(const T* p) {
  return *p;
}
template <typename T>
void __stcs(T* p, T v) {
  *p = v;
}
inline int __ffs(unsigned x) { return __builtin_ffs((int)x); }

template <typename F>
cudaError_t cudaFuncSetAttribute(F, int, int bytes) {
  return bytes > EMU_SMEM_OPTIN ? cudaErrorInvalidValue : cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline cudaError_t cudaGetDevice(int* dev) {
  *dev = 0;
  return cudaSuccess;
}
inline cudaError_t cudaDeviceGetAttribute(int* v, int attr, int) {
  if (attr != cudaDevAttrMultiProcessorCount) return cudaErrorInvalidValue;
  *v = EMU_SMS;
  return cudaSuccess;
}
template <typename F>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int,
                                                          size_t) {
  *n = 1;
  return cudaSuccess;
}

template <typename K, typename... A>
void emu_launch(K kernel, int blocks, int threads, int smem_bytes,
                A... args) {
  for (int b = 0; b < blocks; ++b) {
    std::memset(g_smem, 0xA5, smem_bytes);  // shared memory starts unset
    std::vector<std::unique_ptr<EmuWarp>> warps;
    for (int i = 0; i < threads / 32; ++i) warps.emplace_back(new EmuWarp());
    std::barrier<> block(threads);
    std::vector<std::thread> ts;
    for (int t = 0; t < threads; ++t)
      ts.emplace_back([&, t] {
        threadIdx = {(unsigned)t, 0, 0};
        blockIdx = {(unsigned)b, 0, 0};
        blockDim = {(unsigned)threads, 1, 1};
        gridDim = {(unsigned)blocks, 1, 1};
        emu_warp = warps[t / 32].get();
        emu_block = &block;
        kernel(args...);
      });
    for (auto& th : ts) th.join();
  }
}
