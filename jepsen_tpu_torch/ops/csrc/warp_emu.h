// A host emulation of the CUDA features wgl_search.cu uses, so that the
// kernel's own source can run on a CPU against the plain PyTorch version
// (tests/test_torch_wgl_search_emu.py): one std::thread a CUDA thread, one
// std::barrier a warp, the blocks of a launch one after another, a block's
// dynamic shared memory one static buffer filled with garbage before each
// block. The test rewrites the source's `extern __shared__` declaration to
// `g_smem` and its `<<<...>>>` launch to `emu_launch`, then compiles it with
// g++ -std=c++20 against this header.
#pragma once
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
#define __shared__
#define __align__(n)

struct emu_dim3 {
  unsigned x, y, z;
};
inline thread_local emu_dim3 threadIdx, blockIdx;

typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };

// the H100's opt-in limit of dynamic shared memory a block
constexpr int EMU_SMEM_OPTIN = 232448;
alignas(16) inline unsigned char g_smem[EMU_SMEM_OPTIN];

struct EmuWarp {
  std::barrier<> bar{32};
  bool votes[32];
};
inline thread_local EmuWarp* emu_warp;

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
inline void __syncwarp() { emu_warp->bar.arrive_and_wait(); }
inline int __ffs(unsigned x) { return __builtin_ffs((int)x); }

template <typename F>
cudaError_t cudaFuncSetAttribute(F, int, int bytes) {
  return bytes > EMU_SMEM_OPTIN ? cudaErrorInvalidValue : cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }

template <typename K, typename P>
void emu_launch(K kernel, int blocks, int threads, int smem_bytes, P p) {
  for (int b = 0; b < blocks; ++b) {
    std::memset(g_smem, 0xA5, smem_bytes);  // shared memory starts unset
    std::vector<std::unique_ptr<EmuWarp>> warps;
    for (int i = 0; i < threads / 32; ++i) warps.emplace_back(new EmuWarp());
    std::vector<std::thread> ts;
    for (int t = 0; t < threads; ++t)
      ts.emplace_back([&, t] {
        threadIdx = {(unsigned)t, 0, 0};
        blockIdx = {(unsigned)b, 0, 0};
        emu_warp = warps[t / 32].get();
        kernel(p);
      });
    for (auto& th : ts) th.join();
  }
}
