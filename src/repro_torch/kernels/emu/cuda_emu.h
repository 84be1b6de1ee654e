// CPU emulation of the small CUDA subset the port's kernels use, so their
// sources can be compiled by a host C++20 compiler and run on CPU tensors
// (tests/test_torch_kernels_emulated.py):
//
//   g++ -std=c++20 -O1 -shared -fPIC -x c++ -I<this dir> \
//       -include cuda_emu.h <kernel>.cu -o lib<kernel>_emu.so -lpthread
//
// Every CUDA thread of a block is a std::thread and blocks run one after
// another: __syncthreads is a std::barrier over the block, warp shuffles
// exchange through a per-warp buffer between two warp barriers, dynamic
// shared memory is a per-block buffer filled with a poison byte. Device
// pointers are host pointers. The kernel sources opt in through two hooks
// (LAUNCH and dyn_smem, defined here when CPU_EMULATION is set). It checks
// indexing, masking and synchronisation logic; it says nothing about speed
// or about what nvcc accepts.
#pragma once
#define CPU_EMULATION 1
#include <atomic>
#include <barrier>
#include <cmath>
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
#define __align__(x)

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
typedef int cudaError_t;
constexpr int cudaSuccess = 0;
typedef void* cudaStream_t;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class F>
inline cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) {
  return 0;
}
inline cudaError_t cudaGetLastError() { return 0; }

struct alignas(16) float4 { float x, y, z, w; };
struct alignas(8) float2 { float x, y; };
inline float4 make_float4(float x, float y, float z, float w) {
  return float4{x, y, z, w};
}

// IEEE single operations rounded one by one (the host compiler, in ISO
// C++ mode, does not contract them)
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }

struct __nv_bfloat16 { uint16_t x; };
inline float __bfloat162float(__nv_bfloat16 b) {
  uint32_t u = (uint32_t)b.x << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline __nv_bfloat16 __float2bfloat16(float f) {  // round to nearest even
  uint32_t u;
  std::memcpy(&u, &f, 4);
  uint32_t r = 0x7fff + ((u >> 16) & 1);
  __nv_bfloat16 b;
  b.x = (uint16_t)((u + r) >> 16);
  return b;
}

struct EmuBlock {
  std::unique_ptr<std::barrier<>> bar;
  std::vector<std::unique_ptr<std::barrier<>>> wbar;
  std::vector<float> shfl;
  std::atomic<int> orv{0};
  std::vector<unsigned char> smem;
};
inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;
inline thread_local EmuBlock* emu_cur;

inline unsigned char* dyn_smem() { return emu_cur->smem.data(); }
inline void __syncthreads() { emu_cur->bar->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) {
  emu_cur->wbar[threadIdx.x / 32]->arrive_and_wait();
}
inline int __syncthreads_or(int p) {
  EmuBlock& B = *emu_cur;
  if (p) B.orv.fetch_or(1);
  B.bar->arrive_and_wait();
  int r = B.orv.load();
  B.bar->arrive_and_wait();
  if (threadIdx.x == 0) B.orv.store(0);
  B.bar->arrive_and_wait();
  return r;
}
inline float __shfl_xor_sync(unsigned, float v, int m) {
  EmuBlock& B = *emu_cur;
  int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  B.shfl[threadIdx.x] = v;
  B.wbar[w]->arrive_and_wait();
  float r = B.shfl[w * 32 + (lane ^ m)];
  B.wbar[w]->arrive_and_wait();
  return r;
}

template <class... A>
struct EmuLauncher {
  void (*k)(A...);
  dim3 g, b;
  size_t sm;
  void operator()(A... args) {
    gridDim = g;
    blockDim = b;
    for (unsigned z = 0; z < g.z; ++z)
      for (unsigned y = 0; y < g.y; ++y)
        for (unsigned x = 0; x < g.x; ++x) {
          EmuBlock blk;
          blk.bar = std::make_unique<std::barrier<>>(b.x);
          for (unsigned w = 0; w < (b.x + 31) / 32; ++w)
            blk.wbar.push_back(std::make_unique<std::barrier<>>(32));
          blk.shfl.assign(b.x, 0.f);
          blk.smem.assign(sm + 16, 0xAB);
          std::vector<std::thread> ts;
          for (unsigned t = 0; t < b.x; ++t)
            ts.emplace_back([&, t] {
              threadIdx = dim3(t);
              blockIdx = dim3(x, y, z);
              emu_cur = &blk;
              k(args...);
            });
          for (auto& th : ts) th.join();
        }
  }
};
template <class... A>
EmuLauncher<A...> emu_launch(void (*k)(A...), dim3 g, dim3 b, size_t sm) {
  return EmuLauncher<A...>{k, g, b, sm};
}
#define LAUNCH(kernel, grid, block, smem, stream) \
  emu_launch(kernel, grid, block, smem)
