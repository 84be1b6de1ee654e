// CPU emulation of the small CUDA subset the port's kernels use, so their
// sources can be compiled by a host C++20 compiler and run on CPU tensors
// (tests/test_torch_kernels_emulated.py):
//
//   g++ -std=c++20 -O1 -shared -fPIC -x c++ -I<this dir> \
//       -include cuda_emu.h <kernel>.cu -o lib<kernel>_emu.so -lpthread
//
// Every CUDA thread of a block is a std::thread and blocks run one after
// another: __syncthreads is a std::barrier over the block, warp shuffles
// exchange through a per-warp buffer between two warp barriers (xor for
// float, up for double), dynamic shared memory is a per-block buffer
// filled with 0xFF bytes (a NaN in fp32 and bf16, so a read of a byte
// nothing wrote shows). Device pointers are host pointers. The kernel
// sources opt in through hooks defined here when CPU_EMULATION is set and
// as inline PTX otherwise: LAUNCH and dyn_smem, and for the chunk,
// decode and SSD kernels cp_async_cg16 /
// cp_async_ca4 / cp_async_commit / cp_async_wait (a 16- or 4-byte copy
// or zero fill that lands at the issuing thread's wait for its group),
// ldmatrix x4 (plain and .trans) and the two
// mma.sync shapes (each lane writes its
// fragments into a per-warp buffer, then computes its own outputs by the
// PTX ISA's fragment layouts, between two warp barriers). It checks
// indexing, masking, fragment and synchronisation logic; it says nothing
// about speed or about what nvcc accepts.
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
#define __launch_bounds__(...)
#define __align__(x)

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
typedef int cudaError_t;
constexpr int cudaSuccess = 0;
constexpr int cudaErrorInvalidValue = 1;
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
inline float2 make_float2(float x, float y) { return float2{x, y}; }

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
inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  return __float2bfloat16(f);
}

struct EmuBlock {
  std::unique_ptr<std::barrier<>> bar;
  std::vector<std::unique_ptr<std::barrier<>>> wbar;
  std::vector<float> shfl;
  std::vector<double> shfld;
  std::vector<uint32_t> frag;   // per lane: mma A (4) and B (2) registers
  std::vector<const void*> rowp;   // per lane: ldmatrix row address
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

// lane l gets v of lane l - d (its own v where l < d)
inline double __shfl_up_sync(unsigned, double v, int d) {
  EmuBlock& B = *emu_cur;
  int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  B.shfld[threadIdx.x] = v;
  B.wbar[w]->arrive_and_wait();
  double r = lane >= d ? B.shfld[w * 32 + lane - d] : v;
  B.wbar[w]->arrive_and_wait();
  return r;
}

inline float __uint_as_float(uint32_t u) {
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline uint32_t __float_as_uint(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  return u;
}
inline unsigned short __bfloat16_as_ushort(__nv_bfloat16 b) { return b.x; }

// cp.async.cg 16 bytes / cp.async.ca 4 bytes (zero fill when !pred).
// The source is read when the copy is issued, and the bytes land in
// shared memory only when the issuing thread's cp.async.wait_group lets
// its group complete: the latest moment the hardware may complete them,
// so a read of a stage before its wait (and its barrier) sees the
// poison, not the data. Groups a thread never waits for never land.
struct EmuCopy {
  void* dst;
  unsigned char bytes[16];
  int n;
};
inline thread_local std::vector<std::vector<EmuCopy>> emu_groups;
inline thread_local std::vector<EmuCopy> emu_open;
inline void emu_cp_async(void* dst, const void* src, int n, bool pred) {
  EmuCopy c{dst, {}, n};
  if (pred)
    std::memcpy(c.bytes, src, n);
  else
    std::memset(c.bytes, 0, n);
  emu_open.push_back(c);
}
inline void cp_async_cg16(void* dst, const void* src, bool pred) {
  emu_cp_async(dst, src, 16, pred);
}
inline void cp_async_ca4(void* dst, const void* src, bool pred) {
  emu_cp_async(dst, src, 4, pred);
}
inline void cp_async_commit() {
  emu_groups.push_back(std::move(emu_open));
  emu_open.clear();
}
// all but the N most recently committed groups land
template <int N>
inline void cp_async_wait() {
  while ((int)emu_groups.size() > N) {
    for (const EmuCopy& c : emu_groups.front())
      std::memcpy(c.dst, c.bytes, c.n);
    emu_groups.erase(emu_groups.begin());
  }
}

// mma.sync.aligned.m16n8k{8,16}.row.col.f32.{tf32,bf16}: element (row, k)
// of A and (k, col) of B read from the lanes that hold them in the PTX
// ISA's fragment layouts (groupID = lane / 4, threadID_in_group = lane % 4)
inline float emu_bf16_half(uint32_t reg, int half) {
  __nv_bfloat16 h;
  h.x = (uint16_t)(half ? reg >> 16 : reg & 0xffffu);
  return __bfloat162float(h);
}
inline void emu_mma(float* d, const uint32_t* a, const uint32_t* b,
                    bool bf16) {
  EmuBlock& B = *emu_cur;
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  uint32_t* mine = &B.frag[6 * threadIdx.x];
  for (int i = 0; i < 4; ++i) mine[i] = a[i];
  mine[4] = b[0];
  mine[5] = b[1];
  B.wbar[w]->arrive_and_wait();
  const uint32_t* f = &B.frag[6 * 32 * w];
  const int K = bf16 ? 16 : 8;
  for (int e = 0; e < 4; ++e) {
    const int row = lane / 4 + 8 * (e / 2), col = 2 * (lane % 4) + e % 2;
    float acc = d[e];
    for (int k = 0; k < K; ++k) {
      float x, y;
      if (bf16) {
        // A: a0 (g, 2t..2t+1), a1 (g+8, ..), a2 (g, 2t+8..), a3 (g+8, ..)
        // B: b0 (k 2t..2t+1, n g), b1 (k 2t+8.., n g); low half = lower k
        x = emu_bf16_half(
            f[6 * ((row % 8) * 4 + (k % 8) / 2) + (row / 8) + 2 * (k / 8)],
            k % 2);
        y = emu_bf16_half(f[6 * (col * 4 + (k % 8) / 2) + 4 + k / 8], k % 2);
      } else {
        // A: a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4)
        // B: b0 (k t, n g), b1 (k t+4, n g)
        x = __uint_as_float(
            f[6 * ((row % 8) * 4 + k % 4) + (row / 8) + 2 * (k / 4)]);
        y = __uint_as_float(f[6 * (col * 4 + k % 4) + 4 + k / 4]);
      }
      acc += x * y;
    }
    d[e] = acc;
  }
  B.wbar[w]->arrive_and_wait();
}
// ldmatrix.sync.aligned.m8n8.x4[.trans].shared.b16: lane i gives the
// address of row i % 8 of matrix i / 8 (8 contiguous b16); lane l gets,
// per matrix j, elements (l / 4, 2 (l % 4) .. +1), or with .trans
// (2 (l % 4) .. +1, l / 4); the lower column / row in the low half
inline void emu_ldmatrix(uint32_t* r, const void* row, bool trans) {
  EmuBlock& B = *emu_cur;
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  B.rowp[threadIdx.x] = row;
  B.wbar[w]->arrive_and_wait();
  const void* const* rows = &B.rowp[32 * w];
  for (int j = 0; j < 4; ++j) {
    uint16_t lo, hi;
    if (trans) {
      const int rr = 8 * j + 2 * (lane % 4);
      std::memcpy(&lo, (const uint16_t*)rows[rr] + lane / 4, 2);
      std::memcpy(&hi, (const uint16_t*)rows[rr + 1] + lane / 4, 2);
    } else {
      const uint16_t* p = (const uint16_t*)rows[8 * j + lane / 4];
      std::memcpy(&lo, p + 2 * (lane % 4), 2);
      std::memcpy(&hi, p + 2 * (lane % 4) + 1, 2);
    }
    r[j] = (uint32_t)lo | ((uint32_t)hi << 16);
  }
  B.wbar[w]->arrive_and_wait();
}
inline void ldmatrix_x4(uint32_t* r, const void* row) {
  emu_ldmatrix(r, row, false);
}
inline void ldmatrix_x4_trans(uint32_t* r, const void* row) {
  emu_ldmatrix(r, row, true);
}
inline void mma_m16n8k8_tf32(float* d, const uint32_t* a, const uint32_t* b) {
  emu_mma(d, a, b, false);
}
inline void mma_m16n8k16_bf16(float* d, const uint32_t* a,
                              const uint32_t* b) {
  emu_mma(d, a, b, true);
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
          blk.shfld.assign(b.x, 0.0);
          blk.frag.assign(6 * b.x, 0u);
          blk.rowp.assign(b.x, nullptr);
          blk.smem.assign(sm + 16, 0xFF);
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
