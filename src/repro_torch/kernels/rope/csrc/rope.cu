// Rotary position embedding, applied or removed, for Hopper (sm_90a).
//
// Replaces the TPU kernel rope_pallas (src/repro/kernels/rope/kernel.py:38,
// body _kernel at :23), the counterpart of the paper's custom kernel for
// §4 "RPE Management": chunk-caches keep K un-rotated in the store and
// rotate it at the chunk's new position when it is reused.
//
// What it computes, for x [T, H, D] (fp32 or bf16) and pos [P] (int32),
// with half = D / 2, row t reading pos[t % P] (P = T, or the length of one
// batch row's positions when a batch shares them), i < half:
//   ang        = (float)pos[t % P] * inv_freq[i]
//   out[.., i]        = x1 * cos(ang) - x2 * s
//   out[.., half + i] = x1 * s + x2 * cos(ang)
// with x1 = x[.., i], x2 = x[.., half + i] and s = sin(ang), negated when
// `inverse` (rotation by -ang removes the embedding). Arithmetic in fp32,
// the output rounded to x's type.
//
// inv_freq holds the D/2 fp32 frequencies exactly as the plain version
// computes them (models/layers.py _inv_freq, the reference's expression);
// the TPU kernel rebuilt them as exp(-2 ln(theta) i / D), which differs by
// ulps that |pos| amplifies to ~1e-3 rad. Here the angle is the plain
// version's own fp32 product, the cos / sin are the full-precision cosf /
// sinf (no fast-math intrinsics; build.py does not pass --use_fast_math),
// and the products and sums are rounded one by one (__fmul_rn and friends,
// so nvcc does not contract them into FMAs) as the plain version's
// separate PyTorch ops round them. Each output element depends only on its
// own x pair, position and frequency, so one call over [L, n, H, D] and L
// calls over [1, n, H, D] give the same bytes (the executor's streamed ==
// eager contract).
//
// What bounds it on the H100: it reads x once and writes out once, with a
// few dozen flops per pair (two cos/sin evaluations): memory, 2 * T * H *
// D * sizeof(x) bytes over 3.35 TB/s. What the design does about that: one
// thread per VEC (4) consecutive frequency indices of one (t, h) row, so
// a warp reads and writes contiguous 16-byte (fp32) or 8-byte (bf16)
// vectors of both halves; the angles are computed in registers, no cos /
// sin table is read. No shared memory, no synchronisation.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#ifndef CPU_EMULATION
#define LAUNCH(kernel, grid, block, smem, stream) \
  kernel<<<grid, block, smem, stream>>>
#endif

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// VEC elements of T moved as one aligned load / store
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

struct RopeParams {
  const void* x;
  const int* pos;
  const float* inv_freq;
  void* out;
  long long rows;  // T * H
  int H, half, P, inverse;
};

template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS) rope_kernel(RopeParams p) {
  const int nvec = p.half / VEC;
  const long long g = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (g >= p.rows * nvec) return;
  const long long row = g / nvec;             // t * H + h
  const int i0 = (int)(g - row * nvec) * VEC;
  const int t = (int)(row / p.H);
  const float fp = (float)p.pos[t % p.P];
  const long long base = row * 2 * p.half + i0;
  const T* x = static_cast<const T*>(p.x);
  T* out = static_cast<T*>(p.out);
  const Pack<T, VEC> a = *reinterpret_cast<const Pack<T, VEC>*>(x + base);
  const Pack<T, VEC> b =
      *reinterpret_cast<const Pack<T, VEC>*>(x + base + p.half);
  Pack<T, VEC> oa, ob;
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const float ang = __fmul_rn(fp, p.inv_freq[i0 + j]);
    const float c = cosf(ang);
    const float s = p.inverse ? -sinf(ang) : sinf(ang);
    const float x1 = to_f(a.v[j]), x2 = to_f(b.v[j]);
    oa.v[j] = from_f<T>(__fsub_rn(__fmul_rn(x1, c), __fmul_rn(x2, s)));
    ob.v[j] = from_f<T>(__fadd_rn(__fmul_rn(x1, s), __fmul_rn(x2, c)));
  }
  *reinterpret_cast<Pack<T, VEC>*>(out + base) = oa;
  *reinterpret_cast<Pack<T, VEC>*>(out + base + p.half) = ob;
}

template <typename T>
int launch(const RopeParams& p, cudaStream_t stream) {
  // 4-wide vectors when both halves start on a 4-element boundary
  const int vec = (p.half % 4 == 0) ? 4 : 1;
  const long long threads = p.rows * (p.half / vec);
  if (threads == 0) return 0;
  const dim3 grid((unsigned)((threads + THREADS - 1) / THREADS));
  void (*kern)(RopeParams) =
      vec == 4 ? &rope_kernel<T, 4> : &rope_kernel<T, 1>;
  LAUNCH(kern, grid, dim3(THREADS), 0, stream)(p);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes): device pointers; x and out
// [nT, H, D] of one type (is_bf16: bf16 (1) or fp32 (0)), pos [P] int32,
// inv_freq [D / 2] fp32. Returns the cudaError_t.
extern "C" int rope_fwd(const void* x, const void* pos, const void* inv_freq,
                        void* out, int nT, int H, int D, int P, int inverse,
                        int is_bf16, void* stream) {
  RopeParams p;
  p.x = x;
  p.pos = static_cast<const int*>(pos);
  p.inv_freq = static_cast<const float*>(inv_freq);
  p.out = out;
  p.rows = (long long)nT * H;
  p.H = H;
  p.half = D / 2;
  p.P = P;
  p.inverse = inverse;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(p, st) : launch<float>(p, st);
}
