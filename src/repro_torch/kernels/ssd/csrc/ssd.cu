// Mamba2 SSD intra-chunk block for Hopper (sm_90a).
//
// Replaces the TPU kernel ssd_intra_pallas
// (src/repro/kernels/ssd/kernel.py:51, body _kernel at :22).
//
// What it computes, per chunk c and head h, with seg_ij = sum of
// log_a[c, k, h] over j < k <= i (the log-decay from step j to step i):
//   y[c,i,h,:]     = sum_{j<=i} exp(seg_ij) (C[c,i,:] . B[c,j,:])
//                                * xdt[c,j,h,:]
//   state[c,h,p,n] = sum_l exp(seg_{L-1,l}) B[c,l,n] xdt[c,l,h,p]
// Inputs fp32 or bf16 (all four of one type), arithmetic and outputs fp32.
// The inter-chunk recurrence stays in PyTorch (models/layers.py).
//
// What bounds it on the H100. The scores S = C B^T do not depend on the
// head; per (chunk, head) the two products y_h = (exp(seg_h) . S) xdt_h
// (causal triangle) and state_h = (xdt_h . w_h)^T B take ~3 MFLOP at L
// 128, P 64, N 128. Counted as three tensor-core passes at the data
// sheet's rates that work takes less time than moving the bytes (~198 MB
// at the mamba2-370m prefill shape, 126 MB of them the fp32 y and state
// outputs the interface fixes), but mma.sync reaches only ~0.65 mma per
// cycle per SM on the H100 (~315 TFLOP/s TF32, ~615 bf16; PERF.md), and
// the fp32 operand splits, the per-element decay and shared-memory
// fragment loads come on top: clock64 phase counts put most of a CTA's
// time in the two per-head products (PERF.md).
//
// What the design does about that:
//  * One CTA of 16 warps per (chunk, group of HG heads); HG comes from the
//    shapes alone (ops.heads_per_cta). The CTA stages the chunk's B and C
//    with 16-byte cp.async and forms the causal lower triangle of S once,
//    in 16 x 16 tiles on or below the diagonal (fp32: FMAs on the CUDA
//    cores in a fixed order; bf16: m16n8k16, whose products are exact),
//    for all HG heads. S is formed the same way for every HG, so y and
//    state are the same bits whatever HG is.
//  * S, and per head M = exp(seg) . S, are kept in the order the mma A
//    fragments read them (frag_slot): one 16-byte load per lane and
//    k-step, no index arithmetic in the product loops.
//  * Per head, both products run through mma.sync. fp32: m16n8k8 TF32 on
//    3xTF32 operands (x = big + small; big.big + big.small + small.big,
//    one accumulator per pass). bf16: m16n8k16; xdt and B are exact in
//    bf16 and the fp32 factor (M, or xdt . w) is split three ways, hi +
//    mid + lo, each bf16, once per head into shared memory (three mma
//    per tile): with two parts, ~2^-17 of relative error per product put
//    cancelling outputs outside 3e-5 of the plain version. bf16 fragments
//    of xdt and B come through ldmatrix .trans. Warps take (16-row strip,
//    16-column group) units of y, the longest strips first and in snake
//    order, so the causal triangle's work spreads evenly.
//  * The decay: per head, prefix sums of log_a in fp64 (a fixed warp
//    scan), kept as hi + lo pairs of floats; seg_ij = (hi_i - hi_j) +
//    (lo_i - lo_j) keeps ~1 ulp of its own magnitude (the fp32 difference
//    of prefix sums near -460 would keep ~1e-5 relative accuracy), and
//    exp(seg_ij) is taken only where i >= j (a 0/1 mask multiplied in
//    would turn an overflow above the diagonal into inf * 0 = NaN).
//  * xdt rows of a head are 16-byte cp.async copies into a ring of two
//    stages (where C was while S was formed): head h+1 is in flight while
//    head h multiplies. Row strides are padded so that fragment loads are
//    free of bank conflicts; pad rows and columns are zero, and stores are
//    masked, so any L and any P and N the plan fits are taken (rows whose
//    width is not a multiple of 16 bytes are staged with plain loads).
// Shared memory (ops.py smem_bytes states the same plan): at L 128, N 128,
// P 64 and HG 8, 229,376 B in fp32 and 225,280 B in bf16: one CTA per SM.
// Later work: wgmma with TMA-fed stages, and the decay pass of head h+1
// overlapped with the products of head h.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#ifndef CPU_EMULATION
#define LAUNCH(kernel, grid, block, smem, stream) \
  kernel<<<grid, block, smem, stream>>>
__device__ __forceinline__ unsigned char* dyn_smem() {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  return smem_raw;
}
// 16-byte asynchronous copy global -> shared; zero-fills when !pred
__device__ __forceinline__ void cp_async_cg16(void* dst, const void* src,
                                              bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// four 8x8 b16 matrices; lane i gives the address of row i % 8 of matrix
// i / 8 and gets, per matrix, the pair (i / 4, 2 (i % 4) .. +1); .trans:
// the pair (2 (i % 4) .. +1, i / 4)
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* row) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(row);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* row) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(row);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}
// d += a . b on one 16x8x8 tile (tf32 in, fp32 accumulate)
__device__ __forceinline__ void mma_m16n8k8_tf32(float* d, const uint32_t* a,
                                                 const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// d += a . b on one 16x8x16 tile (bf16 in, fp32 accumulate)
__device__ __forceinline__ void mma_m16n8k16_bf16(float* d, const uint32_t* a,
                                                  const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
#endif

namespace {

constexpr int WARPS = 16;
constexpr int THREADS = 32 * WARPS;

template <typename T> struct IsBf16 { static constexpr bool v = false; };
template <> struct IsBf16<__nv_bfloat16> { static constexpr bool v = true; };

__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ inline int round16(int x) { return (x + 15) / 16 * 16; }

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

// fp32 -> tf32 (10 mantissa bits), round to nearest, ties away from zero
// (cvt.rna.tf32.f32 for finite x, in two integer operations)
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}
// x = big + small, both tf32 (3xTF32 operand split)
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}
__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16(x));
}
// (lo, hi) -> three bf16 pairs hi + mid + lo, each rounded to nearest;
// the residuals are exact in fp32, so the parts sum to x within ~2^-26 |x|
__device__ __forceinline__ void split3_bf16(float x0, float x1, uint32_t& h,
                                            uint32_t& m, uint32_t& l) {
  const uint32_t h0 = bf16_bits(x0), h1 = bf16_bits(x1);
  const float r0 = x0 - __uint_as_float(h0 << 16);
  const float r1 = x1 - __uint_as_float(h1 << 16);
  const uint32_t m0 = bf16_bits(r0), m1 = bf16_bits(r1);
  const float s0 = r0 - __uint_as_float(m0 << 16);
  const float s1 = r1 - __uint_as_float(m1 << 16);
  h = h0 | (h1 << 16);
  m = m0 | (m1 << 16);
  l = bf16_bits(s0) | (bf16_bits(s1) << 16);
}

// The shared-memory plan of one CTA (ops.py smem_bytes states the same):
//   cum [HG][LP] fp64   prefix sums of log_a, one row per head (then as
//                       hi + lo pairs of fp32)
//   w   [HG][LP] fp32   chunk-state weights exp(seg_{L-1,l}), 0 past L
//   B   [LP][NS] T      rows l; NS = N rounded up to 16, + 8
//   S   fp32            C B^T on the causal triangle, in the order the
//                       mma A fragments of y read it (frag_slot)
//   M   one head's exp(seg) . S in the same order: fp32, or for bf16
//       three planes of bf16 registers (hi, mid, lo)
//   XW  bf16 only: one head's (xdt . w)^T as the state product's A
//       fragments, three planes (hi, mid, lo)
//   X   C [LP][NS] T while S is formed, then the ring of xdt rows
//       [2][LP][XS] T; XS = P rounded up to 16, + 8
// Every region is a multiple of 16 bytes; pads (rows >= L, columns >= P
// or N) hold zeros.
struct Plan {
  int LP, PP, NP, NS, XS, nS, nblk;
  size_t cum, w, b, s, m, xw, x, bytes;
};
__host__ __device__ inline Plan make_plan(int L, int N, int P, int HG,
                                          int esz) {
  Plan q;
  q.LP = round16(L);
  q.PP = round16(P);
  q.NP = round16(N);
  q.NS = q.NP + 8;   // fp32: NS = 8 or 24 mod 32, conflict-free fragments
  q.XS = q.PP + 8;   // bf16: rows padded by 16 bytes for ldmatrix
  q.nS = q.LP / 16;  // 16-row strips
  // fragment blocks of the causal triangle: 32 lanes x 4 fp32 (m16n8k8,
  // nS (nS + 1) of them) or x 8 (m16n8k16, half as many)
  q.nblk = esz == 2 ? q.nS * (q.nS + 1) / 2 : q.nS * (q.nS + 1);
  const size_t tri = (size_t)q.nS * (q.nS + 1) / 2 * 256 * 4;
  const size_t cmat = (size_t)q.LP * q.NS * esz;
  const size_t ring = 2 * (size_t)q.LP * q.XS * esz;
  q.cum = 0;
  q.w = q.cum + (size_t)HG * q.LP * 8;
  q.b = q.w + (size_t)HG * q.LP * 4;
  q.s = q.b + cmat;
  q.m = q.s + tri;
  q.xw = q.m + (esz == 2 ? tri / 2 * 3 : tri);
  q.x = q.xw + (esz == 2 ? 3 * (size_t)q.PP * q.LP * 2 : 0);
  q.bytes = q.x + (cmat > ring ? cmat : ring);
  return q;
}
// Position of element (i, j), j < 16 (i / 16 + 1), of the causal triangle
// in fragment order: block (strip s = i / 16, k-step kk), lane (g, t),
// register e. fp32 (m16n8k8, 8 keys a step): e = a0..a3 = (g, t),
// (g+8, t), (g, t+4), (g+8, t+4). bf16 (m16n8k16): the pairs of a0..a3,
// lower key first.
template <bool BF>
__host__ __device__ inline int frag_slot(int i, int j) {
  const int s = i >> 4, g = i & 7, hi = (i >> 3) & 1;
  if (BF) {
    const int jj = j & 15;
    return ((s * (s + 1) / 2 + (j >> 4)) * 32 + g * 4 + ((jj & 7) >> 1)) *
               8 + (jj & 1) + 2 * hi + 4 * (jj >> 3);
  }
  return ((s * (s + 1) + (j >> 3)) * 32 + g * 4 + (j & 3)) * 4 + hi +
         2 * ((j >> 2) & 1);
}
// strip s and k-step kk of fragment block b
template <bool BF>
__device__ __forceinline__ void frag_block(int b, int& s, int& kk) {
  s = 0;
  if (BF) {
    while ((s + 1) * (s + 2) / 2 <= b) ++s;
    kk = b - s * (s + 1) / 2;
  } else {
    while ((s + 1) * (s + 2) <= b) ++s;
    kk = b - s * (s + 1);
  }
}

struct SsdParams {
  const void* xdt;  // [nC, L, H, P]
  const void* la;   // [nC, L, H]
  const void* B;    // [nC, L, N]
  const void* C;    // [nC, L, N]
  float* y;         // [nC, L, H, P]
  float* st;        // [nC, H, P, N]
  int L, H, P, N, HG;
};

// rows [0, L) x columns [0, cols) of a [rows][gstride] global matrix into
// shared [.][sstride]: 16-byte cp.async copies when every row is 16-byte
// aligned (async), else plain loads
template <typename T>
__device__ __forceinline__ void stage(T* dst, int sstride, const T* src,
                                     size_t gstride, int L, int cols,
                                     bool async) {
  if (async) {
    constexpr int VEC = 16 / (int)sizeof(T);
    const int cpr = cols / VEC;
    for (int i = threadIdx.x; i < L * cpr; i += THREADS) {
      const int r = i / cpr, q = i % cpr;
      cp_async_cg16(dst + r * sstride + q * VEC, src + r * gstride + q * VEC,
                    true);
    }
  } else {
    for (int i = threadIdx.x; i < L * cols; i += THREADS) {
      const int r = i / cols, q = i % cols;
      dst[r * sstride + q] = src[r * gstride + q];
    }
  }
}
// zeros in columns [cols, sstride) of rows < L and in rows [L, LP)
template <typename T>
__device__ __forceinline__ void zero_pads(T* dst, int sstride, int L,
                                          int cols, int LP) {
  const int pc = sstride - cols;
  for (int i = threadIdx.x; i < L * pc; i += THREADS)
    dst[(i / pc) * sstride + cols + i % pc] = zero<T>();
  for (int i = threadIdx.x; i < (LP - L) * sstride; i += THREADS)
    dst[L * sstride + i] = zero<T>();
}

// ---- S = C B^T on the causal 16 x 16 tiles ----
// Warp w forms tiles k = w, w + WARPS, ... (tile (ti, tj), tj <= ti, at
// ti (ti + 1) / 2 + tj). fp32: FMAs in ascending n, lane: rows ri, ri + 8
// and columns cj + 4 q. bf16: m16n8k16 over n (the products are exact in
// fp32, the tensor cores sum them in fp32).
template <typename T>
__device__ __forceinline__ void form_scores(const Plan& pl, const T* c_s,
                                            const T* b_s, float* s_s,
                                            int N) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ntiles = pl.nS * (pl.nS + 1) / 2, NS = pl.NS;
  for (int k = warp; k < ntiles; k += WARPS) {
    int ti = 0;
    while ((ti + 1) * (ti + 2) / 2 <= k) ++ti;
    const int tj = k - ti * (ti + 1) / 2;
    if constexpr (IsBf16<T>::v) {
      const int mi = lane / 8, mr = lane % 8, g = lane / 4, t = lane % 4;
      float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      // A: C rows 16 ti (+8 for matrices 1, 3), columns +8 for 2, 3;
      // B: B rows 16 tj (+8 for matrices 2, 3), columns +8 for 1, 3
      const T* ca = c_s + (16 * ti + mr + 8 * (mi % 2)) * NS + 8 * (mi / 2);
      const T* ba = b_s + (16 * tj + mr + 8 * (mi / 2)) * NS + 8 * (mi % 2);
      for (int n0 = 0; n0 < pl.NP; n0 += 16) {
        uint32_t a[4], bb[4];
        ldmatrix_x4(a, ca + n0);
        ldmatrix_x4(bb, ba + n0);
        mma_m16n8k16_bf16(acc[0], a, bb);
        mma_m16n8k16_bf16(acc[1], a, bb + 2);
      }
#pragma unroll
      for (int e = 0; e < 8; ++e)
        s_s[frag_slot<true>(16 * ti + g + 8 * ((e >> 1) & 1),
                            16 * tj + 8 * (e >> 2) + 2 * t + (e & 1))] =
            acc[e >> 2][e & 3];
    } else {
      const int ri = lane / 4, cj = lane % 4;
      float acc[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] = 0.f;
      const float* c0 = c_s + (16 * ti + ri) * NS;
      const float* c1 = c0 + 8 * NS;
      const float* b0 = b_s + (16 * tj + cj) * NS;
#pragma unroll 2
      for (int n = 0; n < N; n += 4) {
        const float4 a0 = *reinterpret_cast<const float4*>(c0 + n);
        const float4 a1 = *reinterpret_cast<const float4*>(c1 + n);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4 bq =
              *reinterpret_cast<const float4*>(b0 + 4 * q * NS + n);
          float& u = acc[q];
          float& v = acc[4 + q];
          u = fmaf(a0.x, bq.x, u); u = fmaf(a0.y, bq.y, u);
          u = fmaf(a0.z, bq.z, u); u = fmaf(a0.w, bq.w, u);
          v = fmaf(a1.x, bq.x, v); v = fmaf(a1.y, bq.y, v);
          v = fmaf(a1.z, bq.z, v); v = fmaf(a1.w, bq.w, v);
        }
      }
#pragma unroll
      for (int e = 0; e < 8; ++e)
        s_s[frag_slot<false>(16 * ti + ri + 8 * (e / 4),
                             16 * tj + cj + 4 * (e % 4))] = acc[e];
    }
  }
}

// three bf16 planes of fragment registers: plane k of block b, lane l at
// planes + (k * nblk + b) * 128 + l * 4
__device__ __forceinline__ void put3(uint32_t* planes, int nblk, int b,
                                     int lane, const uint32_t (&h)[4],
                                     const uint32_t (&m)[4],
                                     const uint32_t (&l)[4]) {
  float4* o = reinterpret_cast<float4*>(planes + ((size_t)b * 32 + lane) * 4);
  const size_t plane = (size_t)nblk * 32;   // in float4
  o[0] = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]),
                     __uint_as_float(h[2]), __uint_as_float(h[3]));
  o[plane] = make_float4(__uint_as_float(m[0]), __uint_as_float(m[1]),
                         __uint_as_float(m[2]), __uint_as_float(m[3]));
  o[2 * plane] = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]),
                             __uint_as_float(l[2]), __uint_as_float(l[3]));
}
__device__ __forceinline__ void get4(const uint32_t* p, uint32_t (&r)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  r[0] = __float_as_uint(v.x);
  r[1] = __float_as_uint(v.y);
  r[2] = __float_as_uint(v.z);
  r[3] = __float_as_uint(v.w);
}

// seg_ij from prefix sums held as hi + lo pairs of floats: the difference
// of the his is rounded once (to <= 0.5 ulp of seg), the los carry what
// the his dropped, so seg keeps ~1 ulp of its own magnitude
__device__ __forceinline__ float seg(float2 ci, float2 cj) {
  return __fadd_rn(__fsub_rn(ci.x, cj.x), __fsub_rn(ci.y, cj.y));
}

// ---- one head's factors: M = exp(seg) . S on or below the diagonal of
// the first L rows (else 0); bf16 also XW = (xdt . w)^T, both split in
// three bf16 parts ----
template <typename T>
__device__ __forceinline__ void head_factors(const Plan& pl, const float* s_s,
                                             const float2* cu,
                                             const float* w_s, const T* xs,
                                             float* m_s, uint32_t* xw_s,
                                             int L) {
  constexpr bool BF = IsBf16<T>::v;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
#pragma unroll 2
  for (int b = warp; b < pl.nblk; b += WARPS) {
    int s, kk;
    frag_block<BF>(b, s, kk);
    const int i0 = 16 * s + g;
    const float2 ci[2] = {cu[imin(i0, L - 1)], cu[imin(i0 + 8, L - 1)]};
    if constexpr (BF) {
      const float4* sp4 =
          reinterpret_cast<const float4*>(s_s + ((size_t)b * 32 + lane) * 8);
      const float4 s0 = sp4[0], s1 = sp4[1];
      const float sp[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
      float v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int hi = (e >> 1) & 1;
        const int i = i0 + 8 * hi, j = 16 * kk + 2 * t + (e & 1) + 2 * (e & 4);
        v[e] = i < L && j <= i ? expf(seg(ci[hi], cu[j])) * sp[e] : 0.f;
      }
      uint32_t h[4], m[4], l[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) split3_bf16(v[2 * r], v[2 * r + 1], h[r], m[r], l[r]);
      put3(reinterpret_cast<uint32_t*>(m_s), pl.nblk, b, lane, h, m, l);
    } else {
      const float4 sv =
          *reinterpret_cast<const float4*>(s_s + ((size_t)b * 32 + lane) * 4);
      const float sf[4] = {sv.x, sv.y, sv.z, sv.w};
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hi = e & 1;
        const int i = i0 + 8 * hi, j = 8 * kk + t + 4 * (e >> 1);
        v[e] = i < L && j <= i ? expf(seg(ci[hi], cu[j])) * sf[e] : 0.f;
      }
      *reinterpret_cast<float4*>(m_s + ((size_t)b * 32 + lane) * 4) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
  }
  if constexpr (BF) {
    // XW blocks (16-row strip p0 of P, 16-step l0 of L): a0 (p0+g, l0+2t
    // ..+1), a1 (p0+g+8, ..), a2 (p0+g, l0+2t+8..), a3 (p0+g+8, ..)
    const int nl = pl.LP / 16, nb = pl.PP / 16 * nl;
#pragma unroll 2
    for (int b = warp; b < nb; b += WARPS) {
      const int p0 = 16 * (b / nl), l0 = 16 * (b % nl);
      float v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int l = l0 + 2 * t + (e & 1) + 2 * (e & 4);
        const int p = p0 + g + 4 * (e & 2);
        v[e] = to_f(xs[l * pl.XS + p]) * w_s[l];
      }
      uint32_t h[4], m[4], lo[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) split3_bf16(v[2 * r], v[2 * r + 1], h[r], m[r], lo[r]);
      put3(xw_s, nb, b, lane, h, m, lo);
    }
  }
}

// fp32 outputs [row][col] of one 16 x 8 tile, a + (b + c) from the three
// passes' accumulators, pairs of columns as one 8-byte store where the
// row holds both
__device__ __forceinline__ void store_tile(float* out, size_t ld, int r0,
                                           int c0, int rows, int cols,
                                           const float* a, const float* b,
                                           const float* c) {
  const int g = threadIdx.x % 32 / 4, t = threadIdx.x % 4;
  const int q = c0 + 2 * t;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + g + 8 * h;
    if (r >= rows) continue;
    float* o = out + (size_t)r * ld + q;
    const float v0 = a[2 * h] + (b[2 * h] + c[2 * h]);
    const float v1 = a[2 * h + 1] + (b[2 * h + 1] + c[2 * h + 1]);
    if (q + 1 < cols && cols % 2 == 0 && ld % 2 == 0) {
      *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
    } else {
      if (q < cols) o[0] = v0;
      if (q + 1 < cols) o[1] = v1;
    }
  }
}

// ---- y of one head: M xdt over the causal triangle ----
// Units: (16-row strip, pair of 8-column tiles), longest strips first, in
// snake order over the warps, so every warp gets the same work.
template <typename T>
__device__ __forceinline__ void head_y(const Plan& pl, const float* m_s,
                                       const T* xs, float* y, int L, int H,
                                       int P) {
  constexpr bool BF = IsBf16<T>::v;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, mi = lane / 8, mr = lane % 8;
  const int XS = pl.XS, nS = pl.nS;
  const int ncg = pl.PP / 16, units = nS * ncg;
  for (int rd = 0; rd * WARPS < units; ++rd) {
    const int u = rd * WARPS + ((rd & 1) ? WARPS - 1 - warp : warp);
    if (u >= units) continue;
    const int s = nS - 1 - u / ncg, nt0 = 2 * (u % ncg);
    // one accumulator per pass: three independent mma chains per tile
    float acc[2][4], acc2[2][4], acc3[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = acc2[n][e] = acc3[n][e] = 0.f;
    if constexpr (BF) {
      const uint32_t* mp = reinterpret_cast<const uint32_t*>(m_s) +
                           ((size_t)s * (s + 1) / 2 * 32 + lane) * 4;
      const size_t plane = (size_t)pl.nblk * 128;
      const T* xa = xs + (mr + 8 * (mi % 2)) * XS + 8 * (nt0 + mi / 2);
#pragma unroll 2
      for (int kk = 0; kk <= s; ++kk) {
        uint32_t ah[4], am[4], al[4], bb[4];
        get4(mp + kk * 128, ah);
        get4(mp + plane + kk * 128, am);
        get4(mp + 2 * plane + kk * 128, al);
        ldmatrix_x4_trans(bb, xa + 16 * kk * XS);
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          mma_m16n8k16_bf16(acc3[q], al, bb + 2 * q);
          mma_m16n8k16_bf16(acc2[q], am, bb + 2 * q);
          mma_m16n8k16_bf16(acc[q], ah, bb + 2 * q);
        }
      }
    } else {
      const float* mp = m_s + ((size_t)s * (s + 1) * 32 + lane) * 4;
      const float* xf = reinterpret_cast<const float*>(xs) + t * XS +
                        8 * nt0 + g;
#pragma unroll 2
      for (int kk = 0; kk < 2 * (s + 1); ++kk) {
        const float4 mv = *reinterpret_cast<const float4*>(mp + kk * 128);
        const float af[4] = {mv.x, mv.y, mv.z, mv.w};
        uint32_t ab[4], as[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(af[e], ab[e], as[e]);
        const float* xk = xf + 8 * kk * XS;
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          uint32_t bb[2], bs[2];
          split_tf32(xk[8 * n], bb[0], bs[0]);
          split_tf32(xk[4 * XS + 8 * n], bb[1], bs[1]);
          mma_m16n8k8_tf32(acc3[n], as, bb);
          mma_m16n8k8_tf32(acc2[n], ab, bs);
          mma_m16n8k8_tf32(acc[n], ab, bb);
        }
      }
    }
#pragma unroll
    for (int n = 0; n < 2; ++n)
      store_tile(y, (size_t)H * P, 16 * s, 8 * (nt0 + n), L, P, acc[n],
                 acc2[n], acc3[n]);
  }
}

// ---- chunk state of one head: (xdt . w)^T B ----
// Units: (16-row strip of p, group of 4 column tiles of n).
template <typename T>
__device__ __forceinline__ void head_state(const Plan& pl, const float* w_s,
                                           const uint32_t* xw_s, const T* xs,
                                           const T* b_s, float* st, int P,
                                           int N) {
  constexpr bool BF = IsBf16<T>::v;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, mi = lane / 8, mr = lane % 8;
  const int XS = pl.XS, NS = pl.NS, ntl = pl.NP / 8;
  const int nng = (ntl + 3) / 4, units = pl.PP / 16 * nng;
  for (int u = warp; u < units; u += WARPS) {
    const int ps = u / nng, p0 = 16 * ps, nt0 = 4 * (u % nng);
    const int ntn = imin(4, ntl - nt0);
    float acc[4][4], acc2[4][4], acc3[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = acc2[n][e] = acc3[n][e] = 0.f;
    if constexpr (BF) {
      const int nl = pl.LP / 16;
      const size_t plane = (size_t)pl.PP / 16 * nl * 128;
      const uint32_t* ap = xw_s + ((size_t)ps * nl * 32 + lane) * 4;
      const T* ba = b_s + (mr + 8 * (mi % 2)) * NS + 8 * (nt0 + mi / 2);
#pragma unroll 2
      for (int kl = 0; kl < nl; ++kl) {
        uint32_t ah[4], am[4], al[4];
        get4(ap + kl * 128, ah);
        get4(ap + plane + kl * 128, am);
        get4(ap + 2 * plane + kl * 128, al);
#pragma unroll
        for (int n = 0; n < 4; n += 2) {
          if (n < ntn) {
            uint32_t bb[4];
            ldmatrix_x4_trans(bb, ba + 16 * kl * NS + 8 * n);
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              mma_m16n8k16_bf16(acc3[n + q], al, bb + 2 * q);
              mma_m16n8k16_bf16(acc2[n + q], am, bb + 2 * q);
              mma_m16n8k16_bf16(acc[n + q], ah, bb + 2 * q);
            }
          }
        }
      }
    } else {
      const float* xf = reinterpret_cast<const float*>(xs) + t * XS + p0 + g;
      const float* bf = reinterpret_cast<const float*>(b_s) + t * NS +
                        8 * nt0 + g;
#pragma unroll 2
      for (int l0 = 0; l0 < pl.LP; l0 += 8) {
        const float wA = w_s[l0 + t], wB = w_s[l0 + t + 4];
        const float* xk = xf + l0 * XS;
        const float af[4] = {xk[0] * wA, xk[8] * wA, xk[4 * XS] * wB,
                             xk[4 * XS + 8] * wB};
        uint32_t ab[4], as[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(af[e], ab[e], as[e]);
        const float* bk = bf + l0 * NS;
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          if (n < ntn) {
            uint32_t bb[2], bs[2];
            split_tf32(bk[8 * n], bb[0], bs[0]);
            split_tf32(bk[4 * NS + 8 * n], bb[1], bs[1]);
            mma_m16n8k8_tf32(acc3[n], as, bb);
            mma_m16n8k8_tf32(acc2[n], ab, bs);
            mma_m16n8k8_tf32(acc[n], ab, bb);
          }
        }
      }
    }
#pragma unroll
    for (int n = 0; n < 4; ++n)
      if (n < ntn)
        store_tile(st, N, p0, 8 * (nt0 + n), P, N, acc[n], acc2[n],
                   acc3[n]);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1) ssd_intra_kernel(SsdParams p) {
  const int L = p.L, H = p.H, P = p.P, N = p.N;
  const Plan pl = make_plan(L, N, P, p.HG, (int)sizeof(T));
  const int ngroups = (H + p.HG - 1) / p.HG;
  const int c = blockIdx.x / ngroups, h0 = (blockIdx.x % ngroups) * p.HG;
  const int nh = imin(p.HG, H - h0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  unsigned char* sm = dyn_smem();
  double* cum_s = reinterpret_cast<double*>(sm + pl.cum);  // [HG][LP]
  const float2* cum2_s = reinterpret_cast<const float2*>(cum_s);
  float* w_s = reinterpret_cast<float*>(sm + pl.w);        // [HG][LP]
  T* b_s = reinterpret_cast<T*>(sm + pl.b);                // [LP][NS]
  float* s_s = reinterpret_cast<float*>(sm + pl.s);        // S, fragments
  float* m_s = reinterpret_cast<float*>(sm + pl.m);        // M, fragments
  uint32_t* xw_s = reinterpret_cast<uint32_t*>(sm + pl.xw);  // bf16: XW
  T* c_s = reinterpret_cast<T*>(sm + pl.x);                // [LP][NS]
  T* x_s = reinterpret_cast<T*>(sm + pl.x);                // [2][LP][XS]
  const int XS = pl.XS, NS = pl.NS, LP = pl.LP;

  const size_t cL = (size_t)c * L;
  const T* xg = static_cast<const T*>(p.xdt) + (cL * H + h0) * P;
  const size_t xstride = (size_t)H * P;
  const bool abc = (N * sizeof(T)) % 16 == 0 &&
                   (reinterpret_cast<uintptr_t>(p.B) |
                    reinterpret_cast<uintptr_t>(p.C)) % 16 == 0;
  const bool ax = (P * sizeof(T)) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(p.xdt) % 16 == 0;

  // ---- B and C of the chunk (C where the xdt ring goes later) ----
  zero_pads(b_s, NS, L, N, LP);
  zero_pads(c_s, NS, L, N, LP);
  stage(b_s, NS, static_cast<const T*>(p.B) + cL * N, N, L, N, abc);
  stage(c_s, NS, static_cast<const T*>(p.C) + cL * N, N, L, N, abc);
  cp_async_commit();

  // ---- per head, prefix sums of log_a in fp64 (lane k sums its run of
  // rows, a shuffle scan adds the runs of lanes < k: an order set by L
  // alone) and the chunk-state weights ----
  {
    const int per = (L + 31) / 32, l0 = lane * per;
    for (int hh = warp; hh < nh; hh += WARPS) {
      const T* la = static_cast<const T*>(p.la) + cL * H + h0 + hh;
      double* cu = cum_s + hh * LP;
      double run = 0.0;
      for (int k = 0; k < per && l0 + k < L; ++k) {
        run += (double)to_f(la[(size_t)(l0 + k) * H]);
        cu[l0 + k] = run;
      }
      double incl = run;
#pragma unroll
      for (int d = 1; d < 32; d *= 2) {
        const double v = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += v;
      }
      const double off = incl - run;
      for (int k = 0; k < per && l0 + k < L; ++k) cu[l0 + k] += off;
      __syncwarp();
      const double cend = cu[L - 1];
      for (int l = lane; l < LP; l += 32)
        w_s[hh * LP + l] = l < L ? expf((float)(cend - cu[l])) : 0.f;
      __syncwarp();
      // each sum as hi + lo floats, in place
      for (int l = lane; l < L; l += 32) {
        const double v = cu[l];
        const float vh = (float)v;
        reinterpret_cast<float2*>(cu)[l] = make_float2(vh, (float)(v - vh));
      }
    }
  }

  cp_async_wait<0>();
  __syncthreads();
  form_scores(pl, c_s, b_s, s_s, N);
  __syncthreads();   // C read: the ring takes its place

  // ---- the xdt ring: head hh + 1 in flight while head hh multiplies ----
  zero_pads(x_s, XS, L, P, LP);
  zero_pads(x_s + LP * XS, XS, L, P, LP);
  stage(x_s, XS, xg, xstride, L, P, ax);
  cp_async_commit();
  for (int hh = 0; hh < nh; ++hh) {
    const int h = h0 + hh;
    cp_async_wait<0>();
    __syncthreads();   // xdt of head hh in place; head hh - 1 done
    if (hh + 1 < nh) {
      stage(x_s + ((hh + 1) & 1) * LP * XS, XS, xg + (hh + 1) * P, xstride,
            L, P, ax);
      cp_async_commit();
    }
    const T* xs = x_s + (hh & 1) * LP * XS;
    const float* w = w_s + hh * LP;
    head_factors(pl, s_s, cum2_s + hh * LP, w, xs, m_s, xw_s, L);
    __syncthreads();   // M (and XW) of head hh
    head_y(pl, m_s, xs, p.y + (cL * H + h) * P, L, H, P);
    head_state(pl, w, xw_s, xs, b_s, p.st + ((size_t)c * H + h) * P * N, P,
               N);
  }
}

template <typename T>
size_t smem_of(int L, int N, int P, int HG) {
  return make_plan(L, N, P, HG, (int)sizeof(T)).bytes;
}

template <typename T>
int launch(const SsdParams& p, int nC, cudaStream_t stream) {
  const size_t smem = smem_of<T>(p.L, p.N, p.P, p.HG);
  void (*kern)(SsdParams) = ssd_intra_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int ngroups = (p.H + p.HG - 1) / p.HG;
  LAUNCH(kern, dim3(nC * ngroups), dim3(THREADS), smem, stream)(p);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes): device pointers, is_bf16 selects
// bf16 (1) or fp32 (0) inputs, hg heads per CTA (ops.heads_per_cta); y and
// state are fp32. Returns the cudaError_t (cudaErrorInvalidValue for
// shapes or an hg the source does not take).
extern "C" int ssd_intra_fwd(const void* xdt, const void* log_a,
                             const void* B, const void* C, void* y,
                             void* state, int nC, int L, int H, int P, int N,
                             int is_bf16, int hg, void* stream) {
  if (nC < 1 || L < 1 || H < 1 || P < 1 || N < 1 || hg < 1 || hg > H)
    return (int)cudaErrorInvalidValue;
  SsdParams p;
  p.xdt = xdt; p.la = log_a; p.B = B; p.C = C;
  p.y = static_cast<float*>(y);
  p.st = static_cast<float*>(state);
  p.L = L; p.H = H; p.P = P; p.N = N; p.HG = hg;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(p, nC, st) : launch<float>(p, nC, st);
}

// Dynamic shared memory of one CTA in bytes (ops.smem_bytes states the
// same plan).
extern "C" long long ssd_intra_smem_bytes(int L, int N, int P, int hg,
                                          int is_bf16) {
  return (long long)(is_bf16 ? smem_of<__nv_bfloat16>(L, N, P, hg)
                             : smem_of<float>(L, N, P, hg));
}

#ifndef CPU_EMULATION
// Resident CTAs per SM, from the runtime's occupancy calculator.
extern "C" int ssd_intra_occupancy(int L, int N, int P, int hg,
                                   int is_bf16) {
  int n = -1;
  const size_t smem = ssd_intra_smem_bytes(L, N, P, hg, is_bf16);
  if (is_bf16) {
    cudaFuncSetAttribute(ssd_intra_kernel<__nv_bfloat16>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, ssd_intra_kernel<__nv_bfloat16>, THREADS, smem);
  } else {
    cudaFuncSetAttribute(ssd_intra_kernel<float>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, ssd_intra_kernel<float>, THREADS, smem);
  }
  return n;
}
#endif
