// Chunk attention for Hopper (sm_90a): position-masked GQA flash attention
// of the active query rows over the merged KV, with the Cache-Craft
// per-(row, chunk) softmax mass fused into the same online softmax.
//
// Replaces the TPU kernel chunk_attention_pallas
// (src/repro/kernels/chunk_attention/kernel.py:92, body _kernel at :34).
//
// What it computes, per batch row b:
//   out[a,h,:]  = softmax_s(mask(a,s) ? q[a,h,:].k[s,h/G,:] / sqrt(D) : -inf)
//                 @ v[:,h/G,:]
//   mass[a,c]   = sum_h sum_{s: chunk[s]==c} softmax(...)[a,h,s]
//   mask(a,s)   = q_pos[a] >= k_pos[s] >= 0, q_seg[a] == k_seg[s],
//                 and q_pos[a] - k_pos[s] < window when window > 0.
// Rows past A read as q_pos -1 / q_seg -1 and keys past S as k_pos -1 /
// k_seg -2 / chunk C-1 (the reference wrapper's padding, ops.py:50-59), so
// the ragged edges need no padded copies. The running max is clamped at
// NEG_INF/2 and the denominator at 1e-30 (kernel.py:72, :87): a fully
// masked row gives 0 output and 0 mass.
//
// What bounds it on the H100: at the main path's shapes (A ~ S ~ 10^3,
// H 32, D 128) the score and PV products are ~4*A*S*H*D flops against
// ~(A*H + 2*S*Hkv)*D elements read, so it is bound by arithmetic. This
// first version does the products on the fp32 CUDA cores (67 TFLOP/s
// peak), not the tensor cores, so fp32 results stay IEEE (no TF32).
//
// What the design does about that:
//  * One CTA holds the G = H/Hkv query heads of BQ = 64/G query rows for
//    one KV head (64 query vectors), so each K/V tile is read from device
//    memory once and used G times from shared memory.
//  * 256 threads compute a 64x64 score tile as 4x4 register micro-tiles
//    from shared memory padded to D+1 (conflict-free), and the PV product
//    as 4 rows x 8 columns of the output accumulator held in registers.
//  * A tile in which no (row, key) pair passes the mask is skipped before
//    its K/V are loaded: packed multi-request prefill then costs the
//    block-diagonal work, not the (sum A)(sum S) product. Skipping is
//    exact: a fully masked tile leaves the online-softmax state unchanged.
//  * The TPU kernel sums the mass across heads by revisiting one output
//    block in its sequential grid; CTAs here run in no order, so each CTA
//    writes a per-KV-head partial [B, Hkv, A, C] and a second kernel sums
//    it over Hkv in fixed order: deterministic, no atomics.
// Later work: wgmma on bf16 tiles, TMA loads, split-K over S.

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
#endif

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int NR = 64;        // query vectors (row x head) per CTA
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 256;  // 16 x 16 thread grid
constexpr int RPT = 4;        // score / output rows per thread
constexpr int CPT = BK / 16;  // score columns per thread
constexpr int MAXE = 8;       // output columns per thread (D <= 128)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct ChunkParams {
  const void* q;       // [B, A, H, D]
  const void* k;       // [B, S, Hkv, D]
  const void* v;       // [B, S, Hkv, D]
  const int* qpos;     // [B, A]
  const int* kpos;     // [B, S]
  const int* kchunk;   // [B, S]
  const int* qseg;     // [B, A]
  const int* kseg;     // [B, S]
  void* out;           // [B, A, H, D]
  float* mass_part;    // [B, Hkv, A, C]
  int B, A, S, H, Hkv, D, C, window;
  float scale;
};

__device__ __forceinline__ bool allowed(int qp, int qs, int kp, int ks,
                                        int window) {
  bool ok = (qp >= kp) && (qp >= 0) && (kp >= 0) && (qs == ks);
  if (window > 0) ok = ok && (qp - kp < window);
  return ok;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
chunk_attention_kernel(ChunkParams p) {
  const int D = p.D, C = p.C, G = p.H / p.Hkv;
  const int BQ = NR / G;            // query rows per CTA
  const int nrow = BQ * G;          // live query vectors (<= NR)
  const int qb = blockIdx.x, hkv = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int DP = D + 1;             // padded row stride (bank conflicts)

  float* q_s = reinterpret_cast<float*>(dyn_smem());   // [NR][D+1]
  float* k_s = q_s + NR * DP;                          // [BK][D+1]
  float* v_s = k_s + BK * DP;                          // [BK][D]
  float* p_s = v_s + BK * D;                           // [NR][BK+1]
  float* mass_s = p_s + NR * (BK + 1);                 // [NR][C]
  float* m_s = mass_s + NR * C;                        // [NR]
  float* l_s = m_s + NR;                               // [NR]
  float* corr_s = l_s + NR;                            // [NR]
  int* qpos_s = reinterpret_cast<int*>(corr_s + NR);   // [NR]
  int* qseg_s = qpos_s + NR;                           // [NR]
  int* kpos_s = qseg_s + NR;                           // [BK]
  int* kseg_s = kpos_s + BK;                           // [BK]
  int* kch_s = kseg_s + BK;                            // [BK]

  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);

  // ---- load this CTA's query vectors: row r = qi * G + g ----
  for (int idx = tid; idx < NR * D; idx += THREADS) {
    const int r = idx / D, d = idx % D;
    const int qi = r / G, g = r % G, a = qb * BQ + qi;
    float val = 0.f;
    if (r < nrow && a < p.A)
      val = to_f(q[((size_t)(b * p.A + a) * p.H + hkv * G + g) * D + d]);
    q_s[r * DP + d] = val;
  }
  for (int r = tid; r < NR; r += THREADS) {
    const int a = qb * BQ + r / G;
    const bool live = r < nrow && a < p.A;
    qpos_s[r] = live ? p.qpos[b * p.A + a] : -1;
    qseg_s[r] = live ? p.qseg[b * p.A + a] : -1;
    m_s[r] = NEG_INF;
    l_s[r] = 0.f;
  }
  for (int idx = tid; idx < NR * C; idx += THREADS) mass_s[idx] = 0.f;

  float acc[RPT][MAXE];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int e = 0; e < MAXE; ++e) acc[i][e] = 0.f;

  for (int s0 = 0; s0 < p.S; s0 += BK) {
    __syncthreads();  // previous tile fully consumed
    for (int j = tid; j < BK; j += THREADS) {
      const int s = s0 + j;
      const bool in = s < p.S;
      kpos_s[j] = in ? p.kpos[b * p.S + s] : -1;
      kseg_s[j] = in ? p.kseg[b * p.S + s] : -2;
      kch_s[j] = in ? p.kchunk[b * p.S + s] : C - 1;
    }
    __syncthreads();
    // skip a tile no (row, key) pair of this CTA may attend to
    int any = 0;
    for (int idx = tid; idx < NR * BK; idx += THREADS) {
      const int r = idx / BK, j = idx % BK;
      any |= allowed(qpos_s[r], qseg_s[r], kpos_s[j], kseg_s[j], p.window);
    }
    if (!__syncthreads_or(any)) continue;

    for (int idx = tid; idx < BK * D; idx += THREADS) {
      const int j = idx / D, d = idx % D, s = s0 + j;
      float kv = 0.f, vv = 0.f;
      if (s < p.S) {
        const size_t off = ((size_t)(b * p.S + s) * p.Hkv + hkv) * D + d;
        kv = to_f(k[off]);
        vv = to_f(v[off]);
      }
      k_s[j * DP + d] = kv;
      v_s[j * D + d] = vv;
    }
    __syncthreads();

    // ---- scores: rows ty*4 + i, columns tx + 16*c ----
    float sc[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int c = 0; c < CPT; ++c) sc[i][c] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[RPT], kv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = q_s[(ty * RPT + i) * DP + d];
#pragma unroll
      for (int c = 0; c < CPT; ++c) kv[c] = k_s[(tx + 16 * c) * DP + d];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) sc[i][c] += qv[i] * kv[c];
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = ty * RPT + i;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int j = tx + 16 * c;
        const bool ok = allowed(qpos_s[r], qseg_s[r], kpos_s[j], kseg_s[j],
                                p.window);
        p_s[r * (BK + 1) + j] = ok ? sc[i][c] * p.scale : NEG_INF;
      }
    }
    __syncthreads();

    // ---- online softmax: 4 threads per row ----
    {
      const int r = tid / 4, sub = tid % 4;
      float mt = NEG_INF;
      for (int j = sub; j < BK; j += 4) mt = fmaxf(mt, p_s[r * (BK + 1) + j]);
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(fmaxf(m_prev, mt), NEG_INF / 2);
      float sum = 0.f;
      for (int j = sub; j < BK; j += 4) {
        const float e = expf(p_s[r * (BK + 1) + j] - m_new);
        p_s[r * (BK + 1) + j] = e;
        sum += e;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      __syncwarp();
      if (sub == 0) {
        const float corr = expf(m_prev - m_new);
        l_s[r] = l_s[r] * corr + sum;
        corr_s[r] = corr;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // ---- chunk mass: (row, chunk) pairs over the tile's keys ----
    for (int idx = tid; idx < NR * C; idx += THREADS) {
      const int r = idx / C, c = idx % C;
      float sum = 0.f;
      for (int j = 0; j < BK; ++j)
        if (kch_s[j] == c) sum += p_s[r * (BK + 1) + j];
      mass_s[idx] = mass_s[idx] * corr_s[r] + sum;
    }

    // ---- PV: rows ty*4 + i, columns tx + 16*e ----
    float cr[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) cr[i] = corr_s[ty * RPT + i];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int e = 0; e < MAXE; ++e) acc[i][e] *= cr[i];
    for (int j = 0; j < BK; ++j) {
      float pj[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pj[i] = p_s[(ty * RPT + i) * (BK + 1) + j];
#pragma unroll
      for (int e = 0; e < MAXE; ++e) {
        const int d = tx + 16 * e;
        if (d < D) {
          const float vv = v_s[j * D + d];
#pragma unroll
          for (int i = 0; i < RPT; ++i) acc[i][e] += pj[i] * vv;
        }
      }
    }
  }
  __syncthreads();

  // ---- epilogue: normalised output, per-KV-head partial mass ----
  T* out = static_cast<T*>(p.out);
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = ty * RPT + i;
    const int qi = r / G, g = r % G, a = qb * BQ + qi;
    if (r >= nrow || a >= p.A) continue;
    const float inv_l = 1.f / fmaxf(l_s[r], 1e-30f);
#pragma unroll
    for (int e = 0; e < MAXE; ++e) {
      const int d = tx + 16 * e;
      if (d < D)
        out[((size_t)(b * p.A + a) * p.H + hkv * G + g) * D + d] =
            from_f<T>(acc[i][e] * inv_l);
    }
  }
  for (int idx = tid; idx < BQ * C; idx += THREADS) {
    const int qi = idx / C, c = idx % C, a = qb * BQ + qi;
    if (a >= p.A) continue;
    float sum = 0.f;
    for (int g = 0; g < G; ++g) {
      const int r = qi * G + g;
      sum += mass_s[r * C + c] / fmaxf(l_s[r], 1e-30f);
    }
    p.mass_part[((size_t)(b * p.Hkv + hkv) * p.A + a) * C + c] = sum;
  }
}

// mass[b, a, c] = sum over kv heads, in order, of mass_part[b, h, a, c]
__global__ void mass_reduce_kernel(const float* mass_part, float* mass,
                                   int B, int Hkv, int A, int C) {
  const size_t n = (size_t)B * A * C;
  for (size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x; idx < n;
       idx += (size_t)gridDim.x * blockDim.x) {
    const size_t b = idx / ((size_t)A * C), ac = idx % ((size_t)A * C);
    float sum = 0.f;
    for (int h = 0; h < Hkv; ++h)
      sum += mass_part[(b * Hkv + h) * (size_t)A * C + ac];
    mass[idx] = sum;
  }
}

size_t smem_bytes(int D, int C) {
  return sizeof(float) * ((size_t)NR * (D + 1) + (size_t)BK * (D + 1) +
                          (size_t)BK * D + (size_t)NR * (BK + 1) +
                          (size_t)NR * C + 3 * NR) +
         sizeof(int) * (2 * NR + 3 * BK);
}

template <typename T>
int launch(const ChunkParams& p, float* mass, cudaStream_t stream) {
  const int G = p.H / p.Hkv;
  const int BQ = NR / G;
  const size_t smem = smem_bytes(p.D, p.C);
  void (*kern)(ChunkParams) = chunk_attention_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((p.A + BQ - 1) / BQ, p.Hkv, p.B);
  LAUNCH(kern, grid, dim3(THREADS), smem, stream)(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t n = (size_t)p.B * p.A * p.C;
  const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  LAUNCH(mass_reduce_kernel, dim3(blocks > 0 ? blocks : 1), dim3(256), 0,
         stream)(p.mass_part, mass, p.B, p.Hkv, p.A, p.C);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes). Pointers are device pointers;
// int tensors are int32; is_bf16 selects bf16 (1) or fp32 (0) q/k/v/out.
// Returns the cudaError_t of the launches (0 = success).
extern "C" int chunk_attention_fwd(
    const void* q, const void* k, const void* v, const void* qpos,
    const void* kpos, const void* kchunk, const void* qseg, const void* kseg,
    void* out, void* mass_part, void* mass, int B, int A, int S, int H,
    int Hkv, int D, int C, int window, int is_bf16, void* stream) {
  ChunkParams p;
  p.q = q; p.k = k; p.v = v;
  p.qpos = static_cast<const int*>(qpos);
  p.kpos = static_cast<const int*>(kpos);
  p.kchunk = static_cast<const int*>(kchunk);
  p.qseg = static_cast<const int*>(qseg);
  p.kseg = static_cast<const int*>(kseg);
  p.out = out;
  p.mass_part = static_cast<float*>(mass_part);
  p.B = B; p.A = A; p.S = S; p.H = H; p.Hkv = Hkv; p.D = D; p.C = C;
  p.window = window;
  p.scale = 1.0f / sqrtf((float)D);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* m = static_cast<float*>(mass);
  return is_bf16 ? launch<__nv_bfloat16>(p, m, st) : launch<float>(p, m, st);
}
