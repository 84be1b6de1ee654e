// One-token decode attention for Hopper (sm_90a), over a dense KV arena
// and in place over the KV pool's block arena.
//
// Replaces the TPU kernels decode_attention_pallas
// (src/repro/kernels/decode_attention/kernel.py:175, body _kernel at :25)
// and paged_decode_attention_pallas (kernel.py:116, body _paged_kernel at
// :65).
//
// What it computes, per request b and query head h (KV head h / G):
//   out[b,h,:] = softmax_s(mask(s) ? q[b,h,:].k[s,:] / sqrt(D) : -inf) @ v
//   mask(s)    = 0 <= k_pos[s] <= q_pos[b], and q_pos[b] - k_pos[s] <
//                window when window > 0.
// A request with q_pos = -1 (a masked batch row) gives zeros.
//  * dense:  keys are k/v[b, s, h/G, :] for s < S, positions k_pos[b, s].
//  * paged:  keys are the slots of the blocks in block_rows[b, :] (entries
//            of -1 are skipped), read in place from k/v_blocks[blk, slot,
//            h/G, :] with per-slot positions kpos_blocks[blk, slot] (-1 =
//            interior padding). Blocks shared by several requests are only
//            read.
//
// What bounds it on the H100: each K/V element is used by the G = H/Hkv
// heads of its group only (2*G flops per element read), so decode is bound
// by the bytes of K and V over the 3.35 TB/s of device memory.
//
// What the design does about that: one CTA per (request, KV head) reads
// every live K/V element of its group exactly once and uses it for all G
// heads. Each tile of 64 keys is staged in shared memory by all 128
// threads with coalesced loads along D, many in flight per thread (the
// first version read K/V straight from device memory one key at a time and
// was latency bound). Scores are one (head, key) dot product per thread
// over the staged tile, the online softmax and PV run in fp32 from shared
// memory. Tiles of 64 keys whose positions all fail the mask (padding,
// dead blocks, slots past the query) are skipped before K/V are read, so a
// request costs the bytes of its live keys.
// Later work: split-K over S (one CTA per (request, KV head, S slice) plus a
// combine pass) to fill more of the 132 SMs when B * Hkv is small, and
// 16-byte vector loads.

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
constexpr int THREADS = 128;     // 4 warps
constexpr int NWARP = THREADS / 32;
constexpr int TK = 64;           // keys per tile
constexpr int MAXI = 16;         // G * D <= 2048 outputs per CTA

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

// floats of shared memory before the key-address array
__host__ __device__ inline size_t float_count(int G, int D) {
  return (size_t)G * D + (size_t)TK * (D + 1) + (size_t)TK * D +
         (size_t)G * TK + 3 * (size_t)G;
}

struct DecodeParams {
  const void* q;      // [B, H, D]
  const void* k;      // dense [B, S, Hkv, D] | paged [NB, bs, Hkv, D]
  const void* v;
  const int* qpos;    // [B]
  const int* kpos;    // dense [B, S] | paged [NB, bs]
  const int* rows;    // paged [B, NBmax] block ids (-1 padded)
  void* out;          // [B, H, D]
  int H, Hkv, D, window;
  int S;              // dense: S; paged: NBmax * bs logical slots
  int bs, NBmax;      // paged only
  float scale;
};

template <typename T, bool PAGED>
__global__ void __launch_bounds__(THREADS)
decode_kernel(DecodeParams p) {
  const int b = blockIdx.x, hkv = blockIdx.y;
  const int D = p.D, G = p.H / p.Hkv, DP = D + 1;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int qp = p.qpos[b];
  T* out = static_cast<T*>(p.out);
  const size_t obase = ((size_t)b * p.H + (size_t)hkv * G) * D;
  if (qp < 0) {  // masked batch row: inert zeros
    for (int i = tid; i < G * D; i += THREADS) out[obase + i] = from_f<T>(0.f);
    return;
  }

  float* q_s = reinterpret_cast<float*>(dyn_smem());  // [G][D]
  float* k_s = q_s + G * D;                           // [TK][D+1]
  float* v_s = k_s + TK * DP;                         // [TK][D]
  float* s_s = v_s + TK * D;                          // [G][TK]
  float* m_s = s_s + G * TK;                          // [G]
  float* l_s = m_s + G;                               // [G]
  float* corr_s = l_s + G;                            // [G]
  long long* addr_s = reinterpret_cast<long long*>(
      corr_s + G + (float_count(G, D) % 2));          // [TK], 8-aligned

  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  for (int i = tid; i < G * D; i += THREADS) q_s[i] = to_f(q[obase + i]);
  for (int g = tid; g < G; g += THREADS) {
    m_s[g] = NEG_INF;
    l_s[g] = 0.f;
  }
  float acc[MAXI];
#pragma unroll
  for (int i = 0; i < MAXI; ++i) acc[i] = 0.f;
  const int nacc = (G * D + THREADS - 1) / THREADS;

  for (int t0 = 0; t0 < p.S; t0 += TK) {
    __syncthreads();  // previous tile consumed
    int live = 0;
    for (int j = tid; j < TK; j += THREADS) {
      const int idx = t0 + j;
      long long addr = -1;
      int kp = -1;
      if (idx < p.S) {
        if (PAGED) {
          const int blk = p.rows[(size_t)b * p.NBmax + idx / p.bs];
          if (blk >= 0) {
            const size_t slot = (size_t)blk * p.bs + idx % p.bs;
            kp = p.kpos[slot];
            addr = (long long)((slot * p.Hkv + hkv) * D);
          }
        } else {
          kp = p.kpos[(size_t)b * p.S + idx];
          addr = (long long)((((size_t)b * p.S + idx) * p.Hkv + hkv) * D);
        }
      }
      bool ok = kp >= 0 && kp <= qp;
      if (p.window > 0) ok = ok && (qp - kp < p.window);
      addr_s[j] = ok ? addr : -1;
      live |= ok;
    }
    if (!__syncthreads_or(live)) continue;

    // stage the tile's live K/V rows in shared memory: every thread keeps
    // many independent, coalesced loads in flight
#pragma unroll 8
    for (int idx = tid; idx < TK * D; idx += THREADS) {
      const int j = idx / D, d = idx % D;
      const long long a = addr_s[j];
      float kv = 0.f, vv = 0.f;
      if (a >= 0) {
        kv = to_f(k[a + d]);
        vv = to_f(v[a + d]);
      }
      k_s[j * DP + d] = kv;
      v_s[j * D + d] = vv;
    }
    __syncthreads();

    // scores: one (head, key) pair per thread, dot over D from shared
    // memory (K rows padded to D+1: conflict-free across keys)
    for (int pr = tid; pr < G * TK; pr += THREADS) {
      const int g = pr / TK, j = pr % TK;
      float dot = 0.f;
      for (int d = 0; d < D; ++d) dot += q_s[g * D + d] * k_s[j * DP + d];
      s_s[pr] = addr_s[j] >= 0 ? dot * p.scale : NEG_INF;
    }
    __syncthreads();

    // online softmax: warp w takes heads w, w + 4, ...
    for (int g = warp; g < G; g += NWARP) {
      float mt = NEG_INF;
      for (int j = lane; j < TK; j += 32) mt = fmaxf(mt, s_s[g * TK + j]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
      const float m_prev = m_s[g];
      const float m_new = fmaxf(fmaxf(m_prev, mt), NEG_INF / 2);
      float sum = 0.f;
      for (int j = lane; j < TK; j += 32) {
        const float e = expf(s_s[g * TK + j] - m_new);
        s_s[g * TK + j] = e;
        sum += e;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        l_s[g] = l_s[g] * corr + sum;
        corr_s[g] = corr;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // PV: thread owns outputs (g, d) = divmod(tid + THREADS * i, D); masked
    // keys have p = 0 and zero V rows
#pragma unroll
    for (int i = 0; i < MAXI; ++i) {
      const int o = tid + THREADS * i;
      if (i < nacc && o < G * D) {
        const int g = o / D, d = o % D;
        float a = acc[i] * corr_s[g];
        for (int j = 0; j < TK; ++j) a += s_s[g * TK + j] * v_s[j * D + d];
        acc[i] = a;
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < MAXI; ++i) {
    const int o = tid + THREADS * i;
    if (i < nacc && o < G * D)
      out[obase + o] = from_f<T>(acc[i] / fmaxf(l_s[o / D], 1e-30f));
  }
}

size_t smem_bytes(int G, int D) {
  const size_t floats = float_count(G, D);
  return sizeof(float) * (floats + floats % 2) + sizeof(long long) * TK;
}

template <typename T, bool PAGED>
int launch(const DecodeParams& p, int B, cudaStream_t stream) {
  const int G = p.H / p.Hkv;
  const size_t smem = smem_bytes(G, p.D);
  void (*kern)(DecodeParams) = decode_kernel<T, PAGED>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  LAUNCH(kern, dim3(B, p.Hkv), dim3(THREADS), smem, stream)(p);
  return (int)cudaGetLastError();
}

DecodeParams make_params(const void* q, const void* k, const void* v,
                         const void* qpos, const void* kpos, void* out,
                         int H, int Hkv, int D, int window) {
  DecodeParams p;
  p.q = q; p.k = k; p.v = v;
  p.qpos = static_cast<const int*>(qpos);
  p.kpos = static_cast<const int*>(kpos);
  p.rows = nullptr;
  p.out = out;
  p.H = H; p.Hkv = Hkv; p.D = D; p.window = window;
  p.S = 0; p.bs = 0; p.NBmax = 0;
  p.scale = 1.0f / sqrtf((float)D);
  return p;
}

}  // namespace

// Plain C entry points (bound with ctypes): device pointers, int32 index
// tensors, is_bf16 selects bf16 (1) or fp32 (0). Return the cudaError_t.
extern "C" int decode_attention_fwd(
    const void* q, const void* k, const void* v, const void* qpos,
    const void* kpos, void* out, int B, int S, int H, int Hkv, int D,
    int window, int is_bf16, void* stream) {
  DecodeParams p = make_params(q, k, v, qpos, kpos, out, H, Hkv, D, window);
  p.S = S;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16, false>(p, B, st)
                 : launch<float, false>(p, B, st);
}

extern "C" int paged_decode_attention_fwd(
    const void* q, const void* k_blocks, const void* v_blocks,
    const void* kpos_blocks, const void* block_rows, const void* qpos,
    void* out, int B, int NBmax, int bs, int H, int Hkv, int D, int window,
    int is_bf16, void* stream) {
  DecodeParams p = make_params(q, k_blocks, v_blocks, qpos, kpos_blocks, out,
                               H, Hkv, D, window);
  p.rows = static_cast<const int*>(block_rows);
  p.bs = bs;
  p.NBmax = NBmax;
  p.S = NBmax * bs;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16, true>(p, B, st)
                 : launch<float, true>(p, B, st);
}
