// One-token decode attention for Hopper (sm_90a), over a dense KV arena
// and in place over the KV pool's block arena.
//
// Replaces the TPU kernels decode_attention_pallas
// (src/repro/kernels/decode_attention/kernel.py:175, body _kernel at :25)
// and paged_decode_attention_pallas (kernel.py:116, body _paged_kernel at
// :65).
//
// What it computes, per request b and query head h (KV head h / G):
//   out[b,h,:] = softmax_s(mask(s) ? q[b,h,:].k[s,:] / sqrt(D) : -1e30) @ v
//   mask(s)    = 0 <= k_pos[s] <= q_pos[b], and q_pos[b] - k_pos[s] <
//                window when window > 0.
// The running max is clamped at NEG_INF/2 and the output is
// acc / max(l, 1e-30), so a request with q_pos = -1 (a masked batch row),
// or with no live key, gives zeros.
//  * dense:  keys are k/v[b, s, h/G, :] for s < S, positions k_pos[b, s].
//  * paged:  keys are the slots of the blocks in block_rows[b, :] (entries
//            of -1 are skipped), read in place from k/v_blocks[blk, slot,
//            h/G, :] with per-slot positions kpos_blocks[blk, slot] (-1 =
//            interior padding). Blocks shared by several requests are only
//            read. A slot holds kvh >= Hkv heads (the pool's head count):
//            the call may cover a slice of them, so a head-sharded mesh
//            launches once per shard on its heads of the same blocks, read
//            in place (k/v_blocks point at the slice's first head).
//
// What bounds it on the H100: each K/V element is used by the G = H/Hkv
// heads of its group only, 2*G flops per element read (G <= 16 in every
// configuration of the repository: at most 8 flops per fp32 byte, far
// below the ~20 the CUDA cores can take per byte of HBM). So the kernel is
// bound by the bytes of the live keys' K and V over the 3.35 TB/s of
// device memory, and its job is to keep many bytes in flight on every SM.
// At serving shapes (B <= 4 requests x 8 KV heads) one CTA per (request,
// KV head) would leave three quarters of the 132 SMs idle.
//
// What the design does about that:
//  * A grid of (B, Hkv, nsplit): the keys of a request are split into
//    nsplit contiguous ranges (whole 32-key tiles in fp32 and 64-key tiles
//    in bf16 for the dense arena; whole pool blocks for the paged one, in
//    runs of a tile's keys where blocks are smaller than a tile).
//    The count is chosen from the shapes and dtype alone
//    (ops.num_splits). With nsplit == 1 the CTA writes out itself;
//    otherwise it writes its partial (acc[G*D], m, l) in fp32 to a
//    workspace and combine_kernel merges the ranges in a fixed order
//    (range 0, 1, ...) with the same rescaling. No atomics: the same
//    inputs give the same bytes on every launch.
//  * Each CTA reads every live K/V element of its range once and uses it
//    for all G heads of its group.
//  * Before any K/V copy, a pass over the range's keys stages their
//    metadata in shared memory with 4-byte cp.async copies: k_pos, or in
//    the paged kernel the block ids and then the slot positions. It turns
//    each key into its K/V row index (or -1 when masked) and flags the
//    tiles with a live key. Tiles without one (padding, -1 blocks, slots
//    past q_pos or outside the window) are never copied, so a request
//    costs the bytes of its live keys.
//  * Live tiles are staged with 16-byte cp.async copies along D (one
//    copy per (key, 16-byte lane), rows padded by 16 bytes) into a ring
//    of two stages: tile j+1 is in flight while tile j is computed.
//  * Arithmetic on the CUDA cores in fp32 (bf16 widened on load): one
//    thread per (head, key) for the scores, a warp per head for the
//    online softmax (exp2 of log2e-scaled scores), one thread per (head,
//    4 output columns) for P.V with the accumulators in registers.
//  * Element types (the C entries' type code): fp32 (0), bf16 (1), and for
//    the dense arena bf16 q and out over fp32 K/V (2), the mix a bf16
//    model decodes with over the engine's fp32 arena, as the reference's
//    kernel takes it (kernel.py upcasts q, K and V and writes out in q's
//    dtype). The mix is the fp32 kernel with its G query rows widened to
//    fp32 on load (plain 16-byte loads: cp.async cannot convert) and the
//    output rounded to bf16 to nearest even. The paged kernel takes no
//    mix: no served path reaches it with one.
// Later work: a persistent grid or a fused combine (the combine is a
// second launch), and a TMA-fed producer warp.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

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
// 4-byte asynchronous copy global -> shared; zero-fills when !pred
__device__ __forceinline__ void cp_async_ca4(void* dst, const void* src,
                                             bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(pred ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
#endif

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int THREADS = 128;          // 4 warps
constexpr int NWARP = THREADS / 32;
constexpr int WIN = 512;              // keys whose metadata one pass stages
constexpr int MAX_GD = 4096;          // G * D outputs per CTA
constexpr int MAXU = MAX_GD / 4 / THREADS;   // 4-column accumulators a thread
constexpr int COMBINE_THREADS = 64;   // 4 columns each: D <= 256

template <typename T> struct IsBf16 { static constexpr bool v = false; };
template <> struct IsBf16<__nv_bfloat16> { static constexpr bool v = true; };

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// keys per tile: 32 in fp32, 64 in bf16 (16 KB of K and 16 KB of V per
// stage at D 128 either way)
template <typename T>
__host__ __device__ constexpr int keys_per_tile() {
  return IsBf16<T>::v ? 64 : 32;
}
// shared-memory row stride in elements: D plus 16 bytes, so that the
// 16-byte loads of 8 consecutive keys fall in distinct banks
template <typename T, int D>
__host__ __device__ constexpr int row_stride() {
  return D + 16 / (int)sizeof(T);
}

// dynamic shared memory of one CTA, byte offsets
template <typename T, int D>
struct Layout {
  static constexpr int TK = keys_per_tile<T>();
  static constexpr int RS = row_stride<T, D>();
  size_t kv, s, m, row, blk, live, total;
  __host__ __device__ Layout(int G, bool paged) {
    kv = sizeof(T) * (size_t)G * D;          // q [G][D] first
    s = kv + sizeof(T) * 4 * (size_t)TK * RS;  // [2 stages][K, V][TK][RS]
    m = s + sizeof(float) * (size_t)G * TK;  // scores / P [G][TK]
    row = m + sizeof(float) * 3 * (size_t)G;   // m, l, corr [G]
    blk = row + sizeof(int) * WIN;           // K/V row of each key, or -1
    live = blk + (paged ? sizeof(int) * (WIN + 1) : 0);   // block ids
    total = live + sizeof(int) * (WIN / TK);   // live flag per tile
  }
};

struct DecodeParams {
  const void* q;      // [B, H, D] (TQ)
  const void* k;      // dense [B, S, Hkv, D] | paged [NB, bs, kvh, D]
  const void* v;
  const int* qpos;    // [B]
  const int* kpos;    // dense [B, S] | paged [NB, bs]
  const int* rows;    // paged [B, NBmax] block ids (-1 padded)
  void* out;          // [B, H, D] (TQ)
  float* work;        // nsplit > 1: acc [ns,B,H,D], m, l [ns,B,H]
  int B, H, Hkv, D, window;
  int kvh;            // paged: heads per pool slot (the slot stride), >= Hkv
  int S;              // dense: S; paged: NBmax * bs logical slots
  int bs, NBmax;      // paged only
  int nsplit, keys_per_split;
  float scale2;       // log2(e) / sqrt(D)
};

// 0 <= kp <= qp, inside the window; with qp >= 0, kp in [0, qp] <=>
// (unsigned) kp <= (unsigned) qp
__device__ __forceinline__ bool allowed(int qp, int kp, int window) {
  return qp >= 0 && (unsigned)kp <= (unsigned)qp &&
         (window <= 0 || qp - kp < window);
}

// fp32 dot product of two 16-byte-aligned rows of D elements of T, in
// four interleaved partial sums
template <typename T, int D>
__device__ __forceinline__ float dot_row(const T* a, const T* b) {
  constexpr int C = D * (int)sizeof(T) / 16;
  const float4* a4 = reinterpret_cast<const float4*>(a);
  const float4* b4 = reinterpret_cast<const float4*>(b);
  float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float4 x = a4[c], y = b4[c];
    if constexpr (IsBf16<T>::v) {
      // each 32-bit word holds two bf16: the low one is (word << 16)
      const uint32_t xs[4] = {__float_as_uint(x.x), __float_as_uint(x.y),
                              __float_as_uint(x.z), __float_as_uint(x.w)};
      const uint32_t ys[4] = {__float_as_uint(y.x), __float_as_uint(y.y),
                              __float_as_uint(y.z), __float_as_uint(y.w)};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[e] += __uint_as_float(xs[e] << 16) * __uint_as_float(ys[e] << 16);
        s[e] += __uint_as_float(xs[e] & 0xFFFF0000u) *
                __uint_as_float(ys[e] & 0xFFFF0000u);
      }
    } else {
      s[0] += x.x * y.x;
      s[1] += x.y * y.y;
      s[2] += x.z * y.z;
      s[3] += x.w * y.w;
    }
  }
  return (s[0] + s[1]) + (s[2] + s[3]);
}

// four consecutive elements of T (aligned to 4 elements) as fp32
template <typename T>
__device__ __forceinline__ float4 load4(const T* p) {
  if constexpr (IsBf16<T>::v) {
    const float2 w = *reinterpret_cast<const float2*>(p);
    const uint32_t lo = __float_as_uint(w.x), hi = __float_as_uint(w.y);
    return make_float4(__uint_as_float(lo << 16),
                       __uint_as_float(lo & 0xFFFF0000u),
                       __uint_as_float(hi << 16),
                       __uint_as_float(hi & 0xFFFF0000u));
  } else {
    return *reinterpret_cast<const float4*>(p);
  }
}

// TQ: the element type of q and out; T: of K and V (and of the staged q
// rows, widened on load where TQ is bf16 and T fp32)
template <typename TQ, typename T, int D, bool PAGED>
__global__ void __launch_bounds__(THREADS, 3)
decode_kernel(DecodeParams p) {
  constexpr int TK = keys_per_tile<T>();
  constexpr int RS = row_stride<T, D>();
  constexpr int VEC = 16 / (int)sizeof(T);   // elements per 16-byte copy
  constexpr int CPR = D / VEC;               // 16-byte copies per row
  constexpr int D4 = D / 4;                  // 4-column output groups
  const int b = blockIdx.x, hkv = blockIdx.y, sp = blockIdx.z;
  const int G = p.H / p.Hkv;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int qp = p.qpos[b];
  const Layout<T, D> L(G, PAGED);
  unsigned char* sm = dyn_smem();
  T* q_s = reinterpret_cast<T*>(sm);                    // [G][D]
  T* kv_s = reinterpret_cast<T*>(sm + L.kv);            // [2][2][TK][RS]
  float* s_s = reinterpret_cast<float*>(sm + L.s);      // [G][TK]
  float* m_s = reinterpret_cast<float*>(sm + L.m);      // [G]
  float* l_s = m_s + G;                                 // [G]
  float* corr_s = l_s + G;                              // [G]
  int* row_s = reinterpret_cast<int*>(sm + L.row);      // [WIN]
  int* blk_s = reinterpret_cast<int*>(sm + L.blk);      // [WIN + 1]
  int* live_s = reinterpret_cast<int*>(sm + L.live);    // [WIN / TK]

  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  const size_t qbase = ((size_t)b * p.H + (size_t)hkv * G) * D;

  // the group's G query rows (cp.async group 0, or widened loads)
  if constexpr (std::is_same_v<TQ, T>) {
    const T* q = static_cast<const T*>(p.q);
    for (int i = tid; i < G * CPR; i += THREADS)
      cp_async_cg16(q_s + i * VEC, q + qbase + i * VEC, true);
    cp_async_commit();
  } else {
    // bf16 q over fp32 K/V: 8 elements per 16-byte load, each 32-bit word
    // two bf16 (the lower index in the low half), widened exactly
    static_assert(!IsBf16<T>::v && IsBf16<TQ>::v && !PAGED,
                  "bf16 q over fp32 K/V, dense arena only");
    const TQ* q = static_cast<const TQ*>(p.q) + qbase;
    for (int i = tid; i < G * D / 8; i += THREADS) {
      const float4 x = *reinterpret_cast<const float4*>(q + i * 8);
      const uint32_t w[4] = {__float_as_uint(x.x), __float_as_uint(x.y),
                             __float_as_uint(x.z), __float_as_uint(x.w)};
      float4* dst = reinterpret_cast<float4*>(q_s + i * 8);
      dst[0] = make_float4(__uint_as_float(w[0] << 16),
                           __uint_as_float(w[0] & 0xFFFF0000u),
                           __uint_as_float(w[1] << 16),
                           __uint_as_float(w[1] & 0xFFFF0000u));
      dst[1] = make_float4(__uint_as_float(w[2] << 16),
                           __uint_as_float(w[2] & 0xFFFF0000u),
                           __uint_as_float(w[3] << 16),
                           __uint_as_float(w[3] & 0xFFFF0000u));
    }
  }
  for (int g = tid; g < G; g += THREADS) {
    m_s[g] = NEG_INF;
    l_s[g] = 0.f;
  }
  const int nq = G * D4;
  float acc[MAXU][4];
#pragma unroll
  for (int u = 0; u < MAXU; ++u)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[u][e] = 0.f;

  const int k0 = sp * p.keys_per_split;
  const int k1 = k0 + p.keys_per_split < p.S ? k0 + p.keys_per_split : p.S;
  for (int w0 = k0; w0 < k1; w0 += WIN) {
    const int n = k1 - w0 < WIN ? k1 - w0 : WIN;
    const int ntile = (n + TK - 1) / TK;
    __syncthreads();   // the previous window's metadata is consumed
    for (int t = tid; t < ntile; t += THREADS) live_s[t] = 0;

    // ---- key metadata (4-byte copies), then K/V row or -1 per key ----
    if constexpr (PAGED) {
      const int lb0 = w0 / p.bs, nblk = (w0 + n - 1) / p.bs - lb0 + 1;
      const int* rw = p.rows + (size_t)b * p.NBmax + lb0;
      for (int i = tid; i < nblk; i += THREADS)
        cp_async_ca4(blk_s + i, rw + i, true);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      for (int j = tid; j < n; j += THREADS) {
        const int lk = w0 + j, blk = blk_s[lk / p.bs - lb0];
        const size_t slot = (size_t)(blk >= 0 ? blk : 0) * p.bs + lk % p.bs;
        cp_async_ca4(row_s + j, p.kpos + slot, blk >= 0);
      }
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      for (int j = tid; j < ntile * TK; j += THREADS) {
        int r = -1;
        if (j < n) {
          const int lk = w0 + j, blk = blk_s[lk / p.bs - lb0];
          if (blk >= 0 && allowed(qp, row_s[j], p.window))
            r = (int)(((size_t)blk * p.bs + lk % p.bs) * p.kvh + hkv);
        }
        row_s[j] = r;
        if (r >= 0) live_s[j / TK] = 1;   // same value from every writer
      }
    } else {
      const int* kp = p.kpos + (size_t)b * p.S + w0;
      for (int j = tid; j < n; j += THREADS)
        cp_async_ca4(row_s + j, kp + j, true);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      for (int j = tid; j < ntile * TK; j += THREADS) {
        int r = -1;
        if (j < n && allowed(qp, row_s[j], p.window))
          r = (int)(((size_t)b * p.S + w0 + j) * p.Hkv + hkv);
        row_s[j] = r;
        if (r >= 0) live_s[j / TK] = 1;
      }
    }
    __syncthreads();

    auto next_live = [&](int t) {
      while (t < ntile && !live_s[t]) ++t;
      return t;
    };
    // K/V rows of tile t into stage st, one 16-byte copy per (key, lane);
    // masked keys are zero-filled, never read
    auto load_tile = [&](int t, int st) {
      T* kd = kv_s + (size_t)st * 2 * TK * RS;
      T* vd = kd + TK * RS;
      const int* rt = row_s + t * TK;
#pragma unroll 4
      for (int i = tid; i < TK * CPR; i += THREADS) {
        const int j = i / CPR, c = i % CPR, r = rt[j];
        const size_t off = r >= 0 ? (size_t)r * D + c * VEC : 0;
        cp_async_cg16(kd + j * RS + c * VEC, k + off, r >= 0);
        cp_async_cg16(vd + j * RS + c * VEC, v + off, r >= 0);
      }
      cp_async_commit();
    };

    int cur = next_live(0), st = 0;
    if (cur < ntile) load_tile(cur, 0);
    while (cur < ntile) {
      const int nxt = next_live(cur + 1);
      if (nxt < ntile) {
        load_tile(nxt, st ^ 1);
        cp_async_wait<1>();   // tile cur landed; nxt in flight
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const T* kt = kv_s + (size_t)st * 2 * TK * RS;
      const T* vt = kt + TK * RS;
      const int* rt = row_s + cur * TK;

      // scores in log2 units: one (head, key) pair per thread
      for (int pr = tid; pr < G * TK; pr += THREADS) {
        const int g = pr / TK, j = pr % TK;
        s_s[pr] = rt[j] >= 0
                      ? dot_row<T, D>(q_s + g * D, kt + j * RS) * p.scale2
                      : NEG_INF;
      }
      __syncthreads();

      // online softmax: warp w takes heads w, w + 4, ...
      for (int g = warp; g < G; g += NWARP) {
        float* sg = s_s + g * TK;
        float mt = NEG_INF;
        for (int j = lane; j < TK; j += 32) mt = fmaxf(mt, sg[j]);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
        const float m_prev = m_s[g];
        const float m_new = fmaxf(fmaxf(m_prev, mt), NEG_INF / 2);
        float sum = 0.f;
        for (int j = lane; j < TK; j += 32) {
          const float e = exp2f(sg[j] - m_new);
          sg[j] = e;
          sum += e;
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, o);
        if (lane == 0) {
          const float corr = exp2f(m_prev - m_new);
          l_s[g] = l_s[g] * corr + sum;
          corr_s[g] = corr;
          m_s[g] = m_new;
        }
      }
      __syncthreads();

      // P.V: thread owns (head, 4 columns) groups tid, tid + 128, ...;
      // masked keys have p = 0 and zero V rows
#pragma unroll
      for (int u = 0; u < MAXU; ++u) {
        const int o = tid + THREADS * u;
        if (o < nq) {
          const int g = o / D4, d = (o % D4) * 4;
          const float c = corr_s[g];
          float a[4] = {acc[u][0] * c, acc[u][1] * c, acc[u][2] * c,
                        acc[u][3] * c};
          const float* pg = s_s + g * TK;
#pragma unroll 8
          for (int j = 0; j < TK; ++j) {
            const float pj = pg[j];
            const float4 x = load4<T>(vt + j * RS + d);
            a[0] += pj * x.x;
            a[1] += pj * x.y;
            a[2] += pj * x.z;
            a[3] += pj * x.w;
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[u][e] = a[e];
        }
      }
      __syncthreads();   // stage st and the scores are free again
      cur = nxt;
      st ^= 1;
    }
  }
  cp_async_wait<0>();   // q's copies, if no tile was live
  __syncthreads();

  if (p.nsplit == 1) {
    TQ* out = static_cast<TQ*>(p.out);
#pragma unroll
    for (int u = 0; u < MAXU; ++u) {
      const int o = tid + THREADS * u;
      if (o < nq) {
        const float den = fmaxf(l_s[o / D4], 1e-30f);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          out[qbase + 4 * o + e] = from_f<TQ>(acc[u][e] / den);
      }
    }
  } else {
    const size_t rows = (size_t)p.nsplit * p.B * p.H;
    const size_t row0 = ((size_t)sp * p.B + b) * p.H + (size_t)hkv * G;
    float* o_part = p.work;
    float* m_part = o_part + rows * D;
    float* l_part = m_part + rows;
#pragma unroll
    for (int u = 0; u < MAXU; ++u) {
      const int o = tid + THREADS * u;
      if (o < nq)
        *reinterpret_cast<float4*>(o_part + row0 * D + 4 * o) =
            make_float4(acc[u][0], acc[u][1], acc[u][2], acc[u][3]);
    }
    for (int g = tid; g < G; g += THREADS) {
      m_part[row0 + g] = m_s[g];
      l_part[row0 + g] = l_s[g];
    }
  }
}

// One CTA per (request, head): merges the nsplit partial rows in range
// order with the reference's rescaling. Every thread computes the same
// max and denominator in the same order, then 4 output columns. T: the
// element type of out
template <typename T>
__global__ void __launch_bounds__(COMBINE_THREADS)
combine_kernel(DecodeParams p) {
  const int b = blockIdx.x, h = blockIdx.y, D = p.D, ns = p.nsplit;
  const size_t rows = (size_t)ns * p.B * p.H;
  const float* o_part = p.work;
  const float* m_part = o_part + rows * D;
  const float* l_part = m_part + rows;
  auto row = [&](int s) { return ((size_t)s * p.B + b) * p.H + h; };
  float m = NEG_INF;
  for (int s = 0; s < ns; ++s) m = fmaxf(m, m_part[row(s)]);
  m = fmaxf(m, NEG_INF / 2);
  float l = 0.f;
  for (int s = 0; s < ns; ++s) l += exp2f(m_part[row(s)] - m) * l_part[row(s)];
  const float den = fmaxf(l, 1e-30f);
  T* out = static_cast<T*>(p.out) + ((size_t)b * p.H + h) * D;
  for (int d = 4 * threadIdx.x; d < D; d += 4 * COMBINE_THREADS) {
    float a[4] = {0.f, 0.f, 0.f, 0.f};
    for (int s = 0; s < ns; ++s) {
      const float w = exp2f(m_part[row(s)] - m);
      const float4 x =
          *reinterpret_cast<const float4*>(o_part + row(s) * D + d);
      a[0] += w * x.x;
      a[1] += w * x.y;
      a[2] += w * x.z;
      a[3] += w * x.w;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) out[d + e] = from_f<T>(a[e] / den);
  }
}

template <typename TQ, typename T, int D, bool PAGED>
int launch(const DecodeParams& p, cudaStream_t stream) {
  const size_t smem = Layout<T, D>(p.H / p.Hkv, PAGED).total;
  void (*kern)(DecodeParams) = decode_kernel<TQ, T, D, PAGED>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  LAUNCH(kern, dim3(p.B, p.Hkv, p.nsplit), dim3(THREADS), smem, stream)(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.nsplit == 1) return (int)err;
  LAUNCH(combine_kernel<TQ>, dim3(p.B, p.H), dim3(COMBINE_THREADS), 0,
         stream)(p);
  return (int)cudaGetLastError();
}

template <typename TQ, typename T> struct TypeTag {
  using q = TQ;    // q and out
  using kv = T;    // K and V
};
template <int D> struct DimTag { static constexpr int value = D; };

// the element types of type code ``types``: 0 fp32, 1 bf16, 2 bf16 q and
// out over fp32 K/V (dense arena only)
constexpr int TYPES_FP32 = 0, TYPES_BF16 = 1, TYPES_BF16_Q_FP32_KV = 2;

// f(TypeTag<TQ, T>, DimTag<D>) for the (types, D) instantiation; -1 when
// D or the type code is not one of the source's (the paged kernel has no
// mixed one)
template <typename TQ, typename T, typename F>
long long with_dim(int D, F f) {
  switch (D) {
    case 16: return f(TypeTag<TQ, T>(), DimTag<16>());
    case 32: return f(TypeTag<TQ, T>(), DimTag<32>());
    case 64: return f(TypeTag<TQ, T>(), DimTag<64>());
    case 128: return f(TypeTag<TQ, T>(), DimTag<128>());
    case 256: return f(TypeTag<TQ, T>(), DimTag<256>());
  }
  return -1;
}
template <bool PAGED, typename F>
long long with_instance(int types, int D, F f) {
  switch (types) {
    case TYPES_FP32: return with_dim<float, float>(D, f);
    case TYPES_BF16: return with_dim<__nv_bfloat16, __nv_bfloat16>(D, f);
    case TYPES_BF16_Q_FP32_KV:
      if constexpr (!PAGED) return with_dim<__nv_bfloat16, float>(D, f);
  }
  return -1;
}

DecodeParams make_params(const void* q, const void* k, const void* v,
                         const void* qpos, const void* kpos, void* out,
                         void* work, int B, int H, int Hkv, int D,
                         int window, int nsplit) {
  DecodeParams p;
  p.q = q; p.k = k; p.v = v;
  p.qpos = static_cast<const int*>(qpos);
  p.kpos = static_cast<const int*>(kpos);
  p.rows = nullptr;
  p.out = out;
  p.work = static_cast<float*>(work);
  p.B = B; p.H = H; p.Hkv = Hkv; p.D = D; p.window = window;
  p.kvh = Hkv;
  p.S = 0; p.bs = 0; p.NBmax = 0;
  p.nsplit = nsplit; p.keys_per_split = 0;
  p.scale2 = LOG2E / sqrtf((float)D);
  return p;
}

// shapes every launch needs: Hkv | H, G * D <= MAX_GD, 1 <= nsplit <= units
// (key tiles or pool blocks), K/V row indices within int32
bool valid(int B, int H, int Hkv, int D, int nsplit, int units,
           long long kv_rows) {
  return B >= 1 && Hkv >= 1 && H % Hkv == 0 && (H / Hkv) * D <= MAX_GD &&
         nsplit >= 1 && nsplit <= units && kv_rows < (1LL << 31);
}

template <bool PAGED>
int run(const DecodeParams& p, int types, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long r = with_instance<PAGED>(types, p.D, [&](auto tt,
                                                           auto dd) {
    using TT = decltype(tt);
    return (long long)launch<typename TT::q, typename TT::kv,
                             decltype(dd)::value, PAGED>(p, st);
  });
  return r < 0 ? (int)cudaErrorInvalidValue : (int)r;
}

}  // namespace

// Plain C entry points (bound with ctypes, ops.bind): device pointers,
// int32 index tensors, ``types`` the element-type code: 0 fp32, 1 bf16,
// 2 bf16 q and out over fp32 k and v (the dense entry only). ``work`` is
// fp32 scratch of ops.workspace_floats(B, H, D, nsplit) elements (unused
// when nsplit == 1); ``nsplit`` is the number of key ranges
// (ops.num_splits), at most one per key tile (dense: 32 keys in fp32, 64
// in bf16) or per run of pool blocks holding a tile's keys (paged;
// ops.split_units). D must be 16, 32, 64, 128 or 256 and (H / Hkv) * D <=
// 4096. The paged entry's ``kvh`` is the heads a pool slot holds (its
// stride in rows of D), the call covering Hkv <= kvh of them from the
// given base. Return the cudaError_t of the launches.
extern "C" int decode_attention_fwd(
    const void* q, const void* k, const void* v, const void* qpos,
    const void* kpos, void* out, void* work, int B, int S, int H, int Hkv,
    int D, int window, int types, int nsplit, void* stream) {
  const int tk = types == TYPES_BF16 ? keys_per_tile<__nv_bfloat16>()
                                     : keys_per_tile<float>();
  const int ntiles = (S + tk - 1) / tk;
  if (S < 1 || !valid(B, H, Hkv, D, nsplit, ntiles, (long long)B * S * Hkv))
    return (int)cudaErrorInvalidValue;
  DecodeParams p = make_params(q, k, v, qpos, kpos, out, work, B, H, Hkv, D,
                               window, nsplit);
  p.S = S;
  p.keys_per_split = (ntiles + nsplit - 1) / nsplit * tk;
  return run<false>(p, types, stream);
}

extern "C" int paged_decode_attention_fwd(
    const void* q, const void* k_blocks, const void* v_blocks,
    const void* kpos_blocks, const void* block_rows, const void* qpos,
    void* out, void* work, int B, int NB, int NBmax, int bs, int H, int Hkv,
    int kvh, int D, int window, int types, int nsplit, void* stream) {
  // ranges of whole runs of blocks that hold one tile's keys (one block
  // where a block holds a tile or more), so that they start on tiles
  const int tk = types == TYPES_BF16 ? keys_per_tile<__nv_bfloat16>()
                                     : keys_per_tile<float>();
  const int per_run = bs < tk ? tk / bs : 1;   // blocks
  const int nruns = (NBmax + per_run - 1) / per_run;
  if (NBmax < 1 || bs < 1 || kvh < Hkv ||
      !valid(B, H, Hkv, D, nsplit, nruns, (long long)NB * bs * kvh))
    return (int)cudaErrorInvalidValue;
  DecodeParams p = make_params(q, k_blocks, v_blocks, qpos, kpos_blocks, out,
                               work, B, H, Hkv, D, window, nsplit);
  p.rows = static_cast<const int*>(block_rows);
  p.kvh = kvh;
  p.bs = bs;
  p.NBmax = NBmax;
  p.S = NBmax * bs;
  p.keys_per_split = (nruns + nsplit - 1) / nsplit * per_run * bs;
  return run<true>(p, types, stream);
}

// Dynamic shared memory per CTA of the attention kernel, in bytes; -1 on
// an unsupported D or type code.
extern "C" long long decode_attention_smem_bytes(int D, int G, int types,
                                                 int paged) {
  auto f = [&](auto tt, auto dd) {
    using T = typename decltype(tt)::kv;
    return (long long)Layout<T, decltype(dd)::value>(G, paged != 0).total;
  };
  return paged ? with_instance<true>(types, D, f)
               : with_instance<false>(types, D, f);
}

#ifndef CPU_EMULATION
// Resident CTAs per SM of the attention kernel, from the runtime's
// occupancy calculator; -1 on an unsupported D or type code.
template <bool PAGED>
int occupancy(int D, int G, int types) {
  return (int)with_instance<PAGED>(types, D, [&](auto tt, auto dd) {
    using TT = decltype(tt);
    constexpr int DD = decltype(dd)::value;
    void (*kern)(DecodeParams) =
        decode_kernel<typename TT::q, typename TT::kv, DD, PAGED>;
    const size_t smem = Layout<typename TT::kv, DD>(G, PAGED).total;
    int n = -1;
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, THREADS, smem);
    return (long long)n;
  });
}
extern "C" int decode_attention_occupancy(int D, int G, int types,
                                          int paged) {
  return paged ? occupancy<true>(D, G, types)
               : occupancy<false>(D, G, types);
}
#endif
