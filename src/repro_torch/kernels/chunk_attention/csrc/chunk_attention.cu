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
// k_seg -2 / chunk C-1 (the reference wrapper's padding), so the ragged
// edges need no padded copies. The running max is clamped at NEG_INF/2
// and the denominator at 1e-30 (kernel.py:72, :87): a fully masked row
// gives 0 output and 0 mass.
//
// What bounds it on the H100. At the serving path's shapes (A 160-768
// query rows over S 224-1024 keys, H 32 / Hkv 8, D 128) a call is ~1
// GFLOP of unmasked work and a few MB of K/V: bytes bound it at ~3 us in
// bf16, 3xTF32 operations at ~6 us in fp32. The kernel stays far above
// that because each warp walks its key tiles in sequence and there are
// only ~A*H/16 warps (about one per SM sub-core): the time is set by the
// instructions and latencies of one tile step, by load-then-compute
// serialisation, and by how many SMs the grid fills.
//
// What the design does about that:
//  * Tensor cores through mma.sync. bf16: m16n8k16 with fp32 accumulation
//    for Q.K^T and P.V, P rounded to bf16 for P.V as flash kernels do;
//    ldmatrix (x4, and x4.trans for V) feeds the fragments. fp32: 3xTF32
//    on m16n8k8 (x = big + small, each rounded to tf32 to nearest, ties
//    away; big.big + big.small + small.big), which keeps fp32 accuracy
//    (~2^-21 per product); there is no single-pass TF32 path. The two
//    correction products accumulate apart from big.big, so a score tile
//    has two dependent mma chains, not one. The chunk mass is a product
//    too, mass += P . onehot(chunk): the one-hot matrix is exact in both
//    types, and P enters as two terms (big + small) so the mass keeps fp32
//    accuracy. Each key tile's mass products go into an accumulator of
//    their own, added to the running mass in fp32: accumulating every
//    tile into the running sum on the tensor cores drifted low over a
//    long row, while the denominator, summed on the CUDA cores, did not
//    (at recurrentgemma-9b's 2048-key window with 16 heads on one KV
//    head the mass, 16 in one chunk, read 9.5e-5 from the plain
//    version's; test_chunk_cuda_mass_long_rows_unbiased holds it against
//    an fp64 version). Running max, sums and rescaling stay fp32 (exp2
//    of scores scaled by log2 e).
//  * Registers, not shared memory, for S and P: each of the 4 warps owns
//    16 query vectors; the Q.K^T accumulators become P in place and feed
//    the P.V and mass products (the bf16 A fragment of P.V is the C
//    fragment of Q.K^T; for tf32 the keys of a k-step are relabelled so
//    that it is too). All 64 query vectors of a CTA belong to one KV head
//    (G heads x 64/G rows), so each K/V tile is read once for G heads.
//  * The exact tile skip runs once per CTA, before any K/V copy: a pass
//    over the range's k_pos / k_seg against the CTA's 64/G distinct rows
//    marks the tiles with a live (row, key) pair. The tile loop then
//    copies only those, with cp.async into a ring of two stages: K/V rows
//    in 16-byte copies and k_pos / k_seg / k_chunk in 4-byte copies, tile
//    j+1 in flight while tile j is computed. Rows are padded by 16 bytes,
//    which keeps every fragment load free of bank conflicts.
//  * 64-key tiles in bf16 (87 KB of shared memory per CTA at D 128) and
//    32-key tiles in fp32 (100 KB): two CTAs per SM either way.
//  * D 256 (gemma3): a warp holding all 256 output columns would need 128
//    accumulator registers on top of the scores and spill, so each query
//    block has two warps, one per half of the columns (8 warps a CTA).
//    Both form the same scores (Q.K^T over all of D, the same
//    instructions on the same operands, so the same bits) and the same
//    softmax; each multiplies P by its half of V, and the first also keeps
//    the chunk mass. The shared memory (Q and two stages of K/V, 201 KB in
//    fp32, 171 KB in bf16) leaves one CTA per SM. D <= 128 keeps one warp
//    per query block and its code unchanged.
//  * A grid that fills the card: where query blocks x KV heads x batch
//    give fewer CTAs than the dtype's target (3 x 132 in fp32, 132 in
//    bf16; ops.num_splits, from the shapes alone), the keys are split into
//    ranges. Each range writes partial (m, l, acc, mass) rows and a second
//    kernel combines them, and the mass over heads, in a fixed order.
//    Without a split the CTA normalises itself and the second kernel sums
//    the per-KV-head mass. No atomics: the same inputs give the same bits
//    on every launch.
//  * Three instantiations of element types (the C entry's type code):
//    fp32 (0), bf16 (1), and bf16 q and out over fp32 K/V (2), the mix a
//    bf16 model serves with over the engine's fp32 caches, as the
//    reference's kernel takes it (kernel.py upcasts q, K and V to fp32 and
//    writes out in q's dtype). The mix runs the fp32 route: K/V on the same
//    fp32 cp.async ring and key tiles, 3xTF32 products, the mass in fp32;
//    its Q tile is read once per CTA with plain 16-byte loads and widened
//    to the fp32 tile the 3xTF32 path reads (cp.async cannot convert), and
//    the output is rounded to bf16 to nearest even, as astype rounds.
// Later work: wgmma with TMA-fed, warp-specialised stages. In the mix a
// bf16 q has a zero TF32 low part, so one of the three TF32 products of
// Q.K^T (small(q) . big(k)) is exactly zero and could be dropped.

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
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// 4-byte asynchronous copy global -> shared; zero-fills when !pred
__device__ __forceinline__ void cp_async_ca4(void* dst, const void* src,
                                             bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(pred ? 4 : 0));
}
// four 8x8 b16 matrices from shared memory; lane i gives the address of
// row i % 8 of matrix i / 8 and gets, per matrix, the pair (i / 4,
// 2 (i % 4) .. +1); .trans: the pair (2 (i % 4) .. +1, i / 4)
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

constexpr float NEG_INF = -1e30f;
constexpr int NR = 64;        // query vectors (row x head) per CTA
constexpr int WARPS = 4;      // query blocks of 16 vectors per CTA
constexpr int MAXC = 64;      // chunk-mass columns held in registers

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

// two bf16 in one register: lo in the low half (the lower k index)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16(hi)) << 16);
}
__device__ __forceinline__ uint32_t pack_u16(uint16_t lo, uint16_t hi) {
  return (uint32_t)lo | ((uint32_t)hi << 16);
}
// fp32 -> tf32 (10 mantissa bits), round to nearest, ties away from zero:
// the rounding of cvt.rna.tf32.f32 for finite x, in two integer
// operations (the cvt instruction made the fp32 kernel 25% slower on the
// H100). The result is an fp32 bit pattern with the 13 low bits zero.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}
// x = big + small, both tf32 (3xTF32 operand split)
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

struct ChunkParams {
  const void* q;       // [B, A, H, D] (TQ)
  const void* k;       // [B, S, Hkv, D]
  const void* v;       // [B, S, Hkv, D]
  const int* qpos;     // [B, A]
  const int* kpos;     // [B, S]
  const int* kchunk;   // [B, S]
  const int* qseg;     // [B, A]
  const int* kseg;     // [B, S]
  void* out;           // [B, A, H, D] (TQ)
  float* work;         // nsplit 1: mass per KV head [B, Hkv, A, C];
                       // else o [ns,B,A,H,D], m, l [ns,B,A,H], mass
                       // [ns,B,A,H,C] (unnormalised partials)
  int B, A, S, H, Hkv, D, C, window, nsplit, tiles_per_split;
  float scale;
};

// q_pos >= k_pos >= 0, same segment, inside the window; with qp >= 0,
// kp in [0, qp] <=> (unsigned) kp <= (unsigned) qp
__device__ __forceinline__ bool allowed(int qp, int qs, int kp, int ks,
                                        int window) {
  return qp >= 0 && qs == ks && (unsigned)kp <= (unsigned)qp &&
         (window <= 0 || qp - kp < window);
}

// keys per tile: 64 in bf16, 32 in fp32 (two stages of fp32 K/V at 64
// keys would leave one CTA per SM)
template <typename T>
__host__ __device__ constexpr int keys_per_tile() {
  return IsBf16<T>::v ? 64 : 32;
}
// warps per query block, each with D / column_groups output columns
template <int D>
__host__ __device__ constexpr int column_groups() {
  return D > 128 ? 2 : 1;
}
template <int D>
__host__ __device__ constexpr int threads_per_cta() {
  return 32 * WARPS * column_groups<D>();
}
// shared-memory row stride in elements: D plus 16 bytes
template <typename T, int D>
__host__ __device__ constexpr int row_stride() {
  return D + 16 / (int)sizeof(T);
}

template <typename T, int D>
size_t smem_bytes(int C, int tiles_per_split) {
  constexpr int RS = row_stride<T, D>(), BK = keys_per_tile<T>();
  const size_t main = sizeof(T) * (size_t)(NR + 4 * BK) * RS +
                      sizeof(int) * (6 * BK + 2 * NR + tiles_per_split);
  const size_t epi = sizeof(float) * (size_t)NR * 8 * ((C + 7) / 8);
  return main > epi ? main : epi;
}

// TQ: the element type of q and out; T: of K and V, and the route the
// products take (bf16 mma, or 3xTF32 on an fp32 Q tile); CTM: chunk-mass
// column tiles held in registers (C <= 8 CTM)
template <typename TQ, typename T, int D, int CTM>
__global__ void __launch_bounds__(threads_per_cta<D>(),
                                  column_groups<D>() == 1 ? 2 : 1)
chunk_attention_kernel(ChunkParams p) {
  constexpr bool BF = IsBf16<T>::v;
  constexpr int BK = keys_per_tile<T>();
  constexpr int RS = row_stride<T, D>();
  constexpr int VEC = 16 / (int)sizeof(T);   // elements per 16-byte copy
  constexpr int CPR = D / VEC;               // 16-byte copies per row
  constexpr int CG = column_groups<D>();
  constexpr int THREADS = threads_per_cta<D>();
  constexpr int NTD = D / 8 / CG;            // this warp's output col tiles
  constexpr int NTK = BK / 8;                // score column tiles
  const int C = p.C, G = p.H / p.Hkv, CT = (C + 7) / 8;
  const int BQ = NR / G;            // query rows per CTA
  const int nrow = BQ * G;          // live query vectors (<= NR)
  const int qb = blockIdx.x, hkv = blockIdx.y;
  const int b = blockIdx.z / p.nsplit, sp = blockIdx.z % p.nsplit;
  const int tid = threadIdx.x, lane = tid % 32;
  const int warp = tid / 32 % WARPS;          // query block
  const int cg = tid / 32 / WARPS;            // column group
  const int d0 = cg * (D / CG);               // its first output column
  const bool keeps_mass = CG == 1 || cg == 0;
  const int gi = lane / 4, ti = lane % 4;     // fragment row / column

  T* q_s = reinterpret_cast<T*>(dyn_smem());            // [NR][RS]
  T* k_s = q_s + NR * RS;                               // [2][BK][RS]
  T* v_s = k_s + 2 * BK * RS;                           // [2][BK][RS]
  int* meta = reinterpret_cast<int*>(v_s + 2 * BK * RS);  // [2][3][BK]
  int* qpos_s = meta + 6 * BK;                          // [NR]
  int* qseg_s = qpos_s + NR;                            // [NR]
  int* live_s = qseg_s + NR;                            // [tiles_per_split]

  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  const float scale2 = p.scale * 1.4426950408889634f;   // log2 e

  // ---- Q (cp.async group 0, or widened loads) and the row metadata ----
  if constexpr (std::is_same_v<TQ, T>) {
    const T* q = static_cast<const T*>(p.q);
    for (int idx = tid; idx < NR * CPR; idx += THREADS) {
      const int r = idx / CPR, c = idx % CPR;
      const int a = qb * BQ + r / G, g = r % G;
      const bool live = r < nrow && a < p.A;
      const T* src = live ? q + ((size_t)(b * p.A + a) * p.H + hkv * G + g) *
                                    D + c * VEC
                          : q;
      cp_async_cg16(q_s + r * RS + c * VEC, src, live);
    }
    cp_async_commit();
  } else {
    // bf16 q over fp32 K/V: 8 elements per 16-byte load, each 32-bit word
    // two bf16 (the lower index in the low half), widened exactly to fp32
    static_assert(!IsBf16<T>::v && IsBf16<TQ>::v, "bf16 q, fp32 K/V only");
    const TQ* q = static_cast<const TQ*>(p.q);
    constexpr int QPR = D / 8;                 // 16-byte loads per q row
    for (int idx = tid; idx < NR * QPR; idx += THREADS) {
      const int r = idx / QPR, c = idx % QPR;
      const int a = qb * BQ + r / G, g = r % G;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < nrow && a < p.A)
        x = *reinterpret_cast<const float4*>(
            q + ((size_t)(b * p.A + a) * p.H + hkv * G + g) * D + c * 8);
      const uint32_t w[4] = {__float_as_uint(x.x), __float_as_uint(x.y),
                             __float_as_uint(x.z), __float_as_uint(x.w)};
      float4* dst = reinterpret_cast<float4*>(q_s + r * RS + c * 8);
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
  for (int r = tid; r < NR; r += THREADS) {
    const int a = qb * BQ + r / G;
    const bool live = r < nrow && a < p.A;
    qpos_s[r] = live ? p.qpos[b * p.A + a] : -1;
    qseg_s[r] = live ? p.qseg[b * p.A + a] : -1;
  }
  const int ntiles = (p.S + BK - 1) / BK;
  const int t0 = sp * p.tiles_per_split;
  const int t_end = t0 + p.tiles_per_split < ntiles ? t0 + p.tiles_per_split
                                                    : ntiles;
  for (int i = tid; i < p.tiles_per_split; i += THREADS) live_s[i] = 0;
  __syncthreads();

  // ---- exact tile skip, before any K/V copy: a tile is live if one of
  // its keys passes the mask for one of this CTA's BQ query rows ----
  {
    const int s_hi = t_end * BK < p.S ? t_end * BK : p.S;
#pragma unroll 4
    for (int s = t0 * BK + tid; s < s_hi; s += THREADS) {
      const int kp = p.kpos[b * p.S + s], ks = p.kseg[b * p.S + s];
      bool live = false;
      for (int qi = 0; qi < BQ && !live; ++qi)
        live = allowed(qpos_s[qi * G], qseg_s[qi * G], kp, ks, p.window);
      if (live) live_s[s / BK - t0] = 1;    // same value from every writer
    }
  }
  __syncthreads();
  auto next_live = [&](int t) {
    while (t < t_end && !live_s[t - t0]) ++t;
    return t;
  };
  // K/V rows (16-byte copies) and key metadata (4-byte copies) of tile t
  // into stage st; keys past S are zero-filled and masked by position
  auto load_tile = [&](int t, int st) {
    T* kd = k_s + st * BK * RS;
    T* vd = v_s + st * BK * RS;
    for (int idx = tid; idx < BK * CPR; idx += THREADS) {
      const int j = idx / CPR, c = idx % CPR, s = t * BK + j;
      const bool in = s < p.S;
      const size_t off =
          in ? ((size_t)(b * p.S + s) * p.Hkv + hkv) * D + c * VEC : 0;
      cp_async_cg16(kd + j * RS + c * VEC, k + off, in);
      cp_async_cg16(vd + j * RS + c * VEC, v + off, in);
    }
    int* km = meta + st * 3 * BK;
    for (int idx = tid; idx < 3 * BK; idx += THREADS) {
      const int which = idx / BK, j = idx % BK, s = t * BK + j;
      const bool in = s < p.S;
      const int* src = which == 0 ? p.kpos : which == 1 ? p.kseg : p.kchunk;
      cp_async_ca4(km + idx, src + (in ? b * p.S + s : 0), in);
    }
    cp_async_commit();
  };

  // this warp's two fragment rows
  const int rA = warp * 16 + gi, rB = rA + 8;
  const int qpA = qpos_s[rA], qsA = qseg_s[rA];
  const int qpB = qpos_s[rB], qsB = qseg_s[rB];
  float m_r[2] = {NEG_INF, NEG_INF}, l_r[2] = {0.f, 0.f};
  float o[NTD][4], ms[CTM][4];
#pragma unroll
  for (int n = 0; n < NTD; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
#pragma unroll
  for (int n = 0; n < CTM; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) ms[n][e] = 0.f;

  int cur = next_live(t0);
  if (cur < t_end) load_tile(cur, 0);
  int st = 0;
  while (cur < t_end) {
    const int nxt = next_live(cur + 1);
    if (nxt < t_end) {
      load_tile(nxt, st ^ 1);
      cp_async_wait<1>();   // Q and tile cur landed; nxt in flight
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* kt = k_s + st * BK * RS;
    const T* vt = v_s + st * BK * RS;
    const int* km = meta + st * 3 * BK;
    const int* kc = km + 2 * BK;

    // ---- S = Q K^T: 16 rows x BK keys per warp ----
    float s[NTK][4];
#pragma unroll
    for (int j = 0; j < NTK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    if constexpr (BF) {
      // lane l addresses row l % 8 of matrix l / 8: A = Q rows (+8 for
      // matrices 1, 3), cols (+8 for 2, 3); B = K rows of tiles j, j + 1
      // (matrices 2, 3), cols +8 for matrices 1, 3
      const int mi = lane / 8, mr = lane % 8;
      const T* qa = q_s + (warp * 16 + mr + 8 * (mi % 2)) * RS + 8 * (mi / 2);
      const T* ka = kt + (mr + 8 * (mi / 2)) * RS + 8 * (mi % 2);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t a[4];
        ldmatrix_x4(a, qa + kk * 16);
#pragma unroll
        for (int j = 0; j < NTK; j += 2) {
          uint32_t bb[4];
          ldmatrix_x4(bb, ka + 8 * j * RS + kk * 16);
          mma_m16n8k16_bf16(s[j], a, bb);
          mma_m16n8k16_bf16(s[j + 1], a, bb + 2);
        }
      }
    } else {
      // the correction terms (small.big + big.small) in their own
      // accumulators: two dependent mma chains per score tile, not one
      float s2[NTK][4];
#pragma unroll
      for (int j = 0; j < NTK; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s2[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        const T* q0 = q_s + rA * RS + kk * 8 + ti;
        const float af[4] = {q0[0], q0[8 * RS], q0[4], q0[8 * RS + 4]};
        uint32_t ab[4], as[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(af[e], ab[e], as[e]);
#pragma unroll
        for (int j = 0; j < NTK; ++j) {
          const T* k0 = kt + (8 * j + gi) * RS + kk * 8 + ti;
          uint32_t bb[2], bs[2];
          split_tf32(k0[0], bb[0], bs[0]);
          split_tf32(k0[4], bb[1], bs[1]);
          mma_m16n8k8_tf32(s2[j], as, bb);
          mma_m16n8k8_tf32(s2[j], ab, bs);
          mma_m16n8k8_tf32(s[j], ab, bb);
        }
      }
#pragma unroll
      for (int j = 0; j < NTK; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] += s2[j][e];
    }

    // ---- mask, online softmax (4 lanes share a row) ----
    // scores in log2 units (scale * log2 e), so exp2f gives the softmax
    float mt[2] = {NEG_INF, NEG_INF};
    const int keys_in = p.S - cur * BK;
#pragma unroll
    for (int j = 0; j < NTK; ++j)
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int key = 8 * j + 2 * ti + jj;
        const int kp = km[key], ks = km[BK + key];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const bool ok =
              key < keys_in && allowed(i ? qpB : qpA, i ? qsB : qsA, kp, ks,
                                       p.window);
          float& x = s[j][2 * i + jj];
          x = ok ? x * scale2 : NEG_INF;
          mt[i] = fmaxf(mt[i], x);
        }
      }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 1));
      mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 2));
      const float m_new = fmaxf(fmaxf(m_r[i], mt[i]), NEG_INF / 2);
      corr[i] = exp2f(m_r[i] - m_new);
      m_r[i] = m_new;
      l_r[i] *= corr[i];
    }
#pragma unroll
    for (int j = 0; j < NTK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f(s[j][e] - m_r[e / 2]);
        l_r[e / 2] += s[j][e];          // this lane's share of the row
      }
#pragma unroll
    for (int n = 0; n < NTD; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] *= corr[e / 2];
#pragma unroll
    for (int n = 0; n < CTM; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) ms[n][e] *= corr[e / 2];

    // ---- O += P V, mass += P onehot(chunk) ----
    if constexpr (BF) {
      constexpr uint16_t ONE = 0x3F80;   // 1.0 in bf16
      // lane l addresses V row 16 kk + l % 8 (+8 for matrices 1, 3) at
      // column tile n (+1 for matrices 2, 3); .trans yields b0, b1 of n
      // and of n + 1
      const int mi = lane / 8, mr = lane % 8;
      const T* va = vt + (mr + 8 * (mi % 2)) * RS + 8 * (mi / 2);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const float* s0 = s[2 * kk];
        const float* s1 = s[2 * kk + 1];
        const uint32_t a[4] = {pack_bf16(s0[0], s0[1]),
                               pack_bf16(s0[2], s0[3]),
                               pack_bf16(s1[0], s1[1]),
                               pack_bf16(s1[2], s1[3])};
        const int k0 = 16 * kk + 2 * ti;        // keys k0, k0+1, k0+8, k0+9
#pragma unroll
        for (int n = 0; n < NTD; n += 2) {
          uint32_t bb[4];
          ldmatrix_x4_trans(bb, va + 16 * kk * RS + d0 + 8 * n);
          mma_m16n8k16_bf16(o[n], a, bb);
          mma_m16n8k16_bf16(o[n + 1], a, bb + 2);
        }
      }
      // mass: P = hi + lo, both bf16, against the exact one-hot; the
      // tile's sum in its own accumulator
#pragma unroll
      for (int n = 0; n < CTM; ++n) {
        if (!keeps_mass) break;
        const int c = 8 * n + gi;
        float tm[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          const float* s0 = s[2 * kk];
          const float* s1 = s[2 * kk + 1];
          const uint32_t a[4] = {pack_bf16(s0[0], s0[1]),
                                 pack_bf16(s0[2], s0[3]),
                                 pack_bf16(s1[0], s1[1]),
                                 pack_bf16(s1[2], s1[3])};
          uint32_t alo[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float* sx = e < 2 ? s0 : s1;
            const int i0 = (e & 1) * 2;
            const float h0 = __bfloat162float(__float2bfloat16(sx[i0]));
            const float h1 =
                __bfloat162float(__float2bfloat16(sx[i0 + 1]));
            alo[e] = pack_bf16(sx[i0] - h0, sx[i0 + 1] - h1);
          }
          const int k0 = 16 * kk + 2 * ti;
          const uint32_t bb[2] = {
              pack_u16(kc[k0] == c ? ONE : 0, kc[k0 + 1] == c ? ONE : 0),
              pack_u16(kc[k0 + 8] == c ? ONE : 0,
                       kc[k0 + 9] == c ? ONE : 0)};
          mma_m16n8k16_bf16(tm, alo, bb);
          mma_m16n8k16_bf16(tm, a, bb);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) ms[n][e] += tm[e];
      }
    } else {
      const float* vf = reinterpret_cast<const float*>(vt);
#pragma unroll
      for (int j = 0; j < NTK; ++j) {
        // k-step over keys 8j..8j+7, relabelled so that k index ti holds
        // key 2ti and ti+4 holds key 2ti+1: the A fragment is then the C
        // fragment of S as it stands
        const float af[4] = {s[j][0], s[j][2], s[j][1], s[j][3]};
        uint32_t ab[4], as[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(af[e], ab[e], as[e]);
        const int k0 = 8 * j + 2 * ti;
#pragma unroll
        for (int n = 0; n < NTD; ++n) {
          const int d = d0 + 8 * n + gi;
          uint32_t bb[2], bs[2];
          split_tf32(vf[k0 * RS + d], bb[0], bs[0]);
          split_tf32(vf[(k0 + 1) * RS + d], bb[1], bs[1]);
          mma_m16n8k8_tf32(o[n], as, bb);
          mma_m16n8k8_tf32(o[n], ab, bs);
          mma_m16n8k8_tf32(o[n], ab, bb);
        }
      }
      // mass: P = big + small against the exact one-hot; the tile's sum
      // in its own accumulator
#pragma unroll
      for (int n = 0; n < CTM; ++n) {
        if (!keeps_mass) break;
        const int c = 8 * n + gi;
        float tm[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int j = 0; j < NTK; ++j) {
          const float af[4] = {s[j][0], s[j][2], s[j][1], s[j][3]};
          uint32_t ab[4], as[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) split_tf32(af[e], ab[e], as[e]);
          const int k0 = 8 * j + 2 * ti;
          const uint32_t bb[2] = {kc[k0] == c ? 0x3F800000u : 0u,
                                  kc[k0 + 1] == c ? 0x3F800000u : 0u};
          mma_m16n8k8_tf32(tm, as, bb);
          mma_m16n8k8_tf32(tm, ab, bb);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) ms[n][e] += tm[e];
      }
    }
    __syncthreads();   // stage st is free again
    cur = nxt;
    st ^= 1;
  }
  cp_async_wait<0>();  // Q's copies, if no tile was live
  __syncthreads();

  // ---- epilogue ----
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 1);
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 2);
  }
  if (p.nsplit == 1) {
    TQ* out = static_cast<TQ*>(p.out);
    float* ms_s = reinterpret_cast<float*>(dyn_smem());   // [NR][8 CT]
    const int CP = 8 * CT;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = i ? rB : rA;
      const int a = qb * BQ + r / G, g = r % G;
      const float inv_l = 1.f / fmaxf(l_r[i], 1e-30f);
      if (r < nrow && a < p.A) {
        TQ* orow = out + ((size_t)(b * p.A + a) * p.H + hkv * G + g) * D;
#pragma unroll
        for (int n = 0; n < NTD; ++n) {
          orow[d0 + 8 * n + 2 * ti] = from_f<TQ>(o[n][2 * i] * inv_l);
          orow[d0 + 8 * n + 2 * ti + 1] =
              from_f<TQ>(o[n][2 * i + 1] * inv_l);
        }
      }
#pragma unroll
      for (int n = 0; n < CTM; ++n)
        if (keeps_mass && n < CT) {
          ms_s[r * CP + 8 * n + 2 * ti] = ms[n][2 * i] * inv_l;
          ms_s[r * CP + 8 * n + 2 * ti + 1] = ms[n][2 * i + 1] * inv_l;
        }
    }
    __syncthreads();
    for (int idx = tid; idx < BQ * C; idx += THREADS) {
      const int qi = idx / C, c = idx % C, a = qb * BQ + qi;
      if (a >= p.A) continue;
      float sum = 0.f;
      for (int g = 0; g < G; ++g) sum += ms_s[(qi * G + g) * CP + c];
      p.work[((size_t)(b * p.Hkv + hkv) * p.A + a) * C + c] = sum;
    }
  } else {
    const size_t rows = (size_t)p.nsplit * p.B * p.A * p.H;
    float* o_part = p.work;
    float* m_part = o_part + rows * D;
    float* l_part = m_part + rows;
    float* mass_part = l_part + rows;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = i ? rB : rA;
      const int a = qb * BQ + r / G, g = r % G;
      if (r >= nrow || a >= p.A) continue;
      const size_t row =
          ((size_t)(sp * p.B + b) * p.A + a) * p.H + hkv * G + g;
      if (ti == 0 && keeps_mass) {
        m_part[row] = m_r[i];
        l_part[row] = l_r[i];
      }
#pragma unroll
      for (int n = 0; n < NTD; ++n) {
        o_part[row * D + d0 + 8 * n + 2 * ti] = o[n][2 * i];
        o_part[row * D + d0 + 8 * n + 2 * ti + 1] = o[n][2 * i + 1];
      }
      if (!keeps_mass) continue;
#pragma unroll
      for (int n = 0; n < CTM; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * n + 2 * ti + e;
          if (c < C) mass_part[row * C + c] = ms[n][2 * i + e];
        }
    }
  }
}

// mass[b, a, c] = sum over kv heads, in order, of the per-head partials
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

// One CTA per (a, b): merges the nsplit key ranges of every head (max,
// rescaled sums, in split order), then sums the mass over heads in order.
// T: the element type of out
template <typename T>
__global__ void combine_kernel(ChunkParams p, float* mass) {
  const int a = blockIdx.x, b = blockIdx.y, H = p.H, D = p.D, C = p.C;
  const int ns = p.nsplit;
  const size_t rows = (size_t)ns * p.B * p.A * H;
  const float* o_part = p.work;
  const float* m_part = o_part + rows * D;
  const float* l_part = m_part + rows;
  const float* mass_part = l_part + rows;
  float* w_s = reinterpret_cast<float*>(dyn_smem());   // [ns][H]
  float* inv_s = w_s + ns * H;                          // [H]
  float* mh_s = inv_s + H;                              // [H][C]
  auto row = [&](int s, int h) {
    return ((size_t)(s * p.B + b) * p.A + a) * H + h;
  };
  for (int h = threadIdx.x; h < H; h += blockDim.x) {
    float m = NEG_INF;
    for (int s = 0; s < ns; ++s) m = fmaxf(m, m_part[row(s, h)]);
    m = fmaxf(m, NEG_INF / 2);
    float l = 0.f;
    for (int s = 0; s < ns; ++s) {
      const float w = exp2f(m_part[row(s, h)] - m);   // log2 units
      w_s[s * H + h] = w;
      l += w * l_part[row(s, h)];
    }
    inv_s[h] = 1.f / fmaxf(l, 1e-30f);
  }
  __syncthreads();
  T* out = static_cast<T*>(p.out);
  // normalised output, 4 columns (16 bytes of each partial) per thread
  const int D4 = D / 4;
#pragma unroll 4
  for (int idx = threadIdx.x; idx < H * D4; idx += blockDim.x) {
    const int h = idx / D4, d = 4 * (idx % D4);
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int s = 0; s < ns; ++s) {
      const float4 x =
          *reinterpret_cast<const float4*>(o_part + row(s, h) * D + d);
      const float w = w_s[s * H + h];
      acc[0] += w * x.x;
      acc[1] += w * x.y;
      acc[2] += w * x.z;
      acc[3] += w * x.w;
    }
    T* dst = out + ((size_t)(b * p.A + a) * H + h) * D + d;
#pragma unroll
    for (int e = 0; e < 4; ++e) dst[e] = from_f<T>(acc[e] * inv_s[h]);
  }
  // normalised mass per (h, c)
  for (int idx = threadIdx.x; idx < H * C; idx += blockDim.x) {
    const int h = idx / C, c = idx % C;
    float hm = 0.f;
    for (int s = 0; s < ns; ++s)
      hm += w_s[s * H + h] * mass_part[row(s, h) * C + c];
    mh_s[h * C + c] = hm * inv_s[h];
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float sum = 0.f;
    for (int h = 0; h < H; ++h) sum += mh_s[h * C + c];
    mass[((size_t)b * p.A + a) * C + c] = sum;
  }
}

// the attention kernel for (TQ, T, D) and C chunks: 2 mass tiles when
// C <= 16
template <typename TQ, typename T, int D>
void (*kernel_for(int C))(ChunkParams) {
  return C <= 16 ? chunk_attention_kernel<TQ, T, D, 2>
                 : chunk_attention_kernel<TQ, T, D, MAXC / 8>;
}

template <typename TQ, typename T, int D>
int launch(const ChunkParams& p, float* mass, cudaStream_t stream) {
  const int G = p.H / p.Hkv;
  const int BQ = NR / G;
  const size_t smem = smem_bytes<T, D>(p.C, p.tiles_per_split);
  void (*kern)(ChunkParams) = kernel_for<TQ, T, D>(p.C);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((p.A + BQ - 1) / BQ, p.Hkv, p.B * p.nsplit);
  LAUNCH(kern, grid, dim3(threads_per_cta<D>()), smem, stream)(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (p.nsplit == 1) {
    const size_t n = (size_t)p.B * p.A * p.C;
    const int blocks =
        (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
    LAUNCH(mass_reduce_kernel, dim3(blocks > 0 ? blocks : 1), dim3(256), 0,
           stream)(p.work, mass, p.B, p.Hkv, p.A, p.C);
  } else {
    const size_t csmem =
        sizeof(float) * (size_t)(p.nsplit + 1 + p.C) * p.H;
    LAUNCH(combine_kernel<TQ>, dim3(p.A, p.B), dim3(256), csmem,
           stream)(p, mass);
  }
  return (int)cudaGetLastError();
}

template <typename TQ, typename T> struct TypeTag {
  using q = TQ;    // q and out
  using kv = T;    // K and V
};
template <int D> struct DimTag { static constexpr int value = D; };

// the element types of type code ``types``: 0 fp32, 1 bf16, 2 bf16 q and
// out over fp32 K/V
constexpr int TYPES_FP32 = 0, TYPES_BF16 = 1, TYPES_BF16_Q_FP32_KV = 2;

// f(TypeTag<TQ, T>, DimTag<D>) for the instantiation of ``types`` and D;
// -1 when either is not one of the source's
template <typename TQ, typename T, typename F>
int with_dim(int D, F f) {
  switch (D) {
    case 32: return f(TypeTag<TQ, T>(), DimTag<32>());
    case 64: return f(TypeTag<TQ, T>(), DimTag<64>());
    case 128: return f(TypeTag<TQ, T>(), DimTag<128>());
    case 256: return f(TypeTag<TQ, T>(), DimTag<256>());
  }
  return -1;
}
template <typename F>
int with_instance(int types, int D, F f) {
  switch (types) {
    case TYPES_FP32: return with_dim<float, float>(D, f);
    case TYPES_BF16: return with_dim<__nv_bfloat16, __nv_bfloat16>(D, f);
    case TYPES_BF16_Q_FP32_KV: return with_dim<__nv_bfloat16, float>(D, f);
  }
  return -1;
}
// f(kernel, shared memory bytes, threads) of the attention kernel
template <typename F>
int with_kernel(int types, int D, int C, int tiles_per_split, F f) {
  return with_instance(types, D, [&](auto tt, auto dd) {
    using TT = decltype(tt);
    constexpr int DD = decltype(dd)::value;
    using TQ = typename TT::q;
    using T = typename TT::kv;
    return f(kernel_for<TQ, T, DD>(C), smem_bytes<T, DD>(C, tiles_per_split),
             threads_per_cta<DD>());
  });
}

}  // namespace

// Plain C entry point (bound with ctypes). Pointers are device pointers;
// int tensors are int32; ``types`` is the element-type code: 0 fp32 q / k
// / v / out, 1 bf16, 2 bf16 q and out over fp32 k and v. The mass is fp32
// in all three. ``work`` is fp32 scratch of ops.workspace_floats(...)
// elements, ``nsplit`` the number of key ranges (ops.num_splits; at most
// one per key tile of 64 keys in bf16 K/V, 32 in fp32). D must be 32, 64,
// 128 or 256, H / Hkv <= 64, C <= 64. Returns the cudaError_t of the
// launches (0 = success).
extern "C" int chunk_attention_fwd(
    const void* q, const void* k, const void* v, const void* qpos,
    const void* kpos, const void* kchunk, const void* qseg, const void* kseg,
    void* out, void* work, void* mass, int B, int A, int S, int H, int Hkv,
    int D, int C, int window, int types, int nsplit, void* stream) {
  const int BK = types == TYPES_BF16 ? keys_per_tile<__nv_bfloat16>()
                                     : keys_per_tile<float>();
  const int ntiles = (S + BK - 1) / BK;
  if (B < 1 || A < 1 || S < 1 || Hkv < 1 || H % Hkv || H / Hkv > NR ||
      C < 1 || C > MAXC || nsplit < 1 || nsplit > ntiles)
    return (int)cudaErrorInvalidValue;
  ChunkParams p;
  p.q = q; p.k = k; p.v = v;
  p.qpos = static_cast<const int*>(qpos);
  p.kpos = static_cast<const int*>(kpos);
  p.kchunk = static_cast<const int*>(kchunk);
  p.qseg = static_cast<const int*>(qseg);
  p.kseg = static_cast<const int*>(kseg);
  p.out = out;
  p.work = static_cast<float*>(work);
  p.B = B; p.A = A; p.S = S; p.H = H; p.Hkv = Hkv; p.D = D; p.C = C;
  p.window = window;
  p.nsplit = nsplit;
  p.tiles_per_split = (ntiles + nsplit - 1) / nsplit;
  p.scale = 1.0f / sqrtf((float)D);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* m = static_cast<float*>(mass);
  const int err = with_instance(types, D, [&](auto tt, auto dd) {
    using TT = decltype(tt);
    return launch<typename TT::q, typename TT::kv, decltype(dd)::value>(
        p, m, st);
  });
  return err < 0 ? (int)cudaErrorInvalidValue : err;
}

// Dynamic shared memory per CTA of the attention kernel, in bytes, for a
// key range of tiles_per_split tiles; -1 on an unsupported D or type code.
extern "C" long long chunk_attention_smem_bytes(int D, int C, int types,
                                                int tiles_per_split) {
  return with_kernel(types, D, C, tiles_per_split,
                     [](void (*)(ChunkParams), size_t smem, int) {
                       return (int)smem;
                     });
}

#ifndef CPU_EMULATION
// Resident CTAs per SM of the attention kernel, from the runtime's
// occupancy calculator; -1 on an unsupported D or type code.
extern "C" int chunk_attention_occupancy(int D, int C, int types,
                                         int tiles_per_split) {
  return with_kernel(types, D, C, tiles_per_split,
                     [](void (*kern)(ChunkParams), size_t smem,
                        int threads) {
                       int n = -1;
                       cudaFuncSetAttribute(
                           kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
                       cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                           &n, kern, threads, smem);
                       return n;
                     });
}
#endif
