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
// What bounds it on the H100: per (chunk, head) about L^2 (N + P) +
// 2 L P N flops on the causal triangle against L (P + 1) + 2 L N / H input
// and L P + P N output elements: at L 128, N 128, P 64 some 30 flops per
// byte, so the fp32 CUDA-core rate (67 TFLOP/s) bounds it, not the
// 3.35 TB/s of memory.
//
// What the design does about that: one CTA of 512 threads per (chunk,
// head), as the TPU grid. xdt and B of the chunk are staged in shared
// memory once and every product reads them from there. Each thread keeps a
// 4 x 4 tile of outputs in registers (4 x 2 for y): the 4 rows are the
// warp's own, read as one broadcast float4 from a transposed tile, and the
// 4 columns lie 32 apart, one per lane, so a shared-memory load feeds 4
// FMAs instead of 1 (the first version, one row of 4 per thread, was bound
// by shared-memory loads and slower than the plain version). At ~170 KB of
// shared memory one CTA fills an SM, so the CTA itself is large: 16 warps
// hide the load latency that 8 did not (1.17 -> 0.80 ms on the H100). The
// L x L tile of decay * (C B^T) does not fit beside B and xdt at full
// width, so output rows go in blocks of TR 64 (16 warps x 4 rows): a
// block's C rows and its masked [L, TR] tile are staged, then multiplied
// into y. Key columns above a warp's last row are skipped, and the decay
// is computed only where i >= j (a 0/1 mask multiplied in would turn an
// overflow above the diagonal into inf * 0 = NaN). seg_ij is summed over
// its own segment, not taken as cum_i - cum_j: at mamba2-370m's decay the
// prefix sums reach about -460 over a chunk, and their difference keeps
// ~1e-5 of relative accuracy, which put this kernel and the plain
// version's parallel cumsum 17x outside 3e-5 of each other on the H100.
// One thread per key column j carries the running sum of log_a[j+1..i]
// down the rows of each block; the sums left after the last block are
// seg_{L-1,l}, the chunk-state weights. C B^T does not depend on the head,
// so the H CTAs of a chunk recompute the same scores: redundant work a
// later version can share across heads. No tensor cores, no TMA: later
// work (wgmma on the three products).

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

constexpr int THREADS = 512;     // 16 warps
constexpr int WARPS = THREADS / 32;
constexpr int RI = 4;            // rows per warp in a block
constexpr int TR = WARPS * RI;   // output rows per block
constexpr int TRP = TR + 4;      // row stride of the transposed tiles:
                                 // float4 stores 68 floats apart hit
                                 // distinct banks (ops.py: _TRP)
constexpr int KT = 128;          // columns per tile: 32 lanes x 4

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ inline int round4(int x) { return (x + 3) / 4 * 4; }

// floats of shared memory; ops.py (smem_bytes) checks the same plan. The
// float4 / float2 tiles come first so that each stays 16-byte aligned.
__host__ __device__ inline size_t smem_floats(int L, int N, int P) {
  return (size_t)N * TRP + (size_t)L * TRP + (size_t)L * round4(P) +
         (size_t)L * (N + 1) + 2 * (size_t)L;
}

struct SsdParams {
  const void* xdt;  // [nC, L, H, P]
  const void* la;   // [nC, L, H]
  const void* B;    // [nC, L, N]
  const void* C;    // [nC, L, N]
  float* y;         // [nC, L, H, P]
  float* st;        // [nC, H, P, N]
  int L, H, P, N;
};

// acc[r][k] += sum_n C[r0 + r][n] B[j_k][n] for the warp's 4 rows and the
// lane's NK key columns (bk[k] = row j_k of B in shared memory)
template <int NK>
__device__ __forceinline__ void score_tile(const float* cT,
                                           const float* const* bk, int N,
                                           float (&acc)[RI][4]) {
  for (int n = 0; n < N; ++n) {
    const float4 cv = *reinterpret_cast<const float4*>(cT + n * TRP);
#pragma unroll
    for (int k = 0; k < NK; ++k) {
      const float b = bk[k][n];
      acc[0][k] += cv.x * b;
      acc[1][k] += cv.y * b;
      acc[2][k] += cv.z * b;
      acc[3][k] += cv.w * b;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) ssd_intra_kernel(SsdParams p) {
  const int c = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int L = p.L, H = p.H, P = p.P, N = p.N;
  const int P4 = round4(P), NB = N + 1;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int r0 = warp * RI;  // this warp's rows within a block

  float* cT_s = reinterpret_cast<float*>(dyn_smem());  // [N][TRP]: C^T
  float* mT_s = cT_s + N * TRP;  // [L][TRP]: seg, then decay * scores
  float* x_s = mT_s + L * TRP;   // [L][P4], pad columns 0
  float* b_s = x_s + L * P4;     // [L][N+1]
  float* la_s = b_s + L * NB;    // [L]
  float* col_s = la_s + L;       // [L]

  const T* xdt = static_cast<const T*>(p.xdt);
  const T* la = static_cast<const T*>(p.la);
  const T* B = static_cast<const T*>(p.B);
  const T* C = static_cast<const T*>(p.C);
  const size_t cL = (size_t)c * L;

  // ---- stage xdt[c, :, h, :], B[c] and log_a[c, :, h] ----
  for (int i = tid; i < L * P4; i += THREADS) {
    const int l = i / P4, q = i % P4;
    x_s[i] = q < P ? to_f(xdt[((cL + l) * H + h) * P + q]) : 0.f;
  }
  for (int i = tid; i < L * N; i += THREADS)
    b_s[(i / N) * NB + i % N] = to_f(B[cL * N + i]);
  for (int l = tid; l < L; l += THREADS) {
    la_s[l] = to_f(la[(cL + l) * H + h]);
    col_s[l] = 0.f;  // sum of log_a[l+1 .. i0-1]: empty before block 0
  }

  // ---- y, in blocks of TR output rows ----
  for (int i0 = 0; i0 < L; i0 += TR) {
    const int rows = imin(TR, L - i0);
    const int jmax = i0 + rows;  // keys j <= i < jmax
    __syncthreads();             // staging done / previous block consumed
    for (int i = tid; i < TR * N; i += THREADS) {
      const int r = i / N, n = i % N;
      cT_s[n * TRP + r] = r < rows ? to_f(C[(cL + i0 + r) * N + n]) : 0.f;
    }
    // mT[j][r] = seg_ij for i = i0 + r >= j: column j's running sum
    for (int j = tid; j < jmax; j += THREADS) {
      float sg = col_s[j];
      for (int r = 0; r < rows; ++r) {
        if (i0 + r > j) sg += la_s[i0 + r];
        mT_s[j * TRP + r] = sg;
      }
      col_s[j] = sg;
    }
    __syncthreads();

    // mT[j][r] = exp(seg_ij) * (C_i . B_j) for i = i0 + r >= j, else 0.
    // Lane owns keys j_k = jt0 + lane + 32 k; k runs while the warp's first
    // key of slot k is on or below its last row (warp-uniform count).
    const int ilast = i0 + r0 + RI - 1;
    if (r0 < rows) {
      for (int jt0 = 0; jt0 < jmax; jt0 += KT) {
        int nk = 0;
        while (nk < 4 && jt0 + 32 * nk <= imin(ilast, jmax - 1)) ++nk;
        if (nk == 0) break;
        float acc[RI][4];
#pragma unroll
        for (int r = 0; r < RI; ++r)
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[r][k] = 0.f;
        const float* bk[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          bk[k] = b_s + imin(jt0 + lane + 32 * k, jmax - 1) * NB;
        const float* cT = cT_s + r0;
        switch (nk) {
          case 1: score_tile<1>(cT, bk, N, acc); break;
          case 2: score_tile<2>(cT, bk, N, acc); break;
          case 3: score_tile<3>(cT, bk, N, acc); break;
          default: score_tile<4>(cT, bk, N, acc); break;
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int j = jt0 + lane + 32 * k;
          if (k < nk && j < jmax) {
            float4* m = reinterpret_cast<float4*>(mT_s + j * TRP + r0);
            const float4 sg = *m;
            const float s4[RI] = {sg.x, sg.y, sg.z, sg.w};
            float o[RI];
#pragma unroll
            for (int r = 0; r < RI; ++r)
              o[r] = (r0 + r < rows && i0 + r0 + r >= j)
                         ? expf(s4[r]) * acc[r][k]
                         : 0.f;
            *m = make_float4(o[0], o[1], o[2], o[3]);
          }
        }
      }
    }
    __syncthreads();

    // y[c, i0 + r, h, q] = sum_j m[r][j] xdt[j][q]: the warp's 4 rows, 2
    // columns q per lane, keys up to the warp's last row only
    if (r0 < rows) {
      const int jend = imin(jmax, ilast + 1);
      for (int q0 = 2 * lane; q0 < P4; q0 += 64) {
        float acc[RI][2];
#pragma unroll
        for (int r = 0; r < RI; ++r) acc[r][0] = acc[r][1] = 0.f;
        for (int j = 0; j < jend; ++j) {
          const float4 m = *reinterpret_cast<const float4*>(mT_s + j * TRP +
                                                            r0);
          const float2 xv = *reinterpret_cast<const float2*>(x_s + j * P4 +
                                                             q0);
          acc[0][0] += m.x * xv.x; acc[0][1] += m.x * xv.y;
          acc[1][0] += m.y * xv.x; acc[1][1] += m.y * xv.y;
          acc[2][0] += m.z * xv.x; acc[2][1] += m.z * xv.y;
          acc[3][0] += m.w * xv.x; acc[3][1] += m.w * xv.y;
        }
#pragma unroll
        for (int r = 0; r < RI; ++r)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (r0 + r < rows && q0 + e < P)
              p.y[((cL + i0 + r0 + r) * H + h) * P + q0 + e] = acc[r][e];
      }
    }
  }

  // ---- chunk-end state; col_s[l] now holds seg_{L-1,l} ----
  __syncthreads();
  for (int l = tid; l < L; l += THREADS) col_s[l] = expf(col_s[l]);
  __syncthreads();
  // the warp's 4 rows p of a group, the lane's 4 columns n 32 apart
  for (int p0 = 4 * warp; p0 < P4; p0 += 4 * WARPS) {
    for (int nt0 = 0; nt0 < N; nt0 += KT) {
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[r][k] = 0.f;
      int nc[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) nc[k] = imin(nt0 + lane + 32 * k, N - 1);
      for (int l = 0; l < L; ++l) {
        const float w = col_s[l];
        const float4 xv = *reinterpret_cast<const float4*>(x_s + l * P4 + p0);
        const float x0 = xv.x * w, x1 = xv.y * w, x2 = xv.z * w,
                    x3 = xv.w * w;
        const float* br = b_s + l * NB;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float b = br[nc[k]];
          acc[0][k] += x0 * b;
          acc[1][k] += x1 * b;
          acc[2][k] += x2 * b;
          acc[3][k] += x3 * b;
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int n = nt0 + lane + 32 * k;
          if (p0 + r < P && n < N)
            p.st[(((size_t)c * H + h) * P + p0 + r) * N + n] = acc[r][k];
        }
    }
  }
}

template <typename T>
int launch(const SsdParams& p, int nC, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(p.L, p.N, p.P);
  void (*kern)(SsdParams) = ssd_intra_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  LAUNCH(kern, dim3(nC * p.H), dim3(THREADS), smem, stream)(p);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes): device pointers, is_bf16 selects
// bf16 (1) or fp32 (0) inputs; y and state are fp32. Returns the
// cudaError_t.
extern "C" int ssd_intra_fwd(const void* xdt, const void* log_a,
                             const void* B, const void* C, void* y,
                             void* state, int nC, int L, int H, int P, int N,
                             int is_bf16, void* stream) {
  SsdParams p;
  p.xdt = xdt; p.la = log_a; p.B = B; p.C = C;
  p.y = static_cast<float*>(y);
  p.st = static_cast<float*>(state);
  p.L = L; p.H = H; p.P = P; p.N = N;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(p, nC, st) : launch<float>(p, nC, st);
}
