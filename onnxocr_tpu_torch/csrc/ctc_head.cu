// Fused CTC head for Hopper (sm_90a): (M, D) @ (D, V) + b -> per-row
// first-index argmax (int32) and softmax max-prob 1 / sum(exp(l - max)),
// without ever writing the (M, V) logits to device memory.
//
// Replaces: onnxocr_tpu/ops/pallas/ctc_head.py, ctc_head_reduce (Pallas
// body _kernel), which keeps each (BM, BV) logits tile in VMEM and carries
// a running (max, argmax, sum-exp) across the sequential vocab grid axis.
//
// What bounds it on an H100: arithmetic. At the main path's shape
// (M = 48 crops x 80 steps = 3840, D = 192, V = 18385) the product is
// 2*M*D*V = 27.1 GFLOP and ~70.6 M exp, against 17 MB of input (W 14.1 MB,
// x 2.9 MB). In float32 outside the tensor cores that is ~0.4 ms at the
// published 67 TFLOP/s, while the bytes take ~5 us at 3.35 TB/s.
//
// Design: blocks run unordered on 132 SMs, so the TPU's sequential vocab
// sweep becomes (a) a loop over vocab tiles inside each block and (b) a
// split of the vocab range over grid.y, merged by a second tiny kernel.
// Each block owns BM = 64 rows; per k-chunk it stages x (BK x BM) and W
// (BK x BN) in shared memory and each thread accumulates a TM x TN = 8 x 4
// register tile of logits with float32 FMAs. Thread (warp r, lane c) owns
// rows r + 8i and columns c + 32j of the tile, so W reads are consecutive
// across a warp and the 32 lanes of a warp hold the same 8 rows. After
// each tile every thread folds its logits into per-row running
// (max, argmax, sum-exp) in increasing column order, replacing the argmax
// only on a strictly greater value (first index wins ties, as in _kernel);
// at the end a warp shuffle merges the 32 lanes, again preferring the
// smaller column on equal maxima. Columns >= V are skipped, not padded.
// This is a simple SIMT kernel: no wgmma, TMA or TF32.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 128;
constexpr int BK = 16;
constexpr int TM = 8;
constexpr int TN = 4;
constexpr int THREADS = 256;  // (BM / TM) warps x (BN / TN) lanes

// Merge running state (m2, s2, a2) into (m, s, a). s == 0 marks a state
// that has seen no column yet (any real state has s >= 1).
__device__ __forceinline__ void merge(float& m, float& s, int& a,
                                      float m2, float s2, int a2) {
  if (s2 == 0.f) return;
  if (s == 0.f) {
    m = m2;
    s = s2;
    a = a2;
    return;
  }
  const float mn = fmaxf(m, m2);
  if (m2 > m || (m2 == m && a2 < a)) a = a2;
  s = s * expf(m - mn) + s2 * expf(m2 - mn);
  m = mn;
}

__global__ void __launch_bounds__(THREADS)
ctc_head_partial(const float* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ b, int M, int D, int V,
                 int tiles_per_split, float* __restrict__ part_m,
                 float* __restrict__ part_s, int* __restrict__ part_a) {
  __shared__ float xs[BK][BM + 1];
  __shared__ float ws[BK][BN];
  const int tid = threadIdx.x;
  const int tr = tid / 32;
  const int tc = tid % 32;
  const int m0 = blockIdx.x * BM;
  const int split = blockIdx.y;
  const int n_splits = gridDim.y;
  const int n_tiles = (V + BN - 1) / BN;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(n_tiles, t_begin + tiles_per_split);

  float rm[TM], rs[TM];
  int ra[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    rm[i] = -INFINITY;
    rs[i] = 0.f;
    ra[i] = 0;
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int v0 = t * BN;
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < D; k0 += BK) {
#pragma unroll
      for (int q = 0; q < (BM * BK) / THREADS; ++q) {
        const int idx = tid + q * THREADS;
        const int r = idx / BK;
        const int k = idx % BK;
        const int row = m0 + r;
        xs[k][r] = row < M ? x[(size_t)row * D + k0 + k] : 0.f;
      }
#pragma unroll
      for (int q = 0; q < (BK * BN) / THREADS; ++q) {
        const int idx = tid + q * THREADS;
        const int k = idx / BN;
        const int c = idx % BN;
        const int col = v0 + c;
        ws[k][c] = col < V ? w[(size_t)(k0 + k) * V + col] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < BK; ++k) {
        float xv[TM], wv[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) xv[i] = xs[k][tr + 8 * i];
#pragma unroll
        for (int j = 0; j < TN; ++j) wv[j] = ws[k][tc + 32 * j];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(xv[i], wv[j], acc[i][j]);
      }
      __syncthreads();
    }

    // online (max, argmax, sum-exp), columns in increasing order per row
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = v0 + tc + 32 * j;
      if (col < V) {
        const float bias = b[col];
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float l = acc[i][j] + bias;
          if (l > rm[i]) {
            rs[i] = rs[i] * expf(rm[i] - l) + 1.f;
            rm[i] = l;
            ra[i] = col;
          } else {
            rs[i] += expf(l - rm[i]);
          }
        }
      }
    }
  }

  // the 32 lanes of this warp share rows tr + 8i: merge them
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, rm[i], off);
      const float s2 = __shfl_xor_sync(0xffffffffu, rs[i], off);
      const int a2 = __shfl_xor_sync(0xffffffffu, ra[i], off);
      merge(rm[i], rs[i], ra[i], m2, s2, a2);
    }
    const int row = m0 + tr + 8 * i;
    if (tc == 0 && row < M) {
      const size_t o = (size_t)row * n_splits + split;
      part_m[o] = rm[i];
      part_s[o] = rs[i];
      part_a[o] = ra[i];
    }
  }
}

__global__ void ctc_head_combine(const float* __restrict__ part_m,
                                 const float* __restrict__ part_s,
                                 const int* __restrict__ part_a, int M,
                                 int n_splits, int* __restrict__ idx,
                                 float* __restrict__ prob) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= M) return;
  float m = -INFINITY, s = 0.f;
  int a = 0;
  for (int sp = 0; sp < n_splits; ++sp) {
    const size_t o = (size_t)row * n_splits + sp;
    merge(m, s, a, part_m[o], part_s[o], part_a[o]);
  }
  idx[row] = a;
  prob[row] = 1.f / s;
}

}  // namespace

// x (M, D), w (D, V), b (V,) float32 row-major; D % 16 == 0.
// part_* are (M, n_splits) scratch; idx (M,) int32, prob (M,) float32.
// Returns cudaGetLastError() after both launches.
extern "C" int ctc_head_reduce(const float* x, const float* w, const float* b,
                               int M, int D, int V, int n_splits,
                               float* part_m, float* part_s, int* part_a,
                               int* idx, float* prob, cudaStream_t stream) {
  const int n_tiles = (V + BN - 1) / BN;
  const int tiles_per_split = (n_tiles + n_splits - 1) / n_splits;
  const dim3 grid((M + BM - 1) / BM, n_splits);
  ctc_head_partial<<<grid, THREADS, 0, stream>>>(
      x, w, b, M, D, V, tiles_per_split, part_m, part_s, part_a);
  ctc_head_combine<<<(M + 255) / 256, 256, 0, stream>>>(
      part_m, part_s, part_a, M, n_splits, idx, prob);
  return (int)cudaGetLastError();
}
