// Label-keyed DB-extraction reductions for Hopper (sm_90a).
//
// Replaces: onnxocr_tpu/ops/pallas/seg_reduce2.py, label_moment_sums (Pallas
// body _sum_kernel_wrap) and label_proj_extents (body _min_kernel_wrap).
// For each kept component id ids[k] (ascending raster seeds, INT_MAX =
// empty slot) they reduce over the working-grid cells whose label equals
// ids[k]:
//   sums:    [n, sum x, sum y, sum x^2, sum y^2, sum xy, sum p]
//   extents: mins of [pu, pv, -pu, -pv], pu = ux*x + uy*y, pv = ux*y - uy*x
// with (x, y) the cell centre in full map coordinates under (sy, sx).
//
// What bounds them on an H100: bytes. A 960x480 grid (the 960^2 canvas on
// the 1x2 grid) is 460,800 cells: 1.8 MB of labels for either kernel, plus
// the map's value at the labelled cells only for the sums (a few per cent
// of a text page), under a microsecond at 3.35 TB/s, and a handful of
// integer operations per cell.
//
// Design: the Pallas kernels walk a (128-id tile x 8192-cell band) grid in
// order and skip tiles whose id range misses the band. Blocks here run in
// parallel and unordered, so each block takes a run of CELLS consecutive
// cells instead: it maps every positive label to its slot by binary search
// in the sorted ids (labels compare as int32, exact at any size), finds the
// slot range its cells touch, and - since raster-local cells touch a narrow
// range, the same locality the band skip relies on - accumulates into a
// shared-memory window over that range, then flushes the touched slots to
// device memory with one atomic per slot and channel. A block whose range
// exceeds the window adds straight to device memory. Sums accumulate in
// float64 (shared and global atomics), so their order cannot move the
// float32 result beyond one rounding. Mins use atomicMin on an
// order-preserving int image of the float, which is order-independent;
// the projections are computed without FMA contraction so they round as
// the plain PyTorch version does.
#include <cuda_runtime.h>
#include <limits.h>

namespace {

constexpr int THREADS = 256;
constexpr int PER = 16;                  // cells per thread
constexpr int CELLS = THREADS * PER;     // cells per block
constexpr int WIN = 512;                 // shared slot window
constexpr float BIG = 3.4e38f;

__device__ __forceinline__ int find_slot(const int* __restrict__ ids, int K,
                                         int label) {
  int lo = 0, hi = K;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (ids[mid] < label)
      lo = mid + 1;
    else
      hi = mid;
  }
  return (lo < K && ids[lo] == label) ? lo : -1;
}

// float <-> int with the same order (an involution on the negative half)
__device__ __forceinline__ int ord_of(float f) {
  const int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}
__device__ __forceinline__ float float_of(int i) {
  return __int_as_float(i >= 0 ? i : i ^ 0x7fffffff);
}

// Load this thread's PER cells, map them to slots and reduce the block's
// slot range into (*s_lo, *s_hi). Returns after a __syncthreads().
__device__ __forceinline__ void load_slots(const int* __restrict__ lab,
                                           const int* __restrict__ ids, int K,
                                           long long n, long long base,
                                           int slot[PER], int* s_lo,
                                           int* s_hi) {
  const int tid = threadIdx.x;
  if (tid == 0) {
    *s_lo = INT_MAX;
    *s_hi = -1;
  }
  __syncthreads();
  int lo = INT_MAX, hi = -1;
#pragma unroll
  for (int p = 0; p < PER; ++p) {
    const long long i = base + (long long)p * THREADS + tid;
    int s = -1;
    if (i < n) {
      const int l = lab[i];
      if (l > 0) s = find_slot(ids, K, l);
    }
    slot[p] = s;
    if (s >= 0) {
      lo = min(lo, s);
      hi = max(hi, s);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
  }
  if ((tid & 31) == 0 && hi >= 0) {
    atomicMin(s_lo, lo);
    atomicMax(s_hi, hi);
  }
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS)
moment_sums_kernel(const int* __restrict__ lab, const float* __restrict__ prob,
                   const int* __restrict__ ids, int K, long long n, int W,
                   int sy, int sx, double* __restrict__ acc) {
  __shared__ double part[WIN * 7];
  __shared__ int s_lo, s_hi;
  const int tid = threadIdx.x;
  const long long base = (long long)blockIdx.x * CELLS;
  int slot[PER];
  load_slots(lab, ids, K, n, base, slot, &s_lo, &s_hi);
  const int blo = s_lo, bhi = s_hi;
  if (bhi < 0) return;  // uniform: no kept label in this run of cells
  const bool local = bhi - blo < WIN;
  const int span = (bhi - blo + 1) * 7;
  if (local) {
    for (int j = tid; j < span; j += THREADS) part[j] = 0.0;
    __syncthreads();
  }
#pragma unroll
  for (int p = 0; p < PER; ++p) {
    const int s = slot[p];
    if (s < 0) continue;
    const long long i = base + (long long)p * THREADS + tid;
    const long long gy = i / W;
    const long long gx = i - gy * W;
    const double fx = (double)gx * sx + (sx - 1) * 0.5;
    const double fy = (double)gy * sy + (sy - 1) * 0.5;
    const double v[7] = {1.0, fx, fy, fx * fx, fy * fy, fx * fy,
                         (double)prob[i]};
    double* dst = local ? part + (s - blo) * 7 : acc + (size_t)s * 7;
#pragma unroll
    for (int c = 0; c < 7; ++c) atomicAdd(dst + c, v[c]);
  }
  if (local) {
    __syncthreads();
    for (int j = tid; j < span; j += THREADS) {
      if (part[(j / 7) * 7] != 0.0) atomicAdd(acc + (size_t)blo * 7 + j, part[j]);
    }
  }
}

__global__ void to_float_kernel(const double* __restrict__ src,
                                float* __restrict__ dst, int count) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < count) dst[i] = (float)src[i];
}

__global__ void __launch_bounds__(THREADS)
proj_extents_kernel(const int* __restrict__ lab, const float* __restrict__ axes,
                    const int* __restrict__ ids, int K, long long n, int W,
                    int sy, int sx, int* __restrict__ ext) {
  __shared__ int part[WIN * 4];
  __shared__ int s_lo, s_hi;
  const int tid = threadIdx.x;
  const long long base = (long long)blockIdx.x * CELLS;
  const int big = ord_of(BIG);
  int slot[PER];
  load_slots(lab, ids, K, n, base, slot, &s_lo, &s_hi);
  const int blo = s_lo, bhi = s_hi;
  if (bhi < 0) return;
  const bool local = bhi - blo < WIN;
  const int span = (bhi - blo + 1) * 4;
  if (local) {
    for (int j = tid; j < span; j += THREADS) part[j] = big;
    __syncthreads();
  }
#pragma unroll
  for (int p = 0; p < PER; ++p) {
    const int s = slot[p];
    if (s < 0) continue;
    const long long i = base + (long long)p * THREADS + tid;
    const long long gy = i / W;
    const long long gx = i - gy * W;
    const float fx = (float)gx * (float)sx + (float)(sx - 1) * 0.5f;
    const float fy = (float)gy * (float)sy + (float)(sy - 1) * 0.5f;
    const float ux = axes[2 * s];
    const float uy = axes[2 * s + 1];
    const float pu = __fadd_rn(__fmul_rn(ux, fx), __fmul_rn(uy, fy));
    const float pv = __fsub_rn(__fmul_rn(ux, fy), __fmul_rn(uy, fx));
    int* dst = local ? part + (s - blo) * 4 : ext + (size_t)s * 4;
    atomicMin(dst + 0, ord_of(pu));
    atomicMin(dst + 1, ord_of(pv));
    atomicMin(dst + 2, ord_of(-pu));
    atomicMin(dst + 3, ord_of(-pv));
  }
  if (local) {
    __syncthreads();
    for (int j = tid; j < span; j += THREADS) {
      if (part[j] != big) atomicMin(ext + (size_t)blo * 4 + j, part[j]);
    }
  }
}

__global__ void fill_int_kernel(int* __restrict__ dst, int value, int count) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < count) dst[i] = value;
}

// in place: the int images become the floats they stand for
__global__ void ord_to_float_kernel(int* __restrict__ buf, int count) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < count) reinterpret_cast<float*>(buf)[i] = float_of(buf[i]);
}

inline unsigned blocks_for(long long n) {
  return (unsigned)((n + CELLS - 1) / CELLS);
}

}  // namespace

// lab (n,) int32 raster labels of a grid W cells wide (0 = background),
// prob (n,) float32, ids (K,) int32 ascending. acc (K, 7) float64 scratch,
// out (K, 7) float32. Returns cudaGetLastError() after the launches.
extern "C" int label_moment_sums(const int* lab, const float* prob,
                                 const int* ids, int K, long long n, int W,
                                 int sy, int sx, double* acc, float* out,
                                 cudaStream_t stream) {
  if (K <= 0) return (int)cudaGetLastError();
  cudaError_t err = cudaMemsetAsync(acc, 0, sizeof(double) * 7 * (size_t)K,
                                    stream);
  if (err != cudaSuccess) return (int)err;
  if (n > 0) {
    moment_sums_kernel<<<blocks_for(n), THREADS, 0, stream>>>(
        lab, prob, ids, K, n, W, sy, sx, acc);
  }
  to_float_kernel<<<(7 * K + 255) / 256, 256, 0, stream>>>(acc, out, 7 * K);
  return (int)cudaGetLastError();
}

// lab (n,) int32, axes (K, 2) float32 [ux, uy], ids (K,) int32 ascending.
// out (K, 4) float32; empty slots come back as 3.4e38.
extern "C" int label_proj_extents(const int* lab, const float* axes,
                                  const int* ids, int K, long long n, int W,
                                  int sy, int sx, float* out,
                                  cudaStream_t stream) {
  if (K <= 0) return (int)cudaGetLastError();
  int* ext = reinterpret_cast<int*>(out);
  int big_bits;
  {
    const float big = BIG;
    big_bits = *reinterpret_cast<const int*>(&big);  // positive: its own order
  }
  fill_int_kernel<<<(4 * K + 255) / 256, 256, 0, stream>>>(ext, big_bits,
                                                           4 * K);
  if (n > 0) {
    proj_extents_kernel<<<blocks_for(n), THREADS, 0, stream>>>(
        lab, axes, ids, K, n, W, sy, sx, ext);
  }
  ord_to_float_kernel<<<(4 * K + 255) / 256, 256, 0, stream>>>(ext, 4 * K);
  return (int)cudaGetLastError();
}
