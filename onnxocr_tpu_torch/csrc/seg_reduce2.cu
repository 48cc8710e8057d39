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
// integer operations per cell. That is less than one launch costs, so the
// floor of any design is a launch that reads the labels and finds them all
// background.
//
// Design: the Pallas kernels walk a (128-id tile x 8192-cell band) grid in
// order and skip tiles whose id range misses the band. Blocks here run in
// parallel and unordered, so each block takes a run of consecutive cells
// instead, maps positive labels to slots by binary search in the sorted ids
// (labels compare as int32, exact at any size), finds the slot range its
// cells touch and - since raster-local cells touch a narrow range, the same
// locality the band skip relies on - accumulates into a shared-memory
// window over that range, then flushes the touched slots to device memory
// with one atomic per slot and channel. Cells past the window add straight
// to device memory.
//   Sums (one memset, one launch): 2,048 cells a block, the labels loaded
// 16 bytes a thread. Float64 shared atomics are a compare-and-swap loop and
// inside a text line a whole warp would hit the same seven addresses, so
// the warp reduces first: lanes are grouped by label (__match_any_sync),
// the lowest lane of a group searches ids once and hands the slot to the
// others, a thread adds up those of its four cells that share a slot, and
// each group of lanes is reduced with shuffles before its lowest lane makes
// one shared atomic per channel - 7 for a warp inside one line, 14 for a
// warp that alternates between two. A warp whose cells are all background
// (most of a page) leaves after the ballot and loads nothing else. The sums
// accumulate in float64, so their order cannot move the float32 result
// beyond one rounding; the accumulator and a ticket counter are cleared by
// the one memset, and the block that draws the last ticket converts the
// accumulator into the float32 output.
//   Extents (three launches): 4,096 cells a block, a binary search per
// labelled cell. Mins use atomicMin on an order-preserving int image of the
// float, which is order-independent; the projections are computed without
// FMA contraction so they round as the plain PyTorch version does.
#include <cuda_runtime.h>
#include <limits.h>

namespace {

constexpr int THREADS = 256;
constexpr int PER = 16;                  // extents: cells per thread
constexpr int CELLS = THREADS * PER;     // extents: cells per block
constexpr int SUM_VEC = 2;               // sums: int4 label loads per thread
constexpr int SUM_PER = 4 * SUM_VEC;     // sums: cells per thread
constexpr int SUM_CELLS = THREADS * SUM_PER;  // sums: cells per block
constexpr int WIN = 512;                 // shared slot window
constexpr float BIG = 3.4e38f;
constexpr unsigned FULL = 0xffffffffu;

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

// Extents: load this thread's PER cells, map them to slots and reduce the
// block's slot range into (*s_lo, *s_hi). Returns after a __syncthreads().
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
    lo = min(lo, __shfl_xor_sync(FULL, lo, off));
    hi = max(hi, __shfl_xor_sync(FULL, hi, off));
  }
  if ((tid & 31) == 0 && hi >= 0) {
    atomicMin(s_lo, lo);
    atomicMax(s_hi, hi);
  }
  __syncthreads();
}

// True in exactly one block of the grid: the one that arrives last, after
// every other block's device atomics are visible.
__device__ __forceinline__ bool last_block(unsigned* counter, bool* s_last) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    *s_last = atomicAdd(counter, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (*s_last) __threadfence();
  return *s_last;
}

// Thread t of a block owns, for v < SUM_VEC, the four cells from
// base + v * 4 * THREADS + 4 * t on: a warp's lanes cover 128 consecutive
// cells per v. Slots are indexed [4 * v + e].
__global__ void __launch_bounds__(THREADS)
moment_sums_kernel(const int* __restrict__ lab, const float* __restrict__ prob,
                   const int* __restrict__ ids, int K, unsigned n, unsigned W,
                   int sy, int sx, double* acc, unsigned* counter,
                   float* __restrict__ out) {
  __shared__ double part[WIN * 7];
  __shared__ int s_lo, s_hi;
  __shared__ bool s_last;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const unsigned base = blockIdx.x * (unsigned)SUM_CELLS;
  const bool vec = (reinterpret_cast<size_t>(lab) & 15) == 0;
  if (tid == 0) {
    s_lo = INT_MAX;
    s_hi = -1;
  }
  __syncthreads();

  // labels -> slots, one search per group of lanes that share a label
  int slot[SUM_PER];
  int lo = INT_MAX, hi = -1;
#pragma unroll
  for (int v = 0; v < SUM_VEC; ++v) {
    const unsigned i = base + v * 4 * THREADS + 4 * tid;
    int l[4] = {0, 0, 0, 0};
    if (vec && i + 3 < n) {
      const int4 q = __ldg(reinterpret_cast<const int4*>(lab + i));
      l[0] = q.x;
      l[1] = q.y;
      l[2] = q.z;
      l[3] = q.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (i + e < n) l[e] = lab[i + e];
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool on = l[e] > 0;
      // inside a line a thread's next cell repeats its label: when that
      // holds for every labelled lane, the warp searches nothing
      const bool repeat = e > 0 && l[e] == l[e > 0 ? e - 1 : 0];
      int s = -1;
      if (__ballot_sync(FULL, on && !repeat) == 0) {
        if (on) s = slot[4 * v + (e > 0 ? e - 1 : 0)];
      } else {
        const unsigned grp = __match_any_sync(FULL, l[e]);
        const int lead = __ffs(grp) - 1;
        if (on && lane == lead) s = find_slot(ids, K, l[e]);
        s = __shfl_sync(FULL, s, lead);
      }
      slot[4 * v + e] = s;
      if (s >= 0) {
        lo = min(lo, s);
        hi = max(hi, s);
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    lo = min(lo, __shfl_xor_sync(FULL, lo, off));
    hi = max(hi, __shfl_xor_sync(FULL, hi, off));
  }
  if (lane == 0 && hi >= 0) {
    atomicMin(&s_lo, lo);
    atomicMax(&s_hi, hi);
  }
  __syncthreads();
  const int blo = s_lo, bhi = s_hi;

  if (bhi >= 0) {  // block-uniform: some cell of this run has a kept label
    const int span = (min(bhi - blo, WIN - 1) + 1) * 7;
    for (int j = tid; j < span; j += THREADS) part[j] = 0.0;
    __syncthreads();
#pragma unroll
    for (int v = 0; v < SUM_VEC; ++v) {
      const unsigned i = base + v * 4 * THREADS + 4 * tid;
      const unsigned gy0 = i / W;
      const unsigned gx0 = i - gy0 * W;
      bool todo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) todo[e] = slot[4 * v + e] >= 0;
      // a pass takes, per thread, the first slot it still owes and every
      // cell of its four in that slot; one pass serves a line's interior
#pragma unroll
      for (int pass = 0; pass < 4; ++pass) {
        int s = -1;
#pragma unroll
        for (int e = 3; e >= 0; --e) {
          if (todo[e]) s = slot[4 * v + e];
        }
        if (__ballot_sync(FULL, s >= 0) == 0) break;  // warp-uniform
        double val[7] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (todo[e] && slot[4 * v + e] == s) {
            todo[e] = false;
            unsigned gx = gx0 + e, gy = gy0;
            while (gx >= W) {
              gx -= W;
              ++gy;
            }
            const double fx = (double)gx * sx + (sx - 1) * 0.5;
            const double fy = (double)gy * sy + (sy - 1) * 0.5;
            val[0] += 1.0;
            val[1] += fx;
            val[2] += fy;
            val[3] += fx * fx;
            val[4] += fy * fy;
            val[5] += fx * fy;
            val[6] += (double)prob[i + e];
          }
        }
        // lanes that share the slot reduce with shuffles; the lowest lane
        // of each group makes the atomics
        const unsigned grp = __match_any_sync(FULL, s);
        unsigned leaders =
            __ballot_sync(FULL, s >= 0 && lane == __ffs(grp) - 1);
        while (leaders) {  // warp-uniform
          const int lead = __ffs(leaders) - 1;
          leaders &= leaders - 1;
          const unsigned members = __shfl_sync(FULL, grp, lead);
          double sum[7];
#pragma unroll
          for (int c = 0; c < 7; ++c) {
            sum[c] = ((members >> lane) & 1u) ? val[c] : 0.0;
          }
          if (members != (1u << lead)) {
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
              for (int c = 0; c < 7; ++c) {
                sum[c] += __shfl_xor_sync(FULL, sum[c], off);
              }
            }
          }
          if (lane == lead) {
            double* dst = (s - blo < WIN) ? part + (s - blo) * 7
                                          : acc + (size_t)s * 7;
#pragma unroll
            for (int c = 0; c < 7; ++c) atomicAdd(dst + c, sum[c]);
          }
        }
      }
    }
    __syncthreads();
    for (int j = tid; j < span; j += THREADS) {
      if (part[(j / 7) * 7] != 0.0) {
        atomicAdd(acc + (size_t)blo * 7 + j, part[j]);
      }
    }
  }
  if (last_block(counter, &s_last)) {
    for (int j = tid; j < 7 * K; j += THREADS) out[j] = (float)__ldcg(acc + j);
  }
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

inline unsigned blocks_for(long long n, int cells) {
  return (unsigned)((n + cells - 1) / cells);
}

}  // namespace

// lab (n,) int32 raster labels of a grid W cells wide (0 = background),
// n < 2^31, prob (n,) float32, ids (K,) int32 ascending. scratch holds
// 7 K + 1 float64 (accumulator + ticket counter), out (K, 7) float32.
// Returns the first CUDA error of the memset and the launch, 0 for none.
extern "C" int label_moment_sums(const int* lab, const float* prob,
                                 const int* ids, int K, long long n, int W,
                                 int sy, int sx, double* scratch, float* out,
                                 cudaStream_t stream) {
  if (K <= 0) return (int)cudaGetLastError();
  if (n < 0 || n >= (1LL << 31) || W <= 0) return (int)cudaErrorInvalidValue;
  const size_t count = 7 * (size_t)K;
  cudaError_t err = cudaMemsetAsync(scratch, 0, sizeof(double) * (count + 1),
                                    stream);
  if (err != cudaSuccess) return (int)err;
  // an empty grid still takes one block: it draws the ticket, writes zeros
  moment_sums_kernel<<<n > 0 ? blocks_for(n, SUM_CELLS) : 1u, THREADS, 0,
                       stream>>>(
      lab, prob, ids, K, (unsigned)n, (unsigned)W, sy, sx, scratch,
      reinterpret_cast<unsigned*>(scratch + count), out);
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
    proj_extents_kernel<<<blocks_for(n, CELLS), THREADS, 0, stream>>>(
        lab, axes, ids, K, n, W, sy, sx, ext);
  }
  ord_to_float_kernel<<<(4 * K + 255) / 256, 256, 0, stream>>>(ext, 4 * K);
  return (int)cudaGetLastError();
}
