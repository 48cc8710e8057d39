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
// parallel and unordered, so both kernels follow seg_common.cuh: one memset
// and one launch, a run of consecutive cells a block, the labels loaded 16
// bytes a thread, a shared-memory window over the block's slot range, the
// last block writing the float32 output. What is theirs:
//   Labels to slots (both): a search in the sorted ids (labels compare as
// int32, exact at any size), one per group of lanes that share a label
// (__match_any_sync), and none at all where a thread's cell repeats its
// left neighbour's label and no lane of the warp needs a search: the inside
// of a text line. A dependent load from L2 is what a search costs, so a warp
// that holds up to four distinct labels - a line, two lines that touch -
// looks each up with all 32 lanes at once (two rounds of probes at K =
// 1024); a warp with more lets each group's lowest lane run a binary search
// of its own (ten rounds, side by side) and hand the slot on. A warp whose
// cells are all background (most of a page) leaves after the ballot.
//   Staging ids in shared memory once a block was measured and is slower:
// most blocks never search.
//   Sums: a thread adds up those of its four cells that share a slot, the
// groups of lanes are reduced with shuffles and make one float64 shared
// atomic per channel: 7 for a warp inside one line, 14 for a warp that
// alternates between two. Float64, so the order of the atomics cannot move
// the float32 result beyond one rounding.
//   Extents: a min is an atomicMax on the order-reversing key of
// seg_common.cuh, exact in any order. A group's lowest lane loads the slot's
// axis once and shuffles it; a thread folds its cells of one slot, each
// group reduces its four keys with __reduce_max_sync (the hardware's integer
// warp reduction: one instruction a channel) and its lowest lane makes the
// four shared atomics. The projections are computed without FMA contraction
// so they round as the plain PyTorch version does.
#include "seg_common.cuh"

namespace {

using namespace seg;

constexpr int WARP_SEARCHES = 4;  // distinct labels a warp looks up together

// The slot of `label` in the ascending ids, -1 when it is not there: the
// binary search of one lane, log2 K dependent loads.
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

// The same by a whole warp for one label: every round the 32 lanes probe the
// range at even steps and two ballots narrow it to one step, so K = 1024
// takes two dependent loads where the binary search takes ten.
__device__ __forceinline__ int warp_find_slot(const int* __restrict__ ids,
                                              int K, int label) {
  const int lane = threadIdx.x & 31;
  int lo = 0, len = K;
  while (len > 0) {  // warp-uniform
    const int step = (len + 31) >> 5;
    const int idx = lo + lane * step;
    const bool in = idx < lo + len;
    const int val = in ? __ldg(ids + idx) : 0;
    const unsigned eq = __ballot_sync(FULL, in && val == label);
    if (eq) return lo + (__ffs(eq) - 1) * step;
    const int below = __popc(__ballot_sync(FULL, in && val < label));
    if (below == 0) return -1;
    // strictly between the last probe below the label and the next one
    const int first = lo + (below - 1) * step + 1;
    len = min(lo + below * step, lo + len) - first;
    lo = first;
  }
  return -1;
}

// Load this thread's four labels from cell i on and map them to slots (-1:
// background or a label that is not kept); reduce the block's slot range
// into (*s_lo, *s_hi), *s_hi < 0 when no cell of the run is kept. Ends with
// a __syncthreads().
__device__ __forceinline__ void labels_to_slots(const int* __restrict__ lab,
                                                const int* __restrict__ ids,
                                                int K, unsigned n, unsigned i,
                                                int slot[4], int* s_lo,
                                                int* s_hi) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const bool vec = (reinterpret_cast<size_t>(lab) & 15) == 0;
  if (tid == 0) {
    *s_lo = INT_MAX;
    *s_hi = -1;
  }
  __syncthreads();
  int lo = INT_MAX, hi = -1;
  int l[4];
  load4(lab, i, n, vec, l);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const bool on = l[e] > 0;
    // inside a line a thread's next cell repeats its label: when that
    // holds for every labelled lane, the warp searches nothing
    const bool repeat = e > 0 && l[e] == l[e > 0 ? e - 1 : 0];
    int s = -1;
    if (__ballot_sync(FULL, on && !repeat) == 0) {
      if (on) s = slot[e > 0 ? e - 1 : 0];
    } else {
      const unsigned grp = __match_any_sync(FULL, l[e]);
      const int lead = __ffs(grp) - 1;
      unsigned leaders = __ballot_sync(FULL, on && lane == lead);
      if (__popc(leaders) <= WARP_SEARCHES) {  // warp-uniform
        while (leaders) {
          const int label = __shfl_sync(FULL, l[e], __ffs(leaders) - 1);
          leaders &= leaders - 1;
          const int found = warp_find_slot(ids, K, label);
          if (l[e] == label) s = found;
        }
      } else {
        if (on && lane == lead) s = find_slot(ids, K, l[e]);
        s = __shfl_sync(FULL, s, lead);
      }
    }
    slot[e] = s;
    if (s >= 0) {
      lo = min(lo, s);
      hi = max(hi, s);
    }
  }
  block_range(lo, hi, s_lo, s_hi);
}

// Full-map cell centre of flat cell i + e, given cell i = (gx0, gy0).
__device__ __forceinline__ void cell_of(unsigned gx0, unsigned gy0, int e,
                                        unsigned W, unsigned* gx,
                                        unsigned* gy) {
  *gx = gx0 + e;
  *gy = gy0;
  while (*gx >= W) {
    *gx -= W;
    ++*gy;
  }
}

__global__ void __launch_bounds__(THREADS)
moment_sums_kernel(const int* __restrict__ lab, const float* __restrict__ prob,
                   const int* __restrict__ ids, int K, unsigned n, unsigned W,
                   int sy, int sx, double* acc, unsigned* counter,
                   float* __restrict__ out) {
  __shared__ double part[WIN * 7];
  __shared__ int s_lo, s_hi;
  __shared__ bool s_last;
  const int tid = threadIdx.x;
  const unsigned i = blockIdx.x * (unsigned)RUN + 4 * tid;
  int slot[4];
  labels_to_slots(lab, ids, K, n, i, slot, &s_lo, &s_hi);
  const int blo = s_lo, bhi = s_hi;

  if (bhi >= 0) {  // block-uniform: some cell of this run has a kept label
    const int span = (min(bhi - blo, WIN - 1) + 1) * 7;
    for (int j = tid; j < span; j += THREADS) part[j] = 0.0;
    __syncthreads();
    const unsigned gy0 = i / W;
    const unsigned gx0 = i - gy0 * W;
    bool todo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) todo[e] = slot[e] >= 0;
    // a pass takes, per thread, the first slot it still owes and every
    // cell of its four in that slot; one pass serves a line's interior
#pragma unroll
    for (int pass = 0; pass < 4; ++pass) {
      const int s = first_owed(slot, todo);
      if (__ballot_sync(FULL, s >= 0) == 0) break;  // warp-uniform
      double val[7] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (todo[e] && slot[e] == s) {
          todo[e] = false;
          unsigned gx, gy;
          cell_of(gx0, gy0, e, W, &gx, &gy);
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
      group_add<7>(s, val, blo, part, acc);
    }
    __syncthreads();
    for (int j = tid; j < span; j += THREADS) {
      if (part[(j / 7) * 7] != 0.0) {
        atomicAdd(acc + (size_t)blo * 7 + j, part[j]);
      }
    }
  }
  if (last_block(counter, &s_last)) {
    write_out(acc, out, 7 * K, [](double v) { return (float)v; });
  }
}

__global__ void __launch_bounds__(THREADS)
proj_extents_kernel(const int* __restrict__ lab, const float* __restrict__ axes,
                    const int* __restrict__ ids, int K, unsigned n, unsigned W,
                    int sy, int sx, unsigned* acc, unsigned* counter,
                    float* __restrict__ out) {
  __shared__ unsigned part[WIN * 4];
  __shared__ int s_lo, s_hi;
  __shared__ bool s_last;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const unsigned i = blockIdx.x * (unsigned)RUN + 4 * tid;
  int slot[4];
  labels_to_slots(lab, ids, K, n, i, slot, &s_lo, &s_hi);
  const int blo = s_lo, bhi = s_hi;

  if (bhi >= 0) {  // block-uniform
    const int span = (min(bhi - blo, WIN - 1) + 1) * 4;
    for (int j = tid; j < span; j += THREADS) part[j] = 0u;
    __syncthreads();
    const unsigned gy0 = i / W;
    const unsigned gx0 = i - gy0 * W;
    bool todo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) todo[e] = slot[e] >= 0;
#pragma unroll
    for (int pass = 0; pass < 4; ++pass) {
      const int s = first_owed(slot, todo);
      if (__ballot_sync(FULL, s >= 0) == 0) break;  // warp-uniform
      // lanes with nothing left form a group of their own (s = -1) that
      // reduces zeros and adds nothing
      const unsigned grp = __match_any_sync(FULL, s);
      const int lead = __ffs(grp) - 1;
      float ux = 0.0f, uy = 0.0f;
      if (s >= 0 && lane == lead) {
        ux = __ldg(axes + 2 * s);
        uy = __ldg(axes + 2 * s + 1);
      }
      ux = __shfl_sync(FULL, ux, lead);
      uy = __shfl_sync(FULL, uy, lead);
      unsigned key[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (todo[e] && slot[e] == s) {
          todo[e] = false;
          unsigned gx, gy;
          cell_of(gx0, gy0, e, W, &gx, &gy);
          const float fx = (float)gx * (float)sx + (float)(sx - 1) * 0.5f;
          const float fy = (float)gy * (float)sy + (float)(sy - 1) * 0.5f;
          const float pu = __fadd_rn(__fmul_rn(ux, fx), __fmul_rn(uy, fy));
          const float pv = __fsub_rn(__fmul_rn(ux, fy), __fmul_rn(uy, fx));
          key[0] = max(key[0], key_of(pu));
          key[1] = max(key[1], key_of(pv));
          key[2] = max(key[2], key_of(-pu));
          key[3] = max(key[3], key_of(-pv));
        }
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) key[c] = __reduce_max_sync(grp, key[c]);
      if (s >= 0 && lane == lead) {
        unsigned* dst = (s - blo < WIN) ? part + (s - blo) * 4
                                        : acc + (size_t)s * 4;
#pragma unroll
        for (int c = 0; c < 4; ++c) atomicMax(dst + c, key[c]);
      }
    }
    __syncthreads();
    for (int j = tid; j < span; j += THREADS) {
      if (part[j] != 0u) atomicMax(acc + (size_t)blo * 4 + j, part[j]);
    }
  }
  if (last_block(counter, &s_last)) {
    write_out(acc, out, 4 * K,
              [](unsigned key) { return key ? float_of(key) : BIG; });
  }
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
  moment_sums_kernel<<<blocks_for(n), THREADS, 0, stream>>>(
      lab, prob, ids, K, (unsigned)n, (unsigned)W, sy, sx, scratch,
      reinterpret_cast<unsigned*>(scratch + count), out);
  return (int)cudaGetLastError();
}

// lab (n,) int32, n < 2^31, axes (K, 2) float32 [ux, uy], ids (K,) int32
// ascending. scratch holds 4 K + 1 uint32 (key accumulator + ticket
// counter), out (K, 4) float32; empty slots come back as 3.4e38.
// Returns the first CUDA error of the memset and the launch, 0 for none.
extern "C" int label_proj_extents(const int* lab, const float* axes,
                                  const int* ids, int K, long long n, int W,
                                  int sy, int sx, unsigned* scratch,
                                  float* out, cudaStream_t stream) {
  if (K <= 0) return (int)cudaGetLastError();
  if (n < 0 || n >= (1LL << 31) || W <= 0) return (int)cudaErrorInvalidValue;
  const size_t count = 4 * (size_t)K;
  cudaError_t err = cudaMemsetAsync(scratch, 0,
                                    sizeof(unsigned) * (count + 1), stream);
  if (err != cudaSuccess) return (int)err;
  proj_extents_kernel<<<blocks_for(n), THREADS, 0, stream>>>(
      lab, axes, ids, K, (unsigned)n, (unsigned)W, sy, sx, scratch,
      scratch + count, out);
  return (int)cudaGetLastError();
}
