// Slot-keyed segment sum and segment min for Hopper (sm_90a).
//
// Replaces: onnxocr_tpu/ops/pallas/seg_reduce.py, seg_sum_bands and
// seg_min_bands (both through _run and the Pallas body _kernel, op = "sum"
// and op = "min"). Every cell i carries a slot in [0, K] and C <= 7 float
// values; slot K (and anything outside [0, K)) is a no-op:
//   sums: out[k, c] = sum of vals[i, c] over cells with slot[i] == k, 0 for
//         an empty slot;
//   mins: out[k, c] = min of vals[i, c] over the same cells, `big` for an
//         empty slot; a value >= 3.4e38 (a cell pre-masked to the sentinel)
//         never wins.
//
// What bounds them on an H100: bytes. Every slot is read once (460,800
// cells x 4 bytes = 1.8 MB on the 960x480 working grid), the C values only
// of the cells whose slot is < K (4 C bytes each; on a text page a few
// per cent of the cells, 0.27 MB at C = 7 for 9,522 of them), and K x C
// floats are written: under a microsecond at 3.35 TB/s, with one add or
// compare per loaded value. Background cells (slot K) are most of a page
// and their values are never loaded.
//
// Design: the Pallas kernel walks a (128-slot tile x 8192-cell band) grid in
// order, skips tiles outside the band's [lo, hi] slot range and sums with a
// one-hot matrix product. Blocks here run unordered, so both kernels take
// one memset and one launch, a run of consecutive cells a block, a
// shared-memory window over the block's slot range, and the last block
// writes the float32 output (seg_common.cuh).
//   Sums follow seg_common.cuh in full: a thread's four consecutive slots
// are loaded as 16 bytes. The four rows of values behind them are 16 C
// contiguous bytes, 16-byte aligned for every C, so a thread with an active
// cell loads them as C 16-byte words and a warp inside a text line reads one
// contiguous span (3,584 bytes at C = 7); the loads are started before the
// block's slot range is reduced, so they overlap it. Staging a warp's span
// through shared memory first (coalesced loads, or one cp.async.bulk onto an
// mbarrier) was measured and is no faster on a page. A thread adds up those
// of its cells that share a slot, lanes are grouped by slot and each group
// is reduced with shuffles before C lanes make the C float64 shared atomics
// side by side: C a warp inside one line, 2 C where neighbouring cells
// alternate between two slots. Float64, so the order of the atomics cannot
// move the float32 result beyond one rounding.
//   Mins deal cells to threads strided, 2,048 a block, and reduce with
// shuffles only a warp whose active cells all share one slot; they take
// atomicMax on the order-reversing key of seg_common.cuh, exact in any
// order.
#include "seg_common.cuh"

namespace {

using namespace seg;

constexpr int PER = 8;                  // mins: cells per thread
constexpr int MIN_RUN = THREADS * PER;  // mins: cells per block
constexpr int MAXC = 7;                 // channels

// Mins: load this thread's PER slots (-1 for a no-op cell) and reduce the
// block's slot range into (*s_lo, *s_hi); *s_hi stays -1 when no cell is
// active. Ends with a __syncthreads().
__device__ __forceinline__ void load_slots(const int* __restrict__ slot,
                                           long long n, int K, long long base,
                                           int sl[PER], int* s_lo, int* s_hi) {
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
      const int v = slot[i];
      if ((unsigned)v < (unsigned)K) s = v;
    }
    sl[p] = s;
    if (s >= 0) {
      lo = min(lo, s);
      hi = max(hi, s);
    }
  }
  block_range(lo, hi, s_lo, s_hi);
}

template <int C>
__global__ void __launch_bounds__(THREADS)
seg_sum_kernel(const int* __restrict__ slot, const float* __restrict__ vals,
               unsigned n, int K, double* acc, unsigned* counter,
               float* __restrict__ out) {
  __shared__ double part[WIN * C];
  __shared__ int s_lo, s_hi;
  __shared__ bool s_last;
  const int tid = threadIdx.x;
  const unsigned i = blockIdx.x * (unsigned)RUN + 4 * tid;
  const bool vec_s = (reinterpret_cast<size_t>(slot) & 15) == 0;
  const bool vec_v = (reinterpret_cast<size_t>(vals) & 15) == 0;
  if (tid == 0) {
    s_lo = INT_MAX;
    s_hi = -1;
  }
  __syncthreads();

  int sl[4];
  float row[4 * C];  // the thread's four rows of values, row-major
  int lo = INT_MAX, hi = -1;
  load4(slot, i, n, vec_s, sl);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (i + e >= n || (unsigned)sl[e] >= (unsigned)K) sl[e] = -1;
    if (sl[e] >= 0) {
      lo = min(lo, sl[e]);
      hi = max(hi, sl[e]);
    }
  }
  // the values of a thread none of whose cells is active are never read
  const float* src = vals + (size_t)i * C;
  if (hi >= 0 && vec_v && i + 3 < n) {
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const float4 w = __ldg(reinterpret_cast<const float4*>(src) + k);
      row[4 * k + 0] = w.x;
      row[4 * k + 1] = w.y;
      row[4 * k + 2] = w.z;
      row[4 * k + 3] = w.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        row[e * C + c] = sl[e] >= 0 ? src[e * C + c] : 0.0f;
      }
    }
  }
  block_range(lo, hi, &s_lo, &s_hi);
  const int blo = s_lo, bhi = s_hi;

  if (bhi >= 0) {  // block-uniform: some cell of this run is active
    const int span = (min(bhi - blo, WIN - 1) + 1) * C;
    for (int j = tid; j < span; j += THREADS) part[j] = 0.0;
    __syncthreads();
    bool todo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) todo[e] = sl[e] >= 0;
    // a pass takes, per thread, the first slot it still owes and every
    // cell of its four in that slot; one pass serves a line's interior
#pragma unroll
    for (int pass = 0; pass < 4; ++pass) {
      const int s = first_owed(sl, todo);
      if (__ballot_sync(FULL, s >= 0) == 0) break;  // warp-uniform
      double val[C];
#pragma unroll
      for (int c = 0; c < C; ++c) val[c] = 0.0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (todo[e] && sl[e] == s) {
          todo[e] = false;
#pragma unroll
          for (int c = 0; c < C; ++c) val[c] += (double)row[e * C + c];
        }
      }
      group_add<C>(s, val, blo, part, acc);
    }
    __syncthreads();
    for (int j = tid; j < span; j += THREADS) {
      if (part[j] != 0.0) atomicAdd(acc + (size_t)blo * C + j, part[j]);
    }
  }
  if (last_block(counter, &s_last)) {
    write_out(acc, out, K * C, [](double v) { return (float)v; });
  }
}

__global__ void __launch_bounds__(THREADS)
seg_min_kernel(const int* __restrict__ slot, const float* __restrict__ vals,
               long long n, int K, int C, float big, unsigned* acc,
               unsigned* counter, float* __restrict__ out) {
  __shared__ unsigned part[WIN * MAXC];
  __shared__ int s_lo, s_hi;
  __shared__ bool s_last;
  const int tid = threadIdx.x;
  const long long base = (long long)blockIdx.x * MIN_RUN;
  int sl[PER];
  load_slots(slot, n, K, base, sl, &s_lo, &s_hi);
  const int blo = s_lo, bhi = s_hi;
  if (bhi >= 0) {
    const int span = (min(bhi - blo, WIN - 1) + 1) * C;
    for (int j = tid; j < span; j += THREADS) part[j] = 0u;
    __syncthreads();
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      const int s = sl[p];
      const unsigned act = __ballot_sync(FULL, s >= 0);
      if (act == 0) continue;
      const long long i = base + (long long)p * THREADS + tid;
      unsigned v[MAXC];
#pragma unroll
      for (int c = 0; c < MAXC; ++c) {
        v[c] = (s >= 0 && c < C) ? key_of(vals[i * C + c]) : 0u;
      }
      const int s0 = __shfl_sync(FULL, s, __ffs(act) - 1);
      const bool same = __all_sync(FULL, s < 0 || s == s0);
      if (same) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
          for (int c = 0; c < MAXC; ++c) {
            if (c < C) v[c] = max(v[c], __shfl_xor_sync(FULL, v[c], off));
          }
        }
      }
      if (same ? (tid & 31) == 0 : s >= 0) {
        const int t = same ? s0 : s;
        unsigned* dst = (t - blo < WIN) ? part + (t - blo) * C
                                        : acc + (size_t)t * C;
#pragma unroll
        for (int c = 0; c < MAXC; ++c) {
          if (c < C) atomicMax(dst + c, v[c]);
        }
      }
    }
    __syncthreads();
    for (int j = tid; j < span; j += THREADS) {
      if (part[j] != 0u) atomicMax(acc + (size_t)blo * C + j, part[j]);
    }
  }
  if (last_block(counter, &s_last)) {
    write_out(acc, out, K * C, [big](unsigned key) {
      const float v = key ? float_of(key) : BIG;
      return v >= BIG ? big : v;
    });
  }
}

template <int C>
cudaError_t launch_sum(const int* slot, const float* vals, unsigned n, int K,
                       double* scratch, float* out, cudaStream_t stream) {
  seg_sum_kernel<C><<<blocks_for(n), THREADS, 0, stream>>>(
      slot, vals, n, K, scratch,
      reinterpret_cast<unsigned*>(scratch + (size_t)K * C), out);
  return cudaGetLastError();
}

}  // namespace

// slot (n,) int32, n < 2^31, vals (n, C) float32 row-major, 1 <= C <= 7.
// scratch holds K*C + 1 float64 (accumulator + ticket counter), out (K, C)
// float32. Returns the first CUDA error of the memset and the launch, 0 for
// none.
extern "C" int seg_sum_bands(const int* slot, const float* vals, long long n,
                             int K, int C, double* scratch, float* out,
                             cudaStream_t stream) {
  if (K <= 0 || C <= 0 || C > MAXC || n < 0 || n >= (1LL << 31)) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t count = (size_t)K * C;
  cudaError_t err = cudaMemsetAsync(scratch, 0, sizeof(double) * (count + 1),
                                    stream);
  if (err != cudaSuccess) return (int)err;
  const unsigned m = (unsigned)n;
  switch (C) {
    case 1: err = launch_sum<1>(slot, vals, m, K, scratch, out, stream); break;
    case 2: err = launch_sum<2>(slot, vals, m, K, scratch, out, stream); break;
    case 3: err = launch_sum<3>(slot, vals, m, K, scratch, out, stream); break;
    case 4: err = launch_sum<4>(slot, vals, m, K, scratch, out, stream); break;
    case 5: err = launch_sum<5>(slot, vals, m, K, scratch, out, stream); break;
    case 6: err = launch_sum<6>(slot, vals, m, K, scratch, out, stream); break;
    default: err = launch_sum<7>(slot, vals, m, K, scratch, out, stream);
  }
  return (int)err;
}

// As above with scratch of K*C + 1 uint32. Empty slots, and slots whose
// minimum is >= 3.4e38, come back as `big`.
extern "C" int seg_min_bands(const int* slot, const float* vals, long long n,
                             int K, int C, float big, unsigned* scratch,
                             float* out, cudaStream_t stream) {
  if (K <= 0 || C <= 0 || C > MAXC || n < 0) return (int)cudaErrorInvalidValue;
  const size_t count = (size_t)K * C;
  cudaError_t err = cudaMemsetAsync(scratch, 0,
                                    sizeof(unsigned) * (count + 1), stream);
  if (err != cudaSuccess) return (int)err;
  seg_min_kernel<<<blocks_for(n, MIN_RUN), THREADS, 0, stream>>>(
      slot, vals, n, K, C, big, scratch, scratch + count, out);
  return (int)cudaGetLastError();
}
