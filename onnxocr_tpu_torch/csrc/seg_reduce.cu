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
// one-hot matrix product. Blocks here run unordered, so each block takes
// CELLS consecutive cells, reads their slots coalesced and accumulates into
// a shared-memory window of WIN slots starting at the block's smallest slot
// (slots are raster-ranked, so a run of cells touches few of them; a cell
// past the window adds straight to device memory). A warp whose 32 cells
// all carry one slot - the inside of a text line - reduces them with
// shuffles first and makes one atomic per channel instead of 32 on one
// address. Touched window entries are flushed with one device atomic each.
//   Sums accumulate in float64, so the atomics' order cannot move the
// float32 result beyond one rounding. Mins take atomicMax on an
// order-reversing unsigned image of the float, which is exact in any order;
// the image of no float is 0, so a zeroed accumulator means "empty".
//   One launch per call after one memset: the accumulator and a ticket
// counter are cleared together, and the block that draws the last ticket
// converts the accumulator into the float32 output.
#include <cuda_runtime.h>
#include <limits.h>

namespace {

constexpr int THREADS = 256;
constexpr int PER = 8;                   // cells per thread
constexpr int CELLS = THREADS * PER;     // cells per block
constexpr int WIN = 512;                 // shared slot window
constexpr int MAXC = 7;                  // channels
constexpr float BIG = 3.4e38f;
constexpr unsigned FULL = 0xffffffffu;

// float -> unsigned with the order reversed (smaller float, larger key);
// only the NaN with all bits set maps to 0
__device__ __forceinline__ unsigned key_of(float f) {
  const unsigned u = __float_as_uint(f);
  return ~((u & 0x80000000u) ? ~u : (u | 0x80000000u));
}
__device__ __forceinline__ float float_of(unsigned key) {
  const unsigned a = ~key;
  return __uint_as_float((a & 0x80000000u) ? (a & 0x7fffffffu) : ~a);
}

// Load this thread's PER slots (-1 for a no-op cell) and reduce the block's
// slot range into (*s_lo, *s_hi); *s_hi stays -1 when no cell is active.
// Ends with a __syncthreads().
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

__global__ void __launch_bounds__(THREADS)
seg_sum_kernel(const int* __restrict__ slot, const float* __restrict__ vals,
               long long n, int K, int C, double* acc, unsigned* counter,
               float* __restrict__ out) {
  __shared__ double part[WIN * MAXC];
  __shared__ int s_lo, s_hi;
  __shared__ bool s_last;
  const int tid = threadIdx.x;
  const long long base = (long long)blockIdx.x * CELLS;
  int sl[PER];
  load_slots(slot, n, K, base, sl, &s_lo, &s_hi);
  const int blo = s_lo, bhi = s_hi;
  if (bhi >= 0) {  // block-uniform: some cell of this run is active
    const int span = (min(bhi - blo, WIN - 1) + 1) * C;
    for (int j = tid; j < span; j += THREADS) part[j] = 0.0;
    __syncthreads();
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      const int s = sl[p];
      const unsigned act = __ballot_sync(FULL, s >= 0);
      if (act == 0) continue;  // warp-uniform
      const long long i = base + (long long)p * THREADS + tid;
      double v[MAXC];
#pragma unroll
      for (int c = 0; c < MAXC; ++c) {
        v[c] = (s >= 0 && c < C) ? (double)vals[i * C + c] : 0.0;
      }
      const int s0 = __shfl_sync(FULL, s, __ffs(act) - 1);
      const bool same = __all_sync(FULL, s < 0 || s == s0);
      if (same) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
          for (int c = 0; c < MAXC; ++c) {
            if (c < C) v[c] += __shfl_xor_sync(FULL, v[c], off);
          }
        }
      }
      if (same ? (tid & 31) == 0 : s >= 0) {
        const int t = same ? s0 : s;
        double* dst = (t - blo < WIN) ? part + (t - blo) * C
                                      : acc + (size_t)t * C;
#pragma unroll
        for (int c = 0; c < MAXC; ++c) {
          if (c < C) atomicAdd(dst + c, v[c]);
        }
      }
    }
    __syncthreads();
    for (int j = tid; j < span; j += THREADS) {
      if (part[j] != 0.0) atomicAdd(acc + (size_t)blo * C + j, part[j]);
    }
  }
  if (last_block(counter, &s_last)) {
    for (int j = tid; j < K * C; j += THREADS) out[j] = (float)__ldcg(acc + j);
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
  const long long base = (long long)blockIdx.x * CELLS;
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
    for (int j = tid; j < K * C; j += THREADS) {
      const unsigned key = __ldcg(acc + j);
      const float v = key ? float_of(key) : BIG;
      out[j] = v >= BIG ? big : v;
    }
  }
}

inline unsigned blocks_for(long long n) {
  return n > 0 ? (unsigned)((n + CELLS - 1) / CELLS) : 1u;
}

}  // namespace

// slot (n,) int32, vals (n, C) float32 row-major, 1 <= C <= 7. scratch holds
// K*C + 1 float64 (accumulator + ticket counter), out (K, C) float32.
// Returns the first CUDA error of the memset and the launch, 0 for none.
extern "C" int seg_sum_bands(const int* slot, const float* vals, long long n,
                             int K, int C, double* scratch, float* out,
                             cudaStream_t stream) {
  if (K <= 0 || C <= 0 || C > MAXC || n < 0) return (int)cudaErrorInvalidValue;
  const size_t count = (size_t)K * C;
  cudaError_t err = cudaMemsetAsync(scratch, 0, sizeof(double) * (count + 1),
                                    stream);
  if (err != cudaSuccess) return (int)err;
  seg_sum_kernel<<<blocks_for(n), THREADS, 0, stream>>>(
      slot, vals, n, K, C, scratch,
      reinterpret_cast<unsigned*>(scratch + count), out);
  return (int)cudaGetLastError();
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
  seg_min_kernel<<<blocks_for(n), THREADS, 0, stream>>>(
      slot, vals, n, K, C, big, scratch, scratch + count, out);
  return (int)cudaGetLastError();
}
