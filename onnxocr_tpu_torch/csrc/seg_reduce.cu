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
//   Mins take the same path, one body (reduce_run) with the sums: they
// differ only in what a pass does with its cells (Sum, Min) and in the last
// block's conversion. A thread takes the max of the order-reversing keys of
// seg_common.cuh over those of its cells that share a slot; lanes are
// grouped by slot, each group reduces each channel with one
// __reduce_max_sync, and C lanes of the group make the C atomicMax calls
// side by side. A max on the key image is exact in any order, and the key's
// zero means "empty", so there is no fill launch.
#include "seg_common.cuh"

#include <type_traits>

namespace {

using namespace seg;

constexpr int MAXC = 7;  // channels

// The C lanes of a group of lanes `grp` that make its C atomics: the member
// of rank r takes channels r, r + size, ... (bit c of the result: channel c).
__device__ __forceinline__ unsigned channels_of(unsigned grp, int C) {
  const int lane = threadIdx.x & 31;
  const int rank = __popc(grp & ((1u << lane) - 1u));
  const int size = __popc(grp);
  unsigned mine = 0u;
  for (int c = rank; c < C; c += size) mine |= 1u << c;
  return mine;
}

// What the two kernels do with a pass's cells; all else is reduce_run. T is
// the accumulator's type, whose zero means "nothing yet". serve(s, take,
// ...) takes the thread's cells of slot s (take[e]: cell e; s = -1 and none
// taken for a thread with nothing left) into the window `part` over slots
// blo .. blo + WIN - 1 or, past it, into `acc`; whole warps call it.
struct Sum {
  using T = double;
  template <int C>
  static __device__ __forceinline__ void serve(int s, const bool (&take)[4],
                                               const float (&row)[4 * C],
                                               int blo, double* part,
                                               double* acc) {
    double val[C];
#pragma unroll
    for (int c = 0; c < C; ++c) val[c] = 0.0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (take[e]) {
#pragma unroll
        for (int c = 0; c < C; ++c) val[c] += (double)row[e * C + c];
      }
    }
    group_add<C>(s, val, blo, part, acc);
  }
  static __device__ __forceinline__ void merge(double* dst, double v) {
    atomicAdd(dst, v);
  }
  static __device__ __forceinline__ float result(double v, float) {
    return (float)v;
  }
};

struct Min {
  using T = unsigned;
  template <int C>
  static __device__ __forceinline__ void serve(int s, const bool (&take)[4],
                                               const float (&row)[4 * C],
                                               int blo, unsigned* part,
                                               unsigned* acc) {
    unsigned key[C];
#pragma unroll
    for (int c = 0; c < C; ++c) key[c] = 0u;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (take[e]) {
#pragma unroll
        for (int c = 0; c < C; ++c) {
          key[c] = max(key[c], key_of(row[e * C + c]));
        }
      }
    }
    // lanes with nothing left form a group of their own (s = -1) that
    // reduces zeros and adds nothing
    const unsigned grp = __match_any_sync(FULL, s);
#pragma unroll
    for (int c = 0; c < C; ++c) key[c] = __reduce_max_sync(grp, key[c]);
    if (s >= 0) {
      const unsigned mine = channels_of(grp, C);
      unsigned* dst = (s - blo < WIN) ? part + (s - blo) * C
                                      : acc + (size_t)s * C;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if ((mine >> c) & 1u) atomicMax(dst + c, key[c]);
      }
    }
  }
  static __device__ __forceinline__ void merge(unsigned* dst, unsigned v) {
    atomicMax(dst, v);
  }
  static __device__ __forceinline__ float result(unsigned key, float big) {
    const float v = key ? float_of(key) : BIG;
    return v >= BIG ? big : v;
  }
};

// One block's run of RUN cells, reduced under Op into acc (K * C entries,
// then the ticket counter); the block that draws the last ticket writes out
// = Op::result(acc, big).
template <class Op, int C>
__device__ __forceinline__ void reduce_run(const int* __restrict__ slot,
                                           const float* __restrict__ vals,
                                           unsigned n, int K, float big,
                                           typename Op::T* acc,
                                           unsigned* counter,
                                           float* __restrict__ out) {
  using T = typename Op::T;
  __shared__ T part[WIN * C];
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
    for (int j = tid; j < span; j += THREADS) part[j] = T(0);
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
      bool take[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        take[e] = todo[e] && sl[e] == s;
        todo[e] = todo[e] && !take[e];
      }
      Op::template serve<C>(s, take, row, blo, part, acc);
    }
    __syncthreads();
    for (int j = tid; j < span; j += THREADS) {
      if (part[j] != T(0)) Op::merge(acc + (size_t)blo * C + j, part[j]);
    }
  }
  if (last_block(counter, &s_last)) {
    write_out(acc, out, K * C, [big](T v) { return Op::result(v, big); });
  }
}

template <int C>
__global__ void __launch_bounds__(THREADS)
seg_sum_kernel(const int* __restrict__ slot, const float* __restrict__ vals,
               unsigned n, int K, double* acc, unsigned* counter,
               float* __restrict__ out) {
  reduce_run<Sum, C>(slot, vals, n, K, 0.0f, acc, counter, out);
}

template <int C>
__global__ void __launch_bounds__(THREADS)
seg_min_kernel(const int* __restrict__ slot, const float* __restrict__ vals,
               unsigned n, int K, float big, unsigned* acc, unsigned* counter,
               float* __restrict__ out) {
  reduce_run<Min, C>(slot, vals, n, K, big, acc, counter, out);
}

// Clears the accumulator of T and the ticket after it with one memset, then
// calls launch(std::integral_constant<int, C>()), which launches the kernel
// for the call's C. Returns the first CUDA error, 0 for none.
template <class T, class F>
int run(long long n, int K, int C, T* scratch, cudaStream_t stream,
        F launch) {
  if (K <= 0 || C <= 0 || C > MAXC || n < 0 || n >= (1LL << 31)) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t count = (size_t)K * C;
  const cudaError_t err = cudaMemsetAsync(
      scratch, 0, sizeof(T) * count + sizeof(unsigned), stream);
  if (err != cudaSuccess) return (int)err;
  switch (C) {
    case 1: launch(std::integral_constant<int, 1>()); break;
    case 2: launch(std::integral_constant<int, 2>()); break;
    case 3: launch(std::integral_constant<int, 3>()); break;
    case 4: launch(std::integral_constant<int, 4>()); break;
    case 5: launch(std::integral_constant<int, 5>()); break;
    case 6: launch(std::integral_constant<int, 6>()); break;
    default: launch(std::integral_constant<int, 7>());
  }
  return (int)cudaGetLastError();
}

}  // namespace

// slot (n,) int32, n < 2^31, vals (n, C) float32 row-major, 1 <= C <= 7.
// scratch holds K*C + 1 float64 (accumulator + ticket counter), out (K, C)
// float32. Returns the first CUDA error of the memset and the launch, 0 for
// none.
extern "C" int seg_sum_bands(const int* slot, const float* vals, long long n,
                             int K, int C, double* scratch, float* out,
                             cudaStream_t stream) {
  unsigned* counter = reinterpret_cast<unsigned*>(scratch + (size_t)K * C);
  return run(n, K, C, scratch, stream, [&](auto c) {
    seg_sum_kernel<decltype(c)::value><<<blocks_for(n), THREADS, 0, stream>>>(
        slot, vals, (unsigned)n, K, scratch, counter, out);
  });
}

// As above with scratch of K*C + 1 uint32. Empty slots, and slots whose
// minimum is >= 3.4e38, come back as `big`.
extern "C" int seg_min_bands(const int* slot, const float* vals, long long n,
                             int K, int C, float big, unsigned* scratch,
                             float* out, cudaStream_t stream) {
  unsigned* counter = scratch + (size_t)K * C;
  return run(n, K, C, scratch, stream, [&](auto c) {
    seg_min_kernel<decltype(c)::value><<<blocks_for(n), THREADS, 0, stream>>>(
        slot, vals, (unsigned)n, K, big, scratch, counter, out);
  });
}
