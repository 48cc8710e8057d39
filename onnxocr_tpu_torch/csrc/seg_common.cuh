// What the label-keyed (seg_reduce2.cu) and the slot-keyed (seg_reduce.cu)
// DB-extraction reductions share: one design for this card.
//
// A block takes a run of RUN consecutive cells: a page's text is a few dense
// runs, and short ones spread them over more SMs. Thread t owns the four
// cells from the run's start + 4 * t on, so it loads their labels or slots
// as one 16-byte word and a warp's lanes cover 128 consecutive cells. Cells
// are mapped to slots in [0, K), the block reduces the slot range its cells
// touch and accumulates into a shared-memory window of WIN slots from the
// smallest one on (slots are raster-ranked, so a run of cells touches few of
// them); a cell past the window goes straight to device memory. Lanes that
// hold the same slot are grouped with __match_any_sync and reduced before
// the atomics are made, since inside a text line a whole warp would hit the
// same few addresses.
// The accumulator and a ticket counter are cleared by one memset before the
// one launch; the block that draws the last ticket converts the accumulator
// into the float32 output.
#pragma once
#include <cuda_runtime.h>
#include <limits.h>

namespace seg {

constexpr int THREADS = 256;
constexpr int RUN = 4 * THREADS;  // cells a block
constexpr int WIN = 512;  // slots of the shared-memory window
constexpr float BIG = 3.4e38f;
constexpr unsigned FULL = 0xffffffffu;

// float -> unsigned with the order reversed (smaller float, larger key), so
// a min is an atomicMax; only the NaN with all bits set maps to 0, so a
// zeroed accumulator means "empty" and needs no fill launch
__device__ __forceinline__ unsigned key_of(float f) {
  const unsigned u = __float_as_uint(f);
  return ~((u & 0x80000000u) ? ~u : (u | 0x80000000u));
}
__device__ __forceinline__ float float_of(unsigned key) {
  const unsigned a = ~key;
  return __uint_as_float((a & 0x80000000u) ? (a & 0x7fffffffu) : ~a);
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

// The last block's pass over the accumulator: out[j] = conv(acc[j]) for
// j < count. Every load is a trip to L2, so a thread starts sixteen before
// it waits for the first: K = 1024 rows of seven take two rounds.
template <class T, class F>
__device__ __forceinline__ void write_out(const T* acc, float* __restrict__ out,
                                          int count, F conv) {
  constexpr int DEPTH = 16;
  for (int j0 = threadIdx.x; j0 < count; j0 += DEPTH * THREADS) {
    T v[DEPTH];
#pragma unroll
    for (int u = 0; u < DEPTH; ++u) {
      const int j = j0 + u * THREADS;
      if (j < count) v[u] = __ldcg(acc + j);
    }
#pragma unroll
    for (int u = 0; u < DEPTH; ++u) {
      const int j = j0 + u * THREADS;
      if (j < count) out[j] = conv(v[u]);
    }
  }
}

// The four int32 from src + i on (0 past n): one 16-byte load when `vec`
// (src is 16-byte aligned; i is a multiple of 4) and all four lie inside.
__device__ __forceinline__ void load4(const int* __restrict__ src, unsigned i,
                                      unsigned n, bool vec, int q[4]) {
  if (vec && i + 3 < n) {
    const int4 w = __ldg(reinterpret_cast<const int4*>(src + i));
    q[0] = w.x;
    q[1] = w.y;
    q[2] = w.z;
    q[3] = w.w;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) q[e] = i + e < n ? src[i + e] : 0;
  }
}

// Fold each thread's slot range (hi < 0: none) into the block's (*s_lo,
// *s_hi), which thread 0 reset before a __syncthreads(). Ends with one.
__device__ __forceinline__ void block_range(int lo, int hi, int* s_lo,
                                            int* s_hi) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    lo = min(lo, __shfl_xor_sync(FULL, lo, off));
    hi = max(hi, __shfl_xor_sync(FULL, hi, off));
  }
  if ((threadIdx.x & 31) == 0 && hi >= 0) {
    atomicMin(s_lo, lo);
    atomicMax(s_hi, hi);
  }
  __syncthreads();
}

// The first slot a thread still owes among its four cells, -1 for none.
__device__ __forceinline__ int first_owed(const int slot[4],
                                          const bool todo[4]) {
  int s = -1;
#pragma unroll
  for (int e = 3; e >= 0; --e) {
    if (todo[e]) s = slot[e];
  }
  return s;
}

// Every lane brings a slot s (-1: nothing) and its own sum val[] for it.
// Lanes that share a slot are reduced with a butterfly of shuffles, which
// leaves the group's sums in every lane, and lane c of the warp adds channel
// c to the window (slots blo .. blo + WIN - 1) or, past it, to device
// memory: C float64 atomics a group, side by side. A float64 shared atomic
// is a compare-and-swap loop: lane by lane a warp inside a text line would
// run 32 C of them on C addresses, and one lane making all C runs them one
// after the other against the block's other warps. Called by whole warps.
template <int C>
__device__ __forceinline__ void group_add(int s, const double (&val)[C],
                                          int blo, double* part, double* acc) {
  const int lane = threadIdx.x & 31;
  const unsigned grp = __match_any_sync(FULL, s);
  unsigned leaders = __ballot_sync(FULL, s >= 0 && lane == __ffs(grp) - 1);
  while (leaders) {  // warp-uniform
    const int lead = __ffs(leaders) - 1;
    leaders &= leaders - 1;
    const unsigned members = __shfl_sync(FULL, grp, lead);
    const int slot = __shfl_sync(FULL, s, lead);
    double mine = 0.0;  // channel `lane` of the group's sums
#pragma unroll
    for (int c = 0; c < C; ++c) {
      double sum = ((members >> lane) & 1u) ? val[c] : 0.0;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        sum += __shfl_xor_sync(FULL, sum, off);
      }
      if (lane == c) mine = sum;
    }
    if (lane < C) {
      double* dst = (slot - blo < WIN) ? part + (slot - blo) * C
                                       : acc + (size_t)slot * C;
      atomicAdd(dst + lane, mine);
    }
  }
}

inline unsigned blocks_for(long long n, int cells = RUN) {
  // an empty input still takes one block: it draws the ticket and writes
  // the empty output
  return n > 0 ? (unsigned)((n + cells - 1) / cells) : 1u;
}

}  // namespace seg
