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
// 2*M*D*V = 27.1 GFLOP against 17 MB of input. The float32 pipes would need
// 0.40 ms for it (67 TFLOP/s); the tensor cores have no float32 product,
// and one TF32 pass keeps three decimal digits, which moves argmaxes on
// near ties. So the product is taken as three TF32 passes over split
// operands (3xTF32): v = hi + lo with hi = tf32(v), lo = tf32(v - hi), both
// rounded to nearest, and
//     logits = (x_lo W_hi + x_hi W_lo) + x_hi W_hi
// in float32, which leaves out only x_lo W_lo (2^-22 of a product). Three
// passes are 81 GFLOP: 0.164 ms at the 495 TFLOP/s of dense TF32, the bound
// of this kernel. The tensor cores add into their accumulator by
// truncation, an error of up to one unit in its last place per product
// and always toward zero: over one chain of 72 products at the logits'
// full size the max-prob came out 7e-6 (relative) from the head in
// float64, where the float32 FMA product is 3e-6 away. So a chain covers
// one k-block of 32 only - its 8 small products first, then the 4 of
// x_hi W_hi - in an accumulator that starts from zero, and the six k-blocks
// of a tile are summed on the float32 pipes, which round to nearest: 1e-6.
//
// Design. W is a constant, so the host splits it once into the prepared
// operand (2, V, D): hi and lo, K-major, as a TF32 wgmma wants both
// operands. A block owns 64 rows and a range of vocab tiles (grid.y splits
// the vocab so that the blocks fill the SMs; a second tiny kernel merges
// the splits), and holds three kinds of warps:
//   - all eight consumer warps first stage the block's x rows: 16-byte
//     loads, split into hi and lo on the way, stored K-major under the
//     128-byte swizzle; x stays resident for the whole vocab sweep;
//   - a producer warp streams W through a ring of four 32 KB stages, one
//     TMA box (32 k x 128 columns x {hi, lo}) per stage, completion on an
//     mbarrier; the swizzle is applied by the TMA unit;
//   - two consumer warpgroups take alternate vocab tiles of 128 columns.
//     Per stage a warpgroup issues 12 wgmma m64n128k8 into a 64 x 128
//     register accumulator, waits for them, frees the stage and adds the
//     accumulator to the tile's sum. While one warpgroup runs its tile's
//     epilogue the other one's products keep the tensor cores busy.
// A stage's "full" barrier is per warpgroup (a parity wait cannot skip the
// phases of the other warpgroup's tiles); its "empty" barrier is shared.
// The epilogue works on the accumulator fragment (a thread holds 2 rows x 32
// columns, the 4 lanes of a quad share their rows): add the bias, take the
// tile's maximum and its first column per row across the quad (the smaller
// column wins on equal values), rescale the running sum once per row and
// add one exp per logit, with no branch on the data. Columns >= V are
// masked to -inf, not padded into the sum. Every merge of two states - the
// two warpgroups', then the splits' - compares (value, column), so ties
// resolve to the first index whatever the order the parts finish in.
#include <cuda.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;             // rows per block: one wgmma M
constexpr int BN = 128;            // vocab columns per tile: one wgmma N
constexpr int KB = 32;             // floats per k-block: one 128-byte row
constexpr int STAGES = 4;          // W ring
constexpr int NWG = 2;             // consumer warpgroups
constexpr int CONSUMERS = NWG * 128;
constexpr int THREADS = CONSUMERS + 32;      // + the producer warp
constexpr int HALF_BYTES = BN * KB * 4;      // W_hi or W_lo of a stage
constexpr int STAGE_BYTES = 2 * HALF_BYTES;  // 32 KB
constexpr int XBLOCK_BYTES = BM * KB * 4;    // a k-block of x_hi or x_lo
constexpr int MAX_D = 192;
constexpr unsigned FULL = 0xffffffffu;

// shared memory, from a 1024-byte aligned base: the W ring, x_hi, x_lo
// ((D / 32) k-blocks each), the warpgroups' final states, the barriers
constexpr int MERGE_BYTES = NWG * BM * 12;
constexpr int BARRIERS = NWG * STAGES + STAGES;

inline size_t smem_bytes(int D) {
  return 1024 + (size_t)STAGES * STAGE_BYTES +
         2 * (size_t)(D / KB) * XBLOCK_BYTES + MERGE_BYTES + 8 * BARRIERS;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ float tf32_rna(float v) {
  uint32_t u;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(u) : "f"(v));
  return __uint_as_float(u);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` has completed. A barrier that
// never completes is a fault of this kernel: trap instead of hanging.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t spin = 0;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spin > (1u << 22)) __trap();
  }
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];"
      :
      : "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
        "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major operand under the 128-byte
// swizzle: rows of 128 bytes, groups of 8 rows 1024 bytes apart (SBO); the
// leading offset is unused in this mode. A k-step of 8 floats inside the
// row advances the start address by 32 bytes: +2 in the encoded field.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3ffffu) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// One m64n128k8 TF32 product of the warpgroup, d = A(64 x 8) * B(8 x 128)
// (+ d if `add`), both operands K-major in shared memory under the
// 128-byte swizzle.
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], uint64_t desc_a,
                                           uint64_t desc_b, int add) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      " %0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1;\n"
      "}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
      "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
      "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
      "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(add));
}

// Pins the accumulator between plain code and the asynchronous products:
// the compiler may not move a read or write of d across this point.
__device__ __forceinline__ void fence_operand(float (&d)[64]) {
#pragma unroll
  for (int r = 0; r < 64; ++r) asm volatile("" : "+f"(d[r])::"memory");
}

// Merge running state (m2, s2, a2) into (m, s, a). s == 0 marks a state
// that has seen no column yet (any real state has s >= 1).
__device__ __forceinline__ void merge(float& m, float& s, int& a, float m2,
                                      float s2, int a2) {
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

__global__ void __launch_bounds__(THREADS, 1)
ctc_head_partial(const float* __restrict__ x,
                 const __grid_constant__ CUtensorMap w_map,
                 const float* __restrict__ b, int M, int D, int V,
                 float* __restrict__ part_m, float* __restrict__ part_s,
                 int* __restrict__ part_a) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t smem = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* const smem_ptr = smem_raw + (smem - smem_u32(smem_raw));
  const int nkb = D / KB;
  const uint32_t ring = smem;
  const uint32_t xs_hi = ring + STAGES * STAGE_BYTES;
  const uint32_t xs_lo = xs_hi + nkb * XBLOCK_BYTES;
  const uint32_t x_off = STAGES * STAGE_BYTES;
  const uint32_t merge_off = x_off + 2 * nkb * XBLOCK_BYTES;
  float* const mg_m = reinterpret_cast<float*>(smem_ptr + merge_off);
  float* const mg_s = mg_m + NWG * BM;
  int* const mg_a = reinterpret_cast<int*>(mg_s + NWG * BM);
  const uint32_t bars = smem + merge_off + MERGE_BYTES;
  // full[wg][stage], then empty[stage]
#define FULL_BAR(wg, st) (bars + 8u * ((wg) * STAGES + (st)))
#define EMPTY_BAR(st) (bars + 8u * (NWG * STAGES + (st)))

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  const int split = blockIdx.y;
  const int n_splits = gridDim.y;
  const int n_tiles = (V + BN - 1) / BN;
  const int t_begin = (int)((long long)split * n_tiles / n_splits);
  const int t_end = (int)((long long)(split + 1) * n_tiles / n_splits);
  const int n_local = t_end - t_begin;

  if (tid == 0) {
    for (int wg = 0; wg < NWG; ++wg) {
      for (int st = 0; st < STAGES; ++st) mbar_init(FULL_BAR(wg, st), 1);
    }
    // a warpgroup frees a stage with one arrival per warp
    for (int st = 0; st < STAGES; ++st) mbar_init(EMPTY_BAR(st), 4);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // ---- producer warp: one lane keeps the ring full ----
    if (tid == CONSUMERS) {
      uint32_t it = 0;
      for (int i = 0; i < n_local; ++i) {
        const int wg = i % NWG;
        for (int kb = 0; kb < nkb; ++kb, ++it) {
          const int st = it % STAGES;
          mbar_wait(EMPTY_BAR(st), ((it / STAGES) & 1u) ^ 1u);
          mbar_expect_tx(FULL_BAR(wg, st), STAGE_BYTES);
          tma_load_3d(ring + st * STAGE_BYTES, &w_map, FULL_BAR(wg, st),
                      kb * KB, (t_begin + i) * BN, 0);
        }
      }
    }
    return;
  }

  // ---- consumers ----
  // stage the x rows: split into hi and lo, K-major, 128-byte swizzle
  {
    const int chunks_per_row = D / 4;  // 16-byte chunks
    for (int c = tid; c < BM * chunks_per_row; c += CONSUMERS) {
      const int r = c / chunks_per_row;
      const int c4 = c - r * chunks_per_row;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (m0 + r < M) {
        v = __ldg(reinterpret_cast<const float4*>(x + (size_t)(m0 + r) * D) +
                  c4);
      }
      float4 hi, lo;
      hi.x = tf32_rna(v.x);
      hi.y = tf32_rna(v.y);
      hi.z = tf32_rna(v.z);
      hi.w = tf32_rna(v.w);
      lo.x = tf32_rna(v.x - hi.x);
      lo.y = tf32_rna(v.y - hi.y);
      lo.z = tf32_rna(v.z - hi.z);
      lo.w = tf32_rna(v.w - hi.w);
      const uint32_t off = (c4 >> 3) * XBLOCK_BYTES + r * 128 +
                           (((c4 & 7) ^ (r & 7)) << 4);
      *reinterpret_cast<float4*>(smem_ptr + x_off + off) = hi;
      *reinterpret_cast<float4*>(smem_ptr + x_off + nkb * XBLOCK_BYTES +
                                 off) = lo;
    }
    // make the stores visible to the tensor cores' (async proxy) reads
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("bar.sync 1, %0;" ::"n"(CONSUMERS) : "memory");
  }

  const int wg = tid >> 7;
  const int lane = tid & 31;
  const int q = lane & 3;
  // this thread's rows of the tile: row0 and row0 + 8
  const int row0 = ((tid & 127) >> 5) * 16 + (lane >> 2);
  float rm[2] = {-INFINITY, -INFINITY};
  float rs[2] = {0.f, 0.f};
  int ra[2] = {0, 0};
  uint32_t phases = 0;  // parity bit per stage of this warpgroup's barriers

  for (int i = wg; i < n_local; i += NWG) {
    const int v0 = (t_begin + i) * BN;
    // the thread's 32 bias values, -inf past the vocab
    float bias[32];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = v0 + 8 * j + 2 * q + e;
        bias[2 * j + e] = col < V ? __ldg(b + col) : -INFINITY;
      }
    }
    float acc[64];  // the tile's logits, summed over k-blocks
#pragma unroll
    for (int r = 0; r < 64; ++r) acc[r] = 0.f;

    uint32_t it = (uint32_t)i * nkb;
    for (int kb = 0; kb < nkb; ++kb, ++it) {
      const int st = it % STAGES;
      mbar_wait(FULL_BAR(wg, st), (phases >> st) & 1u);
      phases ^= 1u << st;
      const uint64_t a_hi = wgmma_desc(xs_hi + kb * XBLOCK_BYTES);
      const uint64_t a_lo = wgmma_desc(xs_lo + kb * XBLOCK_BYTES);
      const uint64_t b_hi = wgmma_desc(ring + st * STAGE_BYTES);
      const uint64_t b_lo = wgmma_desc(ring + st * STAGE_BYTES + HALF_BYTES);
      float blk[64];  // this k-block's share, small terms first
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < KB / 8; ++k) {
        wgmma_tf32(blk, a_lo + 2 * k, b_hi + 2 * k, k > 0);
        wgmma_tf32(blk, a_hi + 2 * k, b_lo + 2 * k, 1);
      }
#pragma unroll
      for (int k = 0; k < KB / 8; ++k) {
        wgmma_tf32(blk, a_hi + 2 * k, b_hi + 2 * k, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_operand(blk);
      if (lane == 0) mbar_arrive(EMPTY_BAR(st));  // the stage has been read
#pragma unroll
      for (int r = 0; r < 64; ++r) acc[r] += blk[r];
    }

    // epilogue on the fragment: acc[4 j + 2 h + e] is row row0 + 8 h,
    // column v0 + 8 j + 2 q + e
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float tm = -INFINITY;
      int ta = 0;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float l = acc[4 * j + 2 * h + e] + bias[2 * j + e];
          acc[4 * j + 2 * h + e] = l;
          // columns ascend with (j, e): strictly greater keeps the first
          const bool up = l > tm;
          tm = up ? l : tm;
          ta = up ? v0 + 8 * j + 2 * q + e : ta;
        }
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        const float om = __shfl_xor_sync(FULL, tm, off);
        const int oa = __shfl_xor_sync(FULL, ta, off);
        const bool take = om > tm || (om == tm && oa < ta);
        tm = take ? om : tm;
        ta = take ? oa : ta;
      }
      // this warpgroup's tiles ascend too: an equal later maximum loses
      ra[h] = tm > rm[h] ? ta : ra[h];
      const float mn = fmaxf(rm[h], tm);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          sum += __expf(acc[4 * j + 2 * h + e] - mn);
        }
      }
      // rs is this thread's share of the row's sum, on the quad's scale
      rs[h] = rs[h] * __expf(rm[h] - mn) + sum;
      rm[h] = mn;
    }
  }

  // a row's sum is spread over its quad; its maximum is not
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    rs[h] += __shfl_xor_sync(FULL, rs[h], 1);
    rs[h] += __shfl_xor_sync(FULL, rs[h], 2);
    if (q == 0) {
      const int o = wg * BM + row0 + 8 * h;
      mg_m[o] = rm[h];
      mg_s[o] = rs[h];
      mg_a[o] = ra[h];
    }
  }
  asm volatile("bar.sync 1, %0;" ::"n"(CONSUMERS) : "memory");
  if (tid < BM && m0 + tid < M) {
    float m = -INFINITY, s = 0.f;
    int a = 0;
#pragma unroll
    for (int g = 0; g < NWG; ++g) {
      merge(m, s, a, mg_m[g * BM + tid], mg_s[g * BM + tid],
            mg_a[g * BM + tid]);
    }
    const size_t o = (size_t)(m0 + tid) * n_splits + split;
    part_m[o] = m;
    part_s[o] = s;
    part_a[o] = a;
  }
#undef FULL_BAR
#undef EMPTY_BAR
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

typedef CUresult (*EncodeTiled)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up in the loaded libcuda at first use, so
// that nothing has to link against it
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW);
    if (lib != nullptr) {
      fn = reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
    }
  }
  return fn;
}

}  // namespace

// x (M, D) float32 row-major, w_split (2, V, D) float32: W transposed and
// split into TF32 hi and lo, b (V,); D a multiple of 32, at most 192; x and
// w_split 16-byte aligned. part_* are (M, n_splits) scratch, n_splits at
// most the count of 128-column vocab tiles; idx (M,) int32, prob (M,)
// float32. Returns the first CUDA error, 0 for none.
extern "C" int ctc_head_reduce(const float* x, const float* w_split,
                               const float* b, int M, int D, int V,
                               int n_splits, float* part_m, float* part_s,
                               int* part_a, int* idx, float* prob,
                               cudaStream_t stream) {
  const int n_tiles = (V + BN - 1) / BN;
  if (M <= 0 || V <= 0 || D <= 0 || D % KB || D > MAX_D || n_splits < 1 ||
      n_splits > n_tiles) {
    return (int)cudaErrorInvalidValue;
  }
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  // (hi | lo, vocab row, k), innermost first; a box is one ring stage;
  // rows past V read as zeros
  CUtensorMap w_map;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)V, 2};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 4, (cuuint64_t)V * D * 4};
  const cuuint32_t box[3] = {KB, BN, 2};
  const cuuint32_t elem[3] = {1, 1, 1};
  if (encode(&w_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
             const_cast<float*>(w_split), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      ctc_head_partial, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((M + BM - 1) / BM, n_splits);
  ctc_head_partial<<<grid, THREADS, smem, stream>>>(x, w_map, b, M, D, V,
                                                    part_m, part_s, part_a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ctc_head_combine<<<(M + 255) / 256, 256, 0, stream>>>(
      part_m, part_s, part_a, M, n_splits, idx, prob);
  return (int)cudaGetLastError();
}
