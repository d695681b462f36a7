// Factored big-clique contraction on Hopper (sm_90a).
//
//   out[b, c] = sum_{r1, r2} pot[r1, r2, c] * w1[b, r1] * w2[b, r2]
//
// Replaces the Pallas TPU kernel factored_masked_contract
// (junctiontree_tpu/ops/pallas_contract.py:181-307).  pot is the clique
// potential, w1 [B, R1] and w2 [B, R2] are the two batched evidence weight
// groups, out [B, C] is float32.  pot and w2 are float or bfloat16, w1 is
// float, the accumulator is float.
//
// The work is a matrix product
//   T[b, n] = sum_{r2} w2[b, r2] * P[r2, n],   n = (r1, c),
// with M = B, N = R1*C, K = R2, followed by out[b, c] = sum_{r1} w1[b, r1] *
// T[b, (r1, c)].  T [B, R1, C] never goes to device memory: the TPU kernel
// keeps it on chip, and the plain version spills it.  Two column tilings,
// chosen by the wrapper from C:
//   "n" (C <= 32): the columns are n = (r1, c) of pot stored [R2, R1*C]; the
//     epilogue scales each column by w1[b, r1(n)] and adds the columns of
//     equal c in ascending n: a fixed order.
//   "c" (C > 32): the columns are c of pot stored [R1, R2, C], r1 is looped
//     in the block, and each r1's sums are scaled by w1[b, r1] into a second
//     register tile.
// Rows, columns and r2 beyond the edge are zeros, which add nothing.  No
// sum anywhere depends on timing: two runs give the same bits.
//
// One kernel serves both input types: the tensor cores (wgmma.mma_async,
// bf16 in, f32 accumulators in registers) fed by the Tensor Memory
// Accelerator.  (float32 products of at most 32 columns, the model shards,
// keep the CUDA-core kernel factored_contract_fma_kernel below: at N = 16
// and 32 it measured faster than the tensor-core kernel, whose 64-column
// tile would be mostly zeros.)  Three sources of its operands (enum Src):
//   BF16: bf16 w2 and pot as they are, one pass.
//   F32X6 (float32, precision "highest", the default): six bf16 passes, as
//     XLA runs "highest" on the TPU's matrix unit.  Each f32 operand is
//     written hi + mid + lo, three bf16 numbers with 24 significand bits
//     between them, and the six products of order >= 2^-16 relative (hi.hi,
//     hi.mid, mid.hi, hi.lo, mid.mid, lo.hi) go into one f32 accumulator;
//     the three left out are at or below f32's own rounding.  So no product
//     runs in TF32: the package's precision contract (ops/semirings.py,
//     pinned_precision) holds in accuracy on the tensor cores.
//   F32X1 (float32, precision "default"): hi.hi alone, ~1e-3 relative.
//
// What bounds it, and the design.
//   w2 is 91-96% of the bytes: it is read from device memory exactly once,
//   in its own type, and nothing else of the bytes is repeated.  In bf16 the
//   bytes bound it (the tensor cores do the product in microseconds).  In
//   f32 the six passes do 2.15e9 x 6 bf16 operations at the serving shapes,
//   0.013 ms at 989 TFLOP/s against 0.011 ms for the 36 MB (the CUDA
//   cores' 67 TFLOP/s would take 0.032 ms): both bounds are close, and the
//   split costs CUDA-core work besides.
//   * A block of 384 threads owns BM = 128 rows and all N columns (BN = 64
//     or 128; wider N takes several column tiles): two consumer warpgroups
//     of 64 rows run wgmma (m64n64k16, or m64n128k16 for f32 at 128
//     columns), one producer thread keeps TMA loads in flight.  A stage
//     holds BK r2: one 128-byte row of w2 (64 bf16 or 32 f32).
//   * Loads: cp.async.bulk.tensor of the w2 tile [BM, BK] (K-major) and of
//     the pot tiles [BK, 64] (MN-major, read with the transpose bit; in f32
//     one per bf16 plane) through a ring of 192-200 KB with full and empty
//     mbarriers, all with the 128-byte swizzle.  TMA fills the ragged edges
//     of B, R2 and N with zeros.  Tensor maps are built on the host per call
//     (cuTensorMapEncodeTiled) and passed as __grid_constant__ parameters.
//   * bf16: A comes from shared memory by descriptor.  f32: each consumer
//     thread reads its A fragments (the wgmma m64k16 register layout) from
//     the swizzled f32 tile, splits them in registers (cvt.rn.bf16x2.f32
//     and two subtractions) and issues register-A wgmma; the split w2 never
//     goes to device memory.  pot (about 3% of the bytes) is split by
//     split_pot_kernel into three bf16 planes in the layouts the tensor
//     maps read: once per call for a tensor handed in, once per layout for
//     the standing potential of a serving path (the wrapper keeps the
//     planes beside it).
//   * Subnormals.  The serving floor 1e-38 is subnormal in f32 and in bf16,
//     where it holds about 7 bits: a plain split of such a row would miss by
//     4e-3.  So each stage scales each row's 32 values by an exact power of
//     two that brings their largest (a max over the quad of threads that
//     holds the row) into [1, 2), splits, and undoes the scale in f32 when
//     the stage's sum is added; pot is scaled once by its own largest
//     exponent, undone on the output.  A row of zeros stays exactly zero.
//   * Accuracy of the tensor-core sums: each stage's products are summed by
//     the tensor cores and then added in f32 outside them (one tensor-core
//     sum over a block's whole r2 range strayed several times further from
//     the plain version).  In f32 the five small passes of a stage go first,
//     while the accumulator is small, and hi.hi last.
//   * Filling the card: B = 4096 gives 32 row tiles for 132 SMs, so r2 is
//     split over the blocks of one thread-block cluster, as many (up to 8)
//     as lets every tile's cluster be resident at once (the wrapper asks
//     cudaOccupancyMaxActiveClusters: 3 on an H100 at B = 4096).  Each
//     block writes its [BM, C] partial to its shared memory, and after a
//     cluster barrier each block adds a slice of rows over the cluster's
//     blocks in rank order through distributed shared memory, bitwise
//     repeatable.  Where a tile's r2 takes several clusters (f32), or the
//     "n" tiling several column tiles (N > 128), each leaves a partial in
//     device memory; each block then counts itself in at its output tile
//     (one atomic increment), and the last to arrive adds the tile's
//     partials in a fixed order and resets the counter: still one launch,
//     and the same bits whichever block comes last.
//   * For C in {1, 2, 4, 8} (every serving shape) w1[b, r1(n)] is loaded
//     into registers before the loop and folded into each stage's products
//     at once, so the epilogue waits on no load; other C, and six passes
//     at 128 columns (registers), scale and add through shared memory.  w1
//     stays f32.
//   * Registers: a block of 384 threads has 168 a thread; the producer
//     warpgroup gives its own to the consumers (setmaxnreg: 56 and 224, so
//     that each of the SM's four register files keeps 256 spare; without
//     it three kernels spilled and six passes ran a third slower), and
//     ptxas -v reports no spills.
//   * What holds it back (clock64 and %globaltimer probes on an H100): in
//     f32 the consumers, not the loads: each stage's split of w2 and its w1
//     fold run on the same warps as the products, and the two warpgroups
//     take turns at the tensor cores (named barriers) so that one's split
//     overlaps the other's products; about 60% of the six passes' peak.
//     Then fixed costs a call: the prologue, the epilogue's sums.  The pot
//     split of a standing potential is made once and kept by the wrapper.
//   * TMA needs 16-byte aligned addresses and row strides: the wrapper
//     copies other w2 operands into an aligned, zero-padded buffer
//     (counted); the pot planes are aligned by construction.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 (no fast math, no
// flush-to-zero: the serving floor 1e-38 is subnormal in f32).

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

__device__ __forceinline__ int64_t imin(int64_t a, int64_t b) {
  return a < b ? a : b;
}

// Allow Kern `bytes` of dynamic shared memory, once per kernel and device:
// cudaFuncSetAttribute costs host time on every call.
template <auto Kern>
cudaError_t allow_smem(int bytes) {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (dev < 64 && done[dev])) return e;
  e = cudaFuncSetAttribute(Kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes);
  if (e == cudaSuccess && dev < 64) done[dev] = true;
  return e;
}

// Named barrier `id` of `n` threads: wait for all.
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// The r2 partials of one output tile, added inside the launch.  Every block
// that wrote its piece of the tile's partials into ws ([nparts, B, C])
// arrives at the tile's counter; the last of `arrivals` blocks adds the
// tile's nparts partials (rows [b0, b0 + rows), columns [c0, c0 + W)) in z
// order from 0.f, as a plain fixed-order sum would, writes them to out and
// sets the counter back to 0 for the next launch on its stream.  So the
// bits do not depend on which block comes last.  The threads tid <
// nthreads of the block take part (named barrier 1); a block that is not
// the last returns at once.  The sum is the launch's tail, so it keeps
// loads in flight: four float4 (or four floats) a thread at once, each
// z's loads issued together.  Not inlined, so that the contraction
// kernels' main loops keep the registers and code they had without it.
__device__ __noinline__ void add_parts_if_last(
    const float* __restrict__ ws, float* __restrict__ out,
    int* __restrict__ counter, int arrivals, int nparts, int64_t B,
    int64_t C, int64_t b0, int rows, int64_t c0, int W, int tid,
    int nthreads) {
  __shared__ int last;
  // every thread's partial is written; one thread publishes them all (the
  // barrier orders them before its fence, which is cumulative) and counts
  // the block in, and if it is the last, its second fence orders the
  // others' writes before the block's reads
  bar_sync(1, nthreads);
  if (tid == 0) {
    __threadfence();
    last = atomicAdd(counter, 1) == arrivals - 1;
    if (last) __threadfence();
  }
  bar_sync(1, nthreads);
  if (!last) return;
  const int64_t n = B * C;
  const int count = (int)imin(rows, B - b0) * W;  // elements of the tile
  // element e of the tile lies at at(e); whole rows are one range
  const bool flat = W == C;
  const int64_t base = b0 * C + c0;
  auto at = [&](int e) -> int64_t {
    return flat ? base + e : base + (int64_t)(e / W) * C + e % W;
  };
  constexpr int U = 4;  // outputs (float4 or float) a thread has in flight
  // float4 where four neighbouring elements are neighbours in memory, in
  // every partial (16-byte aligned: n a multiple of 4)
  const bool vec = n % 4 == 0 &&
                   (flat ? base % 4 == 0 : (C % 4 | c0 % 4 | W % 4) == 0);
  const int nq = vec ? count / 4 : 0;
  for (int q0 = tid; q0 < nq; q0 += U * nthreads) {
    float4 sum[U];
    int64_t i[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      sum[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      const int q = q0 + u * nthreads;
      i[u] = q < nq ? at(4 * q) : -1;
    }
#pragma unroll 8
    for (int z = 0; z < nparts; ++z) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (i[u] < 0) continue;
        const float4 v =
            __ldcg(reinterpret_cast<const float4*>(ws + z * n + i[u]));
        sum[u].x += v.x;
        sum[u].y += v.y;
        sum[u].z += v.z;
        sum[u].w += v.w;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (i[u] >= 0) *reinterpret_cast<float4*>(out + i[u]) = sum[u];
  }
  // the rest one float at a time (all of it where float4 does not fit)
  for (int e0 = 4 * nq + tid; e0 < count; e0 += U * nthreads) {
    float sum[U];
    int64_t i[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      sum[u] = 0.f;
      const int e = e0 + u * nthreads;
      i[u] = e < count ? at(e) : -1;
    }
#pragma unroll 8
    for (int z = 0; z < nparts; ++z) {
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (i[u] >= 0) sum[u] += __ldcg(ws + z * n + i[u]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (i[u] >= 0) out[i[u]] = sum[u];
  }
  if (tid == 0) *counter = 0;
}

// ===========================================================================
// float32, narrow products (N = R1*C <= 32): CUDA-core FMAs through a
// cp.async ring
// ===========================================================================

constexpr int NT = 128;     // threads per block
constexpr int NSTAGE = 3;   // shared-memory stages

// Block shape for a column tile of BN: BM * BN = NT * 64 accumulators, r2
// steps of BK, w2 tile rows padded to LDA.
template <int BN> struct Shape {
  static constexpr int BM = NT * 64 / BN;
  static constexpr int BK = 16;
  static constexpr int LDA = BK + 4;
  static constexpr int TX = BN / 8, TY = NT / TX;  // threads across, down
  static constexpr int A_ELEMS = BM * LDA;
  static constexpr int STAGE_ELEMS = A_ELEMS + BK * BN;
  static constexpr int PIPE_BYTES = NSTAGE * STAGE_ELEMS * 4;
  static constexpr int SUMS_BYTES = BM * (BN + 1) * 4;
  static constexpr int BYTES =
      PIPE_BYTES > SUMS_BYTES ? PIPE_BYTES : SUMS_BYTES;
};

// 16-byte asynchronous copy to shared memory; bytes past src_bytes are
// filled with zeros (src_bytes = 0 reads nothing).  L2::128B has the L2
// fetch the whole 128-byte line: a w2 tile row is 64 bytes a step, and the
// next step's 64 bytes then come from L2 (on an H100 it made the 16-column
// shard's launch faster and left the other shapes as they were).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global.L2::128B [%0], [%1], 16, %2;\n"
               ::"r"(s),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// What one thread copies each step, worked out once before the r2 loop: its
// 16-byte chunks of the w2 tile (rows b0.., r2 k0..) and of the pot tile
// (r2 k0.., columns n0.. of `bmat`, row stride ld, ncols columns).  Operands
// that are not 16-byte aligned are staged element by element instead.
template <int BN>
struct Loader {
  using S = Shape<BN>;
  static constexpr int BK = S::BK, LDA = S::LDA;
  static constexpr int CPR_A = BK / 4, CPR_B = BN / 4;  // chunks per row
  static constexpr int PA = S::BM * CPR_A / NT;
  static constexpr int B_CHUNKS = BK * CPR_B;
  static constexpr int PB = (B_CHUNKS + NT - 1) / NT;

  const float* w2;
  const float* bmat;
  int64_t B, R2, ld, ncols, b0, n0, k_end;
  bool vec_a, vec_b;
  const float* a_src[PA];  // w2 + b * R2 + the chunk's k offset; null if b >= B
  const float* b_src[PB];  // bmat + row * ld + n; null if n >= ncols

  __device__ __forceinline__ Loader(const float* w2_, const float* bmat_,
                                    int64_t B_, int64_t R2_, int64_t ld_,
                                    int64_t ncols_, int64_t b0_, int64_t n0_,
                                    int64_t k_end_, bool vec_a_, bool vec_b_)
      : w2(w2_), bmat(bmat_), B(B_), R2(R2_), ld(ld_), ncols(ncols_), b0(b0_),
        n0(n0_), k_end(k_end_), vec_a(vec_a_), vec_b(vec_b_) {
    const int tid = threadIdx.x;
#pragma unroll
    for (int p = 0; p < PA; ++p) {
      const int id = tid + p * NT;
      const int64_t b = b0 + id / CPR_A;
      a_src[p] = b < B ? w2 + b * R2 + (id % CPR_A) * 4 : nullptr;
    }
#pragma unroll
    for (int p = 0; p < PB; ++p) {
      const int id = tid + p * NT;
      const int64_t n = n0 + (id % CPR_B) * 4;
      b_src[p] = id < B_CHUNKS && n < ncols ? bmat + (id / CPR_B) * ld + n
                                            : nullptr;
    }
  }

  // Stage the tiles of r2 = k0.. into As, Bs.
  __device__ __forceinline__ void load(float* __restrict__ As,
                                       float* __restrict__ Bs,
                                       int64_t k0) const {
    const int tid = threadIdx.x;
    if (vec_a) {
#pragma unroll
      for (int p = 0; p < PA; ++p) {
        const int id = tid + p * NT;
        const int row = id / CPR_A, ch = id % CPR_A;
        // a chunk is whole or outside: k_end is R2 or a multiple of BK
        const bool ok = a_src[p] != nullptr && k0 + ch * 4 < k_end;
        cp_async16(As + row * LDA + ch * 4, ok ? a_src[p] + k0 : w2,
                   ok ? 16 : 0);
      }
    } else {
      for (int e = tid; e < S::BM * BK; e += NT) {
        const int row = e / BK, col = e % BK;
        const int64_t b = b0 + row, k = k0 + col;
        As[row * LDA + col] = (b < B && k < k_end) ? w2[b * R2 + k] : 0.f;
      }
    }
    if (vec_b) {
      const int64_t k_off = k0 * ld;
#pragma unroll
      for (int p = 0; p < PB; ++p) {
        const int id = tid + p * NT;
        if (id < B_CHUNKS) {
          const int row = id / CPR_B, ch = id % CPR_B;
          const bool ok = b_src[p] != nullptr && k0 + row < k_end;
          cp_async16(Bs + row * BN + ch * 4, ok ? b_src[p] + k_off : bmat,
                     ok ? 16 : 0);
        }
      }
    } else {
      for (int e = tid; e < BK * BN; e += NT) {
        const int row = e / BN, col = e % BN;
        const int64_t k = k0 + row, n = n0 + col;
        Bs[row * BN + col] =
            (k < k_end && n < ncols) ? bmat[k * ld + n] : 0.f;
      }
    }
  }
};

// Thread (ty, tx) = (tid / TX, tid % TX) holds rows ty + TY i (i < 8) and
// columns (BN / 2) j + 4 tx + e (j < 2, e < 4): acc[i * 8 + 4 j + e].  Each
// operand comes from shared memory in 16-byte loads: four r2 of one row of
// w2, four columns of one r2 of pot (16 FMAs per load).
template <int BN> struct Frag {
  using S = Shape<BN>;
  static __device__ __forceinline__ int row(int idx) {
    return threadIdx.x / S::TX + S::TY * (idx / 8);
  }
  static __device__ __forceinline__ int col(int idx) {
    return (BN / 2) * ((idx % 8) / 4) + 4 * (threadIdx.x % S::TX) + idx % 4;
  }
};

template <int BN>
__device__ __forceinline__ void compute_stage(float (&acc)[64],
                                              const float* __restrict__ As,
                                              const float* __restrict__ Bs) {
  using S = Shape<BN>;
  const int tx = threadIdx.x % S::TX, ty = threadIdx.x / S::TX;
#pragma unroll
  for (int kk = 0; kk < S::BK; kk += 4) {
    float4 a[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      a[i] = *reinterpret_cast<const float4*>(As + (ty + S::TY * i) * S::LDA + kk);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float* brow = Bs + (kk + q) * BN + 4 * tx;
      const float4 b0 = *reinterpret_cast<const float4*>(brow);
      const float4 b1 = *reinterpret_cast<const float4*>(brow + BN / 2);
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float av = q == 0 ? a[i].x : q == 1 ? a[i].y
                       : q == 2 ? a[i].z : a[i].w;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          acc[i * 8 + j] = fmaf(av, bv[j], acc[i * 8 + j]);
      }
    }
  }
}

// acc += w2[b0.., k_begin..k_end) x bmat[k_begin..k_end), n0..] through the
// cp.async ring.  Leaves no copy in flight and every thread past a barrier.
template <int BN>
__device__ __forceinline__ void main_loop(float (&acc)[64],
                                          float* __restrict__ smem,
                                          const Loader<BN>& loader,
                                          int64_t k_begin, int64_t k_end) {
  using S = Shape<BN>;
  const int nk = (int)((k_end - k_begin + S::BK - 1) / S::BK);
#pragma unroll
  for (int s = 0; s < NSTAGE - 1; ++s) {
    if (s < nk) {
      float* st = smem + s * S::STAGE_ELEMS;
      loader.load(st, st + S::A_ELEMS, k_begin + (int64_t)s * S::BK);
    }
    cp_async_commit();
  }
  for (int it = 0; it < nk; ++it) {
    cp_async_wait<NSTAGE - 2>();  // tile `it` has landed
    __syncthreads();              // ... for every thread; tile it-1 is read
    const int nx = it + NSTAGE - 1;
    if (nx < nk) {
      float* st = smem + (nx % NSTAGE) * S::STAGE_ELEMS;
      loader.load(st, st + S::A_ELEMS, k_begin + (int64_t)nx * S::BK);
    }
    cp_async_commit();
    const float* st = smem + (it % NSTAGE) * S::STAGE_ELEMS;
    compute_stage<BN>(acc, st, st + S::A_ELEMS);
  }
  cp_async_wait<0>();
  __syncthreads();
}

// Blocks: blockIdx.x = split * n_b + row tile; columns n = (r1, c) of pot
// stored [R2, R1*C], all N <= BN of them in one tile.  With nsplit = 1 the
// block writes its [BM, C] rows of out; else its partial goes to dst[split]
// ([nsplit, B, C]) and the last block of the row tile adds the nsplit
// partials into out (counters[row tile], add_parts_if_last).
template <int BN>
__global__ void __launch_bounds__(NT, 2)
factored_contract_fma_kernel(const float* __restrict__ pot,
                             const float* __restrict__ w1,
                             const float* __restrict__ w2,
                             float* __restrict__ dst, float* __restrict__ out,
                             int* __restrict__ counters, int64_t B,
                             int64_t R1, int64_t R2, int64_t C, int n_b,
                             int nsplit, int64_t k_per_split, int vec_a,
                             int vec_b) {
  using S = Shape<BN>;
  using Fr = Frag<BN>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);

  const int tid = threadIdx.x;
  const int64_t b0 = (blockIdx.x % n_b) * S::BM;
  const int64_t split = blockIdx.x / n_b;
  const int64_t k_begin = split * k_per_split;
  const int64_t k_end = imin(R2, k_begin + k_per_split);
  const int64_t N = R1 * C;

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  const Loader<BN> loader(w2, pot, B, R2, N, N, b0, 0, k_end, vec_a != 0,
                          vec_b != 0);
  main_loop<BN>(acc, smem, loader, k_begin, k_end);
  float* sums = smem;  // the ring is drained
  // sums[row][col] = w1[b, r1(col)] * T[b, col].  The thread's rows and the
  // r1 of its columns are worked out once, and every w1 is loaded from a
  // clamped address without a branch, so the loads overlap.
  const float* w1_row[8];
  bool row_ok[8];
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    const int64_t b = b0 + Fr::row(s * 8);
    row_ok[s] = b < B;
    w1_row[s] = w1 + imin(b, B - 1) * R1;
  }
  uint32_t r1_of[8];
  bool col_ok[8];
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    const int64_t n = Fr::col(s);
    col_ok[s] = n < N;
    r1_of[s] = (uint32_t)imin(n, N - 1) / (uint32_t)C;
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int rs = i / 8, cs = i % 8;
    const float w = w1_row[rs][r1_of[cs]];
    sums[Fr::row(i) * (BN + 1) + Fr::col(i)] =
        row_ok[rs] && col_ok[cs] ? w * acc[i] : 0.f;
  }
  __syncthreads();
  // row r: out[b, c] = the row's columns n = c (mod C), ascending
  for (int r = tid; r < S::BM; r += NT) {
    const int64_t b = b0 + r;
    if (b >= B) break;
    float* out_row = dst + (split * B + b) * C;
    const float* sum_row = sums + r * (BN + 1);
    for (int c = 0; c < (int)C; ++c) {
      float s = 0.f;
      for (int j = c; j < (int)N; j += (int)C) s += sum_row[j];
      out_row[c] = s;
    }
  }
  if (nsplit > 1)
    add_parts_if_last(dst, out, counters + blockIdx.x % n_b, nsplit, nsplit,
                      B, C, b0, S::BM, 0, (int)C, tid, NT);
}

template <int BN>
cudaError_t launch_fma(const float* pot, const float* w1, const float* w2,
                       float* dst, float* out, int* counters, int64_t B,
                       int64_t R1, int64_t R2, int64_t C, int n_b, int nsplit,
                       int64_t k_per_split, int vec_a, int vec_b,
                       cudaStream_t stream) {
  constexpr int bytes = Shape<BN>::BYTES;
  cudaError_t e = allow_smem<factored_contract_fma_kernel<BN>>(bytes);
  if (e != cudaSuccess) return e;
  factored_contract_fma_kernel<BN><<<(unsigned)((int64_t)n_b * nsplit), NT,
                                     bytes, stream>>>(
      pot, w1, w2, dst, out, counters, B, R1, R2, C, n_b, nsplit,
      k_per_split, vec_a, vec_b);
  return cudaGetLastError();
}

// ===========================================================================
// Exact powers of two and the three-way bf16 split
// ===========================================================================

// e with 2^e <= m < 2^(e + 1) for a finite m > 0 (subnormals included);
// 0 for m == 0.
__device__ __forceinline__ int exponent_of(float m) {
  const uint32_t bits = __float_as_uint(m) & 0x7FFFFFFFu;
  if (bits == 0) return 0;
  const int biased = (int)(bits >> 23);
  return biased > 0 ? biased - 127 : (31 - __clz((int)bits)) - 149;
}

// 2^e exactly, for e in [-149, 127] (subnormal below -126).
__device__ __forceinline__ float pow2(int e) {
  return e >= -126 ? __uint_as_float((uint32_t)(e + 127) << 23)
                   : __uint_as_float(1u << (e + 149));
}

// x * 2^k exactly (unless the result leaves f32's range) for k in
// [-149, 149]: two factors, since 2^k alone may not be a float.
struct Scale {
  float f1, f2;
  __device__ __forceinline__ explicit Scale(int k)
      : f1(pow2(k / 2)), f2(pow2(k - k / 2)) {}
  __device__ __forceinline__ float operator()(float x) const {
    return x * f1 * f2;
  }
};

__device__ __forceinline__ uint32_t bf162_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two floats as three bf16 pairs hi + mid + lo (the lower half of each
// 32-bit word holds x.x): hi = bf16(x), mid = bf16(x - hi), lo = bf16(x -
// hi - mid); both subtractions are exact in f32.
__device__ __forceinline__ void split3(float2 x, uint32_t& hi, uint32_t& mid,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x.x, x.y);
  const float2 hf = __bfloat1622float2(h);
  const float2 r = make_float2(x.x - hf.x, x.y - hf.y);
  const __nv_bfloat162 m = __floats2bfloat162_rn(r.x, r.y);
  const float2 mf = __bfloat1622float2(m);
  hi = bf162_bits(h);
  mid = bf162_bits(m);
  lo = bf162_bits(__floats2bfloat162_rn(r.x - mf.x, r.y - mf.y));
}

// ===========================================================================
// The split of pot into bf16 planes (float32 inputs)
// ===========================================================================

constexpr int SPLIT_THREADS = 256;
constexpr int SPLIT_BOX = 64;  // columns of a box: one pot box of a stage

// Block (g * n_k + ks) * ncb + cb splits box (g, ks, cb) of pot: rows ks *
// bk .. of row group g (r2 of r1 = g in the "c" tiling; the "n" tiling has
// one group) and columns cb * 64 .., the piece of one plane that one pot
// box of the kernel's stage ks holds.  It writes planes[p][row][col] (row
// stride ld; rows g * R2 + r2 in the "c" tiling) of pot * 2^-e, hi, mid,
// lo for nplanes = 3 and hi alone for 1, with e the exponent of the box's
// largest |pot| (0 for a box of zeros), and e into exps[block]; padding
// columns (ncols <= col < ld) are zeros.  pot[r1, r2, c] lies at r1 * s1 +
// r2 * s2 + c * s3.
__global__ void __launch_bounds__(SPLIT_THREADS)
split_pot_kernel(const float* __restrict__ pot,
                 __nv_bfloat16* __restrict__ planes, int* __restrict__ exps,
                 int nplanes, int by_n, int R2, int C, int ncols, int64_t ld,
                 int bk, int n_k, int ncb, int64_t rows, int64_t s1,
                 int64_t s2, int64_t s3) {
  constexpr int PER = 8;  // elements a thread, up to 2048 a box
  const int cb = blockIdx.x % ncb;
  const int ks = (blockIdx.x / ncb) % n_k;
  const int grp = blockIdx.x / (ncb * n_k);
  float x[PER];
  int64_t at[PER];  // plane offset of each element, -1 outside the planes
  float m = 0.f;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int e = threadIdx.x + i * SPLIT_THREADS;
    const int r2 = ks * bk + e / SPLIT_BOX;
    const int col = cb * SPLIT_BOX + e % SPLIT_BOX;
    const bool in = e < bk * SPLIT_BOX && r2 < R2 && col < ld;
    at[i] = in ? ((int64_t)grp * R2 + r2) * ld + col : -1;
    x[i] = 0.f;
    if (in && col < ncols) {
      const int64_t r1 = by_n ? col / C : grp, c = by_n ? col % C : col;
      x[i] = pot[r1 * s1 + r2 * s2 + c * s3];
    }
    m = fmaxf(m, fabsf(x[i]));
  }
#pragma unroll
  for (int d = 16; d > 0; d /= 2)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, d));
  __shared__ float warp_max[SPLIT_THREADS / 32];
  if (threadIdx.x % 32 == 0) warp_max[threadIdx.x / 32] = m;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < SPLIT_THREADS / 32; ++w) m = fmaxf(m, warp_max[w]);
  const int e = exponent_of(m);
  if (threadIdx.x == 0) exps[blockIdx.x] = e;
  const Scale scale(-e);
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    if (at[i] < 0) continue;
    const float v = scale(x[i]);
    const __nv_bfloat16 h = __float2bfloat16_rn(v);
    planes[at[i]] = h;
    if (nplanes == 3) {
      const float r = v - __bfloat162float(h);
      const __nv_bfloat16 mid = __float2bfloat16_rn(r);
      planes[rows * ld + at[i]] = mid;
      planes[2 * rows * ld + at[i]] =
          __float2bfloat16_rn(r - __bfloat162float(mid));
    }
  }
}

// ===========================================================================
// The tensor-core kernel: TMA loads and wgmma through an mbarrier ring
// ===========================================================================

namespace tc {

constexpr int NWG = 2;        // consumer warpgroups, 64 rows each
constexpr int BM = 64 * NWG;  // rows per block
constexpr int NCONS = 128 * NWG;  // consumer threads
constexpr int NT = NCONS + 128;  // and a producer warpgroup (one thread loads)
constexpr int MAX_CLUSTER = 8;

// Where the operands come from; see the note at the top.
enum Src { BF16, F32X6, F32X1 };

template <Src S> struct In {
  static constexpr bool F32 = S != BF16;
  static constexpr int BK = F32 ? 32 : 64;  // r2 a stage: a 128-byte w2 row
  static constexpr int PLANES = S == F32X6 ? 3 : 1;  // bf16 planes of pot
  // One block an SM with a deep ring: in bf16 two blocks of half the ring,
  // 64-row blocks and 256-row blocks all measured no faster.
  static constexpr int RING_BYTES = (F32 ? 200 : 192) * 1024;
};

// Shared memory of a block: the ring of NSTAGE stages (w2 tile, then the
// pot boxes plane by plane), reused after the loop for the epilogue's
// [BM][BN + 1] tile of sums ("n" tiling, other C) and the block's partial
// [BM][PW] behind it, then the full and empty mbarriers of the stages.
template <int BN, bool BY_N, Src S> struct Layout {
  static constexpr int BK = In<S>::BK;
  static constexpr int A_BYTES = BM * 128;  // w2 tile [BM rows][128 bytes]
  static constexpr int BOX = BK * 128;      // one [BK r2][64 n] bf16 box
  static constexpr int NB = BN / 64;        // boxes a plane
  static constexpr int B_BYTES = In<S>::PLANES * NB * BOX;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int NSTAGE = In<S>::RING_BYTES / STAGE;
  static constexpr int RING = NSTAGE * STAGE;
  static constexpr int PW = BY_N ? 32 : 64;  // C <= 32, or 64 columns of c
  static constexpr int SUMS = BY_N ? BM * (BN + 1) * 4 : 0;
  static constexpr int PART = SUMS;            // offset of the partial
  static constexpr int BARS = RING;            // offset of the mbarriers
  // + 1024: the ring starts at the first 1024-byte boundary (128-byte
  // swizzle atoms) of the dynamic shared memory
  static constexpr int BYTES = RING + 2 * NSTAGE * 8 + 1024;
  static_assert(SUMS + BM * PW * 4 <= RING, "the epilogue fits the ring");
  static_assert(BYTES <= 232448, "a block's shared memory");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Named barrier `id` of `n` threads: arrive without waiting (bar_sync,
// above, waits).
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// Wait until the phase of parity `parity` has completed.  A wait of more
// than about two seconds can only be a fault (a load that never lands):
// trap, so that the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  const long long t0 = clock64();
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > 4000000000LL) asm volatile("trap;");
  } while (!done);
}

__device__ __forceinline__ void tma_2d(uint32_t dst, const CUtensorMap* map,
                                       int x, int y, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(x), "r"(y)
      : "memory");
}
__device__ __forceinline__ void tma_3d(uint32_t dst, const CUtensorMap* map,
                                       int x, int y, int z, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(x), "r"(y), "r"(z)
      : "memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

#define WGMMA_D32                                                            \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),    \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),           \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),       \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),       \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),       \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),       \
      "+f"(d[31])
#define WGMMA_D32_LIST                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"

// d[64 x 64] = A[64 x 16] (K-major, shared memory) * B[16 x 64] (MN-major:
// transposed), plus d itself if `accumulate`.
// Thread t of the warpgroup holds d[i] at row 16 (t / 32) + (t % 32) / 4 +
// 8 ((i / 2) % 2), column 8 (i / 4) + 2 (t % 4) + i % 2.
__device__ __forceinline__ void wgmma_64x64(float (&d)[32], uint64_t da,
                                            uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WGMMA_D32_LIST
      ", %32, %33, p, 1, 1, 0, 1;\n}\n"
      : WGMMA_D32
      : "l"(da), "l"(db), "r"(accumulate));
}

// The same with A in registers: thread t holds, in a[q] (lower half the
// lower column), row 16 (t / 32) + (t % 32) / 4 + 8 (q % 2) and columns
// 2 (t % 4) + 8 (q / 2) + {0, 1} of A.
__device__ __forceinline__ void wgmma_64x64_ra(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WGMMA_D32_LIST
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WGMMA_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// The same for 128 columns (d0 the first 64, d1 the second) of a B
// operand made of two 64-column swizzle atoms `lbo` bytes apart (the
// descriptor's leading byte offset).
__device__ __forceinline__ void wgmma_64x128_ra(float (&d0)[32],
                                                float (&d1)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, "
      "1;\n}\n"
      : "+f"(d0[0]), "+f"(d0[1]), "+f"(d0[2]), "+f"(d0[3]), "+f"(d0[4]),
        "+f"(d0[5]), "+f"(d0[6]), "+f"(d0[7]), "+f"(d0[8]), "+f"(d0[9]),
        "+f"(d0[10]), "+f"(d0[11]), "+f"(d0[12]), "+f"(d0[13]), "+f"(d0[14]),
        "+f"(d0[15]), "+f"(d0[16]), "+f"(d0[17]), "+f"(d0[18]), "+f"(d0[19]),
        "+f"(d0[20]), "+f"(d0[21]), "+f"(d0[22]), "+f"(d0[23]), "+f"(d0[24]),
        "+f"(d0[25]), "+f"(d0[26]), "+f"(d0[27]), "+f"(d0[28]), "+f"(d0[29]),
        "+f"(d0[30]), "+f"(d0[31]), "+f"(d1[0]), "+f"(d1[1]), "+f"(d1[2]),
        "+f"(d1[3]), "+f"(d1[4]), "+f"(d1[5]), "+f"(d1[6]), "+f"(d1[7]),
        "+f"(d1[8]), "+f"(d1[9]), "+f"(d1[10]), "+f"(d1[11]), "+f"(d1[12]),
        "+f"(d1[13]), "+f"(d1[14]), "+f"(d1[15]), "+f"(d1[16]), "+f"(d1[17]),
        "+f"(d1[18]), "+f"(d1[19]), "+f"(d1[20]), "+f"(d1[21]), "+f"(d1[22]),
        "+f"(d1[23]), "+f"(d1[24]), "+f"(d1[25]), "+f"(d1[26]), "+f"(d1[27]),
        "+f"(d1[28]), "+f"(d1[29]), "+f"(d1[30]), "+f"(d1[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// How a block turns its products into its partial.
//   BY_C: the "c" tiling; each r1's sums are scaled by w1[b, r1] into `tot`.
//   FOLD: the "n" tiling with C in {1, 2, 4, 8}: every stage's products are
//     scaled by w1 (prefetched into registers before the loop) and added
//     into 2 x 2 sums a thread, one per row and column parity; the 4 lanes
//     of a quad that share c add theirs after the loop.
//   SMEM: the "n" tiling with other C: the stages are added into one f32
//     sum per column, scaled and added by columns through shared memory.
//   FOLD_PAIRS: FOLD for C in {2, 4, 8}, whose two columns 2 t, 2 t + 1 of
//     a thread share r1: half the prefetched w1 (six passes at 128
//     columns, whose registers hold no more).
enum Epi { BY_C, FOLD, SMEM, FOLD_PAIRS };

// The six passes of F32X6 as (w2 part, pot plane), 0 = hi, 1 = mid, 2 =
// lo, the small ones first: mid.mid, hi.lo, lo.hi, mid.hi, hi.mid, hi.hi.
__device__ __forceinline__ constexpr int pass_a(int ps) {
  return ps == 0 || ps == 3 ? 1 : ps == 2 ? 2 : 0;
}
__device__ __forceinline__ constexpr int pass_b(int ps) {
  return ps == 0 || ps == 4 ? 1 : ps == 1 ? 2 : 0;
}

// Blocks: blockIdx.x = ((column tile * n_b + row tile) * kparts + part) *
// nsplit + rank; the nsplit blocks of one (tile, part) form a cluster.  r2
// is split S = kparts * nsplit ways: block z = part * nsplit + rank takes
// the r2 steps z, z + S, z + 2 S, ..., so that a cluster reads
// neighbouring pieces of the same w2 rows at once.  "n" tiling: columns
// n = (r1, c) of the pot map [planes][R2, R1*C]; a cluster's [BM, C] sum
// goes to partial part * n_n + column tile of dst ([kparts * n_n, B, C]).
// "c" tiling: columns c of the pot map [planes * R1, R2, C], r1 looped
// here; a cluster's [BM, 64] sum goes to its columns of partial `part` of
// dst ([kparts, B, C]).  With nparts (kparts * n_n, or kparts) = 1, dst is
// out; else the last block of an output tile (a row tile in the "n"
// tiling, whose column tiles all fold into the same columns; a row and
// column tile in the "c" tiling) adds the tile's partials into out in a
// fixed order (add_parts_if_last, counters[tile]).  pot_exp (f32): the
// exponent each pot box of a stage was scaled by (jt_split_pot), undone on
// the stage's sums.
//
// Roles: warps 0-7 are two consumer warpgroups, warps 8-11 the producer
// warpgroup (one thread issues the loads), which gives its registers to the
// consumers (setmaxnreg: 224 and 56 a thread) and then only takes part in
// the cluster's barriers.  The consumers take turns at the tensor cores (named
// barriers 2 and 3): warpgroup 0 issues a stage's products, then 1, then 0
// the next stage's, so that one splits and folds while the other's
// products run.
template <int BN, Epi EPI, Src S>
__global__ void __launch_bounds__(NT, 1)
factored_contract_tc_kernel(const __grid_constant__ CUtensorMap map_w2,
                            const __grid_constant__ CUtensorMap map_pot,
                            const float* __restrict__ w1,
                            float* __restrict__ dst, float* __restrict__ out,
                            int* __restrict__ counters,
                            const int* __restrict__ pot_exp, int B,
                            int R1, int R2, int C, int n_b, int n_n,
                            int nsplit, int kparts) {
  constexpr bool BY_N = EPI != BY_C;
  constexpr bool IS_FOLD = EPI == FOLD || EPI == FOLD_PAIRS;
  constexpr int WV = EPI == FOLD_PAIRS ? 16 : 32;  // w1 values a box
  constexpr bool F32 = In<S>::F32;
  constexpr int BK = In<S>::BK, PLANES = In<S>::PLANES;
  using L = Layout<BN, BY_N, S>;
  constexpr int NSTAGE = L::NSTAGE, PW = L::PW, BOX = L::BOX;
  static_assert(BY_N || BN == 64, "the c tiling takes 64 columns");
  constexpr int NB = L::NB;  // pot boxes and wgmma per plane and 16 r2
  constexpr int KS = BK / 16;  // k16 steps a stage
  extern __shared__ unsigned char smem_dyn[];
  const uint32_t pad = (1024 - (smem_u32(smem_dyn) & 1023)) & 1023;
  unsigned char* smem = smem_dyn + pad;
  const uint32_t ring = smem_u32(smem);
  float* part = reinterpret_cast<float*>(smem + L::PART);
  const uint32_t full = smem_u32(smem + L::BARS);
  const uint32_t empty = full + NSTAGE * 8;

  const int tid = threadIdx.x;
  const int rest = blockIdx.x / nsplit;
  const int part_id = rest % kparts;
  // a block takes the tiles first, first + stride, ...: one, but for the
  // "c" tiling without clusters, whose grid may hold fewer blocks than
  // tiles (each tile then goes straight from registers to dst)
  const int n_tiles = n_b * n_n, first = rest / kparts;
  const int stride = (int)gridDim.x / (kparts * nsplit);
  int b0 = (first % n_b) * BM;
  int n0 = (first / n_b) * BN;
  const int N = R1 * C;
  const int nk_all = (R2 + BK - 1) / BK;
  const int S_all = kparts * nsplit;
  const int z = part_id * nsplit + (int)(blockIdx.x % nsplit);
  const int nk = z < nk_all ? (nk_all - z + S_all - 1) / S_all : 0;
  const int n_iter = nk * (BY_N ? 1 : R1);
  // the block's cluster writes partial part * n_n + column tile ("n") or
  // part ("c") of dst
  float* const mine =
      dst + (int64_t)(BY_N ? part_id * n_n + n0 / BN : part_id) * B * C;

  if (tid == 0) {
    for (int s = 0; s < NSTAGE; ++s) {
      mbar_init(full + 8 * s, 1);      // the producer's expect_tx
      mbar_init(empty + 8 * s, NCONS / 32);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the cluster's barriers below (none where a "c" tile has no cluster)
  const int cluster_syncs = EPI == BY_C && nsplit == 1 ? 0 : 2;
  // the warpgroup, warp-uniform as the compiler sees it (so that it gives
  // each role the registers setmaxnreg sets)
  const int wgroup = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (wgroup == NWG) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
    if (tid == NCONS) {
      int it = 0;  // stages so far: the ring's slot and phase
      for (int tile = first; tile < n_tiles; tile += stride) {
        const int tb0 = (tile % n_b) * BM, tn0 = (tile / n_b) * BN;
        for (int ti = 0; ti < n_iter; ++ti, ++it) {
          const int s = it % NSTAGE;
          if (it >= NSTAGE) mbar_wait(empty + 8 * s, ((it / NSTAGE) - 1) & 1);
          mbar_expect_tx(full + 8 * s, L::STAGE);
          const int k0 = ((BY_N ? ti : ti % nk) * S_all + z) * BK;
          const uint32_t st = ring + s * L::STAGE;
          tma_2d(st, &map_w2, k0, tb0, full + 8 * s);
#pragma unroll
          for (int p = 0; p < PLANES; ++p)
#pragma unroll
            for (int j = 0; j < NB; ++j) {
              const uint32_t dst_b = st + L::A_BYTES + (p * NB + j) * BOX;
              if constexpr (BY_N)
                tma_3d(dst_b, &map_pot, tn0 + 64 * j, k0, p, full + 8 * s);
              else
                tma_3d(dst_b, &map_pot, tn0, k0, ti / nk + p * R1,
                       full + 8 * s);
            }
        }
      }
    }
    __syncwarp();
    for (int i = 0; i < cluster_syncs; ++i) cg::this_cluster().sync();
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n");

  // Thread t of warpgroup g holds, per 64-column box j, acc[j][i] at row
  // 64 g + 16 (t / 32) + (t % 32) / 4 + 8 ((i / 2) % 2), column 64 j +
  // 8 (i / 4) + 2 (t % 4) + i % 2.  acc holds one stage's products (BK r2,
  // added by the tensor cores); the stages are added in f32 outside them.
  const int g = tid / 128, lane = tid % 32, warp = (tid % 128) / 32;
  const int row0 = 64 * g + 16 * warp + lane / 4;  // rows row0, row0 + 8
  float acc[NB][32];
  float sum[IS_FOLD ? 1 : NB][32];  // BY_C, SMEM: the stages' sums
  float wv[IS_FOLD ? NB : 1][WV];   // FOLD: w1[b, r1(n)] of each
  float fold[2][2] = {};                // FOLD: per row and column parity
#pragma unroll
  for (int j = 0; j < (IS_FOLD ? 1 : NB); ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) sum[j][i] = 0.f;
  if constexpr (IS_FOLD) {
    // r1(n) = n / C, a shift: C is 1, 2, 4 or 8 (a division for each of
    // the 64 loads cost several microseconds a launch); value i of a box
    // is that of acc element i (FOLD_PAIRS: of 2 i and 2 i + 1)
    const int log_c = __ffs(C) - 1;
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int v = 0; v < WV; ++v) {
        const int i = EPI == FOLD_PAIRS ? 2 * v : v;
        const int b = b0 + row0 + 8 * ((i / 2) % 2);
        const int n = n0 + 64 * j + 8 * (i / 4) + 2 * (lane % 4) + i % 2;
        wv[j][v] = b < B && n < N ? __ldg(w1 + (int64_t)b * R1 + (n >> log_c))
                                  : 0.f;
      }
  }
  float tot[EPI == BY_C ? 32 : 1];
#pragma unroll
  for (int i = 0; i < (EPI == BY_C ? 32 : 1); ++i) tot[i] = 0.f;

  {
    // consumers: warpgroup g multiplies rows 64 g .. 64 g + 63
    const int q4 = lane / 4, t = lane % 4;
    // the first turn at the tensor cores is warpgroup 0's
    if (g == 1) bar_arrive(2, NCONS);
    int it = 0;  // stages so far: the ring's slot and phase
    for (int tile = first; tile < n_tiles; tile += stride) {
      b0 = (tile % n_b) * BM;
      n0 = (tile / n_b) * BN;
      for (int ti = 0; ti < n_iter; ++ti, ++it) {
        const int s = it % NSTAGE;
        const uint32_t bt = ring + s * L::STAGE + L::A_BYTES;
        // f32: the exponents of this stage's pot boxes (group, step, box)
        int pe[NB];
        if constexpr (F32) {
          const int ncb = ((BY_N ? N : C) + 63) / 64;
          // the stage's r2 step and, in the "c" tiling, r1
          const int step = (BY_N ? ti : ti % nk) * S_all + z;
          const int grp = BY_N ? 0 : ti / nk;
          const int* at = pot_exp + (grp * nk_all + step) * ncb + n0 / 64;
#pragma unroll
          for (int j = 0; j < NB; ++j) pe[j] = __ldg(at + j);
        }
        mbar_wait(full + 8 * s, (it / NSTAGE) & 1);
        // B: rows of 64 n, 128 bytes; 8-row groups 1024 bytes apart, 16 r2 =
        // 2048 bytes on.
        auto desc_b = [&](int p, int j, int kk) {
          return desc_sw128(bt + (p * NB + j) * BOX + kk * 2048, BOX, 1024);
        };
        float u[2] = {1.f, 1.f};  // f32: the rows' scales, undone on acc
        if constexpr (F32) {
          // A fragments of rows row0 + 8 h: the f32 values at r2 16 kk +
          // 8 q + 2 t + {0, 1} of the swizzled row (chunk c at c ^ (row %
          // 8)); one row at a time, since its scale needs only its own
          const unsigned char* rows =
              smem + s * L::STAGE + row0 * 128 + (t % 2) * 8;
          uint32_t frag[KS][In<S>::PLANES][4];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float2 x[KS][2];
            float m = 0.f;
#pragma unroll
            for (int kk = 0; kk < KS; ++kk)
#pragma unroll
              for (int q = 0; q < 2; ++q) {
                x[kk][q] = *reinterpret_cast<const float2*>(
                    rows + h * 1024 + (((4 * kk + 2 * q + t / 2) ^ q4) * 16));
                m = fmaxf(m, fmaxf(fabsf(x[kk][q].x), fabsf(x[kk][q].y)));
              }
            m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
            m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
            const int e = exponent_of(m);
            u[h] = pow2(e);
            const Scale sc(-e);
#pragma unroll
            for (int kk = 0; kk < KS; ++kk)
#pragma unroll
              for (int q = 0; q < 2; ++q) {
                const float2 v = make_float2(sc(x[kk][q].x), sc(x[kk][q].y));
                if constexpr (S == F32X6) {
                  split3(v, frag[kk][0][2 * q + h], frag[kk][1][2 * q + h],
                         frag[kk][2][2 * q + h]);
                } else {
                  frag[kk][0][2 * q + h] =
                      bf162_bits(__floats2bfloat162_rn(v.x, v.y));
                }
              }
          }
          bar_sync(2 + g, NCONS);  // this warpgroup's turn
          wgmma_fence();
          // (w2 part, pot plane) of each pass; one wgmma covers all BN
          // columns (two boxes at 128)
          constexpr int NPASS = S == F32X6 ? 6 : 1;
#pragma unroll
          for (int ps = 0; ps < NPASS; ++ps)
#pragma unroll
            for (int kk = 0; kk < KS; ++kk) {
              const int pa = S == F32X6 ? pass_a(ps) : 0;
              const int pb = S == F32X6 ? pass_b(ps) : 0;
              if constexpr (NB == 2)
                wgmma_64x128_ra(acc[0], acc[NB - 1], frag[kk][pa],
                                desc_b(pb, 0, kk), ps + kk > 0);
              else
                wgmma_64x64_ra(acc[0], frag[kk][pa], desc_b(pb, 0, kk),
                               ps + kk > 0);
            }
        } else {
          // A: 128-byte rows, 8-row groups 1024 bytes apart, 16 r2 = 32 bytes
          // along the row
          const uint32_t a = ring + s * L::STAGE + g * 64 * 128;
          bar_sync(2 + g, NCONS);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < KS; ++kk)
#pragma unroll
            for (int j = 0; j < NB; ++j)
              wgmma_64x64(acc[j], desc_sw128(a + kk * 32, 16, 1024),
                          desc_b(0, j, kk), kk > 0);
        }
        wgmma_commit();
        bar_arrive(3 - g, NCONS);  // the other warpgroup's turn
        wgmma_wait0();
        if (lane == 0) mbar_arrive(empty + 8 * s);
        // f32: the scales of rows h and pot box j, undone together
        float us[NB][2];
#pragma unroll
        for (int j = 0; j < NB; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) us[j][h] = F32 ? u[h] * pow2(pe[j]) : 1.f;
        if constexpr (IS_FOLD) {
          if constexpr (F32) {
            // the stage's fold per box, row and parity, then its scales
            // undone
#pragma unroll
            for (int j = 0; j < NB; ++j) {
              float st[2][2] = {};
#pragma unroll
              for (int i = 0; i < 32; ++i)
                st[(i / 2) % 2][i % 2] =
                    fmaf(wv[j][i * WV / 32], acc[j][i], st[(i / 2) % 2][i % 2]);
#pragma unroll
              for (int h = 0; h < 2; ++h)
#pragma unroll
                for (int p = 0; p < 2; ++p)
                  fold[h][p] = fmaf(st[h][p], us[j][h], fold[h][p]);
            }
          } else {
            // boxes, then columns, ascending
#pragma unroll
            for (int j = 0; j < NB; ++j)
#pragma unroll
              for (int i = 0; i < 32; ++i)
                fold[(i / 2) % 2][i % 2] =
                    fmaf(wv[j][i * WV / 32], acc[j][i],
                         fold[(i / 2) % 2][i % 2]);
          }
        } else {
#pragma unroll
          for (int j = 0; j < NB; ++j)
#pragma unroll
            for (int i = 0; i < 32; ++i)
              sum[j][i] = F32 ? fmaf(acc[j][i], us[j][(i / 2) % 2], sum[j][i])
                              : sum[j][i] + acc[j][i];
        }
        if constexpr (EPI == BY_C) {
          if (ti % nk == nk - 1) {  // the last step of r1 = ti / nk
            const int r1 = ti / nk, rb = b0 + row0;
            const float w_lo = rb < B ? w1[(int64_t)rb * R1 + r1] : 0.f;
            const float w_hi =
                rb + 8 < B ? w1[(int64_t)(rb + 8) * R1 + r1] : 0.f;
#pragma unroll
            for (int i = 0; i < 32; ++i) {
              tot[i] = fmaf((i / 2) % 2 ? w_hi : w_lo, sum[0][i], tot[i]);
              sum[0][i] = 0.f;
            }
          }
        }
      }
      if constexpr (EPI == BY_C) {
        if (nsplit == 1) {
          // no cluster: the block's sums are its part of the output
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const int row = row0 + 8 * ((i / 2) % 2);
            const int col = 8 * (i / 4) + 2 * (lane % 4) + i % 2;
            if (b0 + row < B && n0 + col < C)
              mine[(int64_t)(b0 + row) * C + n0 + col] = tot[i];
            tot[i] = 0.f;
          }
        }
      }
    }
  }
  // warpgroup 1's last turn handed to warpgroup 0 is not taken: take it,
  // so that no barrier is left half done
  if (g == 0) bar_sync(2, NCONS);
  bar_sync(1, NCONS);  // every load landed and was read: the ring is free

  if constexpr (IS_FOLD) {
    // column n of quad lane t has c = (n0 + 2 t + n % 2) mod C; the lanes
    // that share c add their sums in a fixed butterfly, one lane writes
    {
      const int t = lane % 4;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float s0 = fold[h][0], s1 = fold[h][1];
        if (C <= 4) {
          if (C <= 2) {
            s0 += __shfl_xor_sync(0xffffffffu, s0, 1);
            s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
          }
          s0 += __shfl_xor_sync(0xffffffffu, s0, 2);
          s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
        }
        float* prow = part + (row0 + 8 * h) * PW;
        if (C == 1) {
          if (t == 0) prow[0] = s0 + s1;
        } else if (2 * t < C) {
          prow[(n0 + 2 * t) % C] = s0;
          prow[(n0 + 2 * t + 1) % C] = s1;
        }
      }
    }
  } else if constexpr (EPI == SMEM) {
    // sums[row][col] = w1[b, r1(n)] * T[b, n], then part[r][c] = row r's
    // columns n = c (mod C), ascending; one (r, c) a thread
    float* sums = reinterpret_cast<float*>(smem);  // [BM][BN + 1]
    // r1(n) = n / C, a shift where C is a power of two
    const bool pow2_c = (C & (C - 1)) == 0;
    const int log_c = __ffs(C) - 1;
    {
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int row = row0 + 8 * ((i / 2) % 2);
          const int col = 64 * j + 8 * (i / 4) + 2 * (lane % 4) + i % 2;
          const int b = b0 + row, n = n0 + col;
          const int r1 = pow2_c ? n >> log_c : n / C;
          sums[row * (BN + 1) + col] =
              b < B && n < N ? w1[(int64_t)b * R1 + r1] * sum[j][i] : 0.f;
        }
    }
    bar_sync(1, NCONS);
    const int width = min(N, n0 + BN) - n0;
    for (int e = tid; e < BM * C; e += NCONS) {
      const int r = e / C, c = e % C;
      const float* sum_row = sums + r * (BN + 1);
      float s = 0.f;
#pragma unroll 8
      for (int j = (c - n0 % C + C) % C; j < width; j += C) s += sum_row[j];
      part[r * PW + c] = s;
    }
  } else {
    if (nsplit == 1) {  // written in the loop; uniform over the block
      // one tile a block wherever a tile has several parts
      if (kparts > 1)
        add_parts_if_last(dst, out, counters + (n0 / BN) * n_b + b0 / BM,
                          kparts, kparts, B, C, b0, min(BM, B - b0), n0,
                          min(64, C - n0), tid, NCONS);
      return;
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int row = row0 + 8 * ((i / 2) % 2);
      const int col = 8 * (i / 4) + 2 * (lane % 4) + i % 2;
      part[row * PW + col] = tot[i];
    }
  }

  // the cluster's partials, added in rank order: block `rank` sums rows
  // [rank * per, (rank + 1) * per) of the tile and writes them out
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int rank = (int)cluster.block_rank();
  const int per = (BM + nsplit - 1) / nsplit;
  const int lo = rank * per, hi = min(BM, lo + per);
  const int W = BY_N ? C : min(64, C - n0);
  for (int e = tid; e < (hi - lo) * W; e += NCONS) {
    const int row = lo + e / W, col = e % W;
    const int b = b0 + row;
    if (b >= B) continue;
    float v[MAX_CLUSTER];  // all loads in flight before the first add
#pragma unroll
    for (int q = 0; q < MAX_CLUSTER; ++q)
      v[q] = q < nsplit ? cluster.map_shared_rank(part, q)[row * PW + col]
                        : 0.f;
    float s = v[0];
#pragma unroll
    for (int q = 1; q < MAX_CLUSTER; ++q)
      if (q < nsplit) s += v[q];
    mine[(int64_t)b * C + (BY_N ? 0 : n0) + col] = s;
  }
  cluster.sync();  // no block leaves while another reads its partial
  // partials of an output tile, and the blocks that write them
  const int nparts = kparts * (BY_N ? n_n : 1);
  if (nparts > 1)
    add_parts_if_last(dst, out,
                      counters + (BY_N ? 0 : (n0 / BN) * n_b) + b0 / BM,
                      nparts * nsplit, nparts, B, C, b0, min(BM, B - b0),
                      BY_N ? 0 : n0, W, tid, NCONS);
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, fetched through the runtime (no link
// against libcuda); null if the driver has none.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A tensor map with the 128-byte swizzle: dims and box innermost first,
// strides in bytes of every dimension above the first.  Out-of-range
// elements read as zero.
CUresult make_map(CUtensorMap* map, CUtensorMapDataType type,
                  const void* base, int rank, const cuuint64_t* dims,
                  const cuuint64_t* strides, const cuuint32_t* box) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return CUDA_ERROR_NOT_SUPPORTED;
  const cuuint32_t ones[3] = {1, 1, 1};
  return fn(map, type, (cuuint32_t)rank, const_cast<void*>(base), dims,
            strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int BN, Epi EPI, Src S>
cudaError_t launch(const CUtensorMap& mw2, const CUtensorMap& mpot,
                   const float* w1, float* dst, float* out, int* counters,
                   const int* pot_exp, int B, int R1, int R2, int C, int n_b,
                   int n_n, int nsplit, int kparts, int grid,
                   cudaStream_t stream) {
  auto kern = factored_contract_tc_kernel<BN, EPI, S>;
  constexpr int bytes = Layout<BN, EPI != BY_C, S>::BYTES;
  cudaError_t e = allow_smem<factored_contract_tc_kernel<BN, EPI, S>>(bytes);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)grid);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)nsplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, mw2, mpot, w1, dst, out, counters,
                         pot_exp, B, R1, R2, C, n_b, n_n, nsplit, kparts);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// Whether the 128-column "n" tiling folds w1 into each stage with all 64
// w1 values of a thread: not in six passes, whose 24 fragment registers
// beside 64 products and 64 w1 values spilled even at 224 registers; they
// fold over column pairs (C in {2, 4, 8}) or add through shared memory.
template <Src S> constexpr bool FOLD_128 = S != F32X6;

// The kernel of (bn, tiling, C) for source S.
template <Src S>
cudaError_t dispatch(const CUtensorMap& mw2, const CUtensorMap& mpot,
                     const float* w1, float* dst, float* out, int* counters,
                     const int* pot_exp, int by_n, int bn, int B, int R1,
                     int R2, int C, int n_b, int n_n, int nsplit, int kparts,
                     int grid, cudaStream_t s) {
  const bool fold = 8 % C == 0;  // C in {1, 2, 4, 8}
#define JT_LAUNCH(BN_, EPI_)                                                 \
  launch<BN_, EPI_, S>(mw2, mpot, w1, dst, out, counters, pot_exp, B, R1,   \
                       R2, C, n_b, n_n, nsplit, kparts, grid, s)
  if (!by_n && bn == 64) return JT_LAUNCH(64, BY_C);
  if (by_n && bn == 64) return fold ? JT_LAUNCH(64, FOLD) : JT_LAUNCH(64, SMEM);
  if (by_n && bn == 128) {
    if constexpr (FOLD_128<S>) {
      if (fold) return JT_LAUNCH(128, FOLD);
    } else {
      if (fold && C > 1) return JT_LAUNCH(128, FOLD_PAIRS);
    }
    return JT_LAUNCH(128, SMEM);
  }
#undef JT_LAUNCH
  return cudaErrorInvalidValue;
}

// Clusters of `cluster` blocks of kernel (bn, by_n) for source S that the
// card can hold at once, or -(cudaError_t).
template <Src S>
int max_clusters(int bn, int by_n, int cluster) {
  auto pick = [&](auto kern, int bytes) -> int {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return -(int)e;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)(cluster * 64));
    cfg.blockDim = dim3(NT);
    cfg.dynamicSmemBytes = bytes;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int n = 0;
    e = cudaOccupancyMaxActiveClusters(&n, kern, &cfg);
    return e == cudaSuccess ? n : -(int)e;
  };
  if (!by_n) return pick(factored_contract_tc_kernel<64, BY_C, S>,
                         Layout<64, false, S>::BYTES);
  if (bn == 64) return pick(factored_contract_tc_kernel<64, FOLD, S>,
                            Layout<64, true, S>::BYTES);
  return pick(
      factored_contract_tc_kernel<128, FOLD_128<S> ? FOLD : FOLD_PAIRS, S>,
      Layout<128, true, S>::BYTES);
}

}  // namespace tc

// Error codes above this are a CUresult of cuTensorMapEncodeTiled.
constexpr int MAP_ERROR = 100000;

}  // namespace

extern "C" {

// Launch the contraction on `stream`.  `src` is 0 for bf16 w2 and pot, 1
// for f32 w2 and pot's three bf16 planes (six passes), 2 for f32 w2 and
// pot's first plane (one pass).  `by_n` picks the tiling and with it pot's
// layout: [planes][R2][ld_pot] rows of n = (r1, c) if set, else
// [planes * R1][R2][ld_pot] rows of c; ld_pot and ld_w2 (w2's row stride)
// are in elements, with 16-byte aligned bases and rows.  bn, n_b, n_n,
// nsplit, kparts and grid are the wrapper's launch_config: nsplit is the
// cluster size, kparts the clusters of a tile, each leaving a partial, and
// block z of the tile's kparts * nsplit takes the r2 steps numbered z, z +
// kparts * nsplit, ...; a grid of fewer than n_b * n_n * kparts * nsplit
// blocks (the "c" tiling, nsplit = kparts = 1) walks the tiles in turn.
// pot_exp (src 1, 2): what jt_split_pot left.  With nparts = kparts * (n_n
// for the "n" tiling, else 1) > 1, `ws` is a [nparts, B, C] float32 scratch
// buffer for the partials, which the last block of each output tile adds
// into `out`, and `counters` holds an int32 of zero for each output tile
// (n_b, or n_b * n_n in the "c" tiling), left at zero: one buffer for each
// stream, never shared between launches that may run at once.  With
// nparts == 1 both are unused and the kernel writes `out`.  One launch;
// returns its cudaError_t (0 on success), or MAP_ERROR + the CUresult of a
// tensor map that could not be made; it does not synchronise.
int jt_factored_contract(const void* pot, const void* w1, const void* w2,
                         void* out, void* ws, void* counters, int src,
                         int by_n, int64_t B, int64_t R1, int64_t R2,
                         int64_t C, int bn, int n_b, int n_n, int nsplit,
                         int kparts, int grid, int nparts, int64_t ld_pot,
                         int64_t ld_w2, const void* pot_exp, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* res = static_cast<float*>(out);
  float* dst = static_cast<float*>(nparts > 1 ? ws : out);
  int* cnt = static_cast<int*>(counters);
  const float* a = static_cast<const float*>(w1);
  const int* pexp = static_cast<const int*>(pot_exp);
  const bool f32 = src != 0;
  const int planes = src == 1 ? 3 : 1;
  // w2 [B][ld_w2]: boxes of one 128-byte row piece by BM rows
  CUtensorMap mw2, mpot;
  const cuuint64_t w2_dims[2] = {(cuuint64_t)R2, (cuuint64_t)B};
  const cuuint64_t w2_strides[1] = {(cuuint64_t)ld_w2 * (f32 ? 4 : 2)};
  const cuuint32_t w2_box[2] = {f32 ? 32u : 64u, (cuuint32_t)tc::BM};
  CUresult r = tc::make_map(
      &mw2, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      w2, 2, w2_dims, w2_strides, w2_box);
  if (r == CUDA_SUCCESS) {
    // pot planes: [z][R2][ld_pot] bf16, z the plane ("n") or plane * R1 +
    // r1 ("c"); boxes of 64 columns by one stage of r2
    const cuuint64_t dims[3] = {(cuuint64_t)(by_n ? R1 * C : C),
                                (cuuint64_t)R2,
                                (cuuint64_t)(planes * (by_n ? 1 : R1))};
    const cuuint64_t strides[2] = {(cuuint64_t)ld_pot * 2,
                                   (cuuint64_t)(ld_pot * R2 * 2)};
    const cuuint32_t box[3] = {64, f32 ? 32u : 64u, 1};
    r = tc::make_map(&mpot, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, pot, 3, dims,
                     strides, box);
  }
  if (r != CUDA_SUCCESS) return MAP_ERROR + (int)r;
  const int b = (int)B, r1 = (int)R1, r2 = (int)R2, c = (int)C;
  cudaError_t err =
      src == 0   ? tc::dispatch<tc::BF16>(mw2, mpot, a, dst, res, cnt, pexp,
                                          by_n, bn, b, r1, r2, c, n_b, n_n,
                                          nsplit, kparts, grid, s)
      : src == 1 ? tc::dispatch<tc::F32X6>(mw2, mpot, a, dst, res, cnt, pexp,
                                           by_n, bn, b, r1, r2, c, n_b, n_n,
                                           nsplit, kparts, grid, s)
                 : tc::dispatch<tc::F32X1>(mw2, mpot, a, dst, res, cnt, pexp,
                                           by_n, bn, b, r1, r2, c, n_b, n_n,
                                           nsplit, kparts, grid, s);
  return (int)err;
}

// The narrow float32 product (N = R1*C <= bn, bn 16 or 32): pot is [R2,
// R1*C] rows, w2 [B, R2], both contiguous; vec_a / vec_b say that w2 / pot
// may be staged in 16-byte chunks.  Block (split, row tile) takes r2 in
// [split * k_per_split, ...).  With nsplit > 1, `ws` is a [nsplit, B, C]
// float32 scratch buffer for the partials, which the last block of each
// row tile adds into `out`, and `counters` n_b int32 zeros, as for
// jt_factored_contract; else the kernel writes `out`.  One launch; returns
// its cudaError_t.
int jt_factored_contract_fma(const void* pot, const void* w1, const void* w2,
                             void* out, void* ws, void* counters, int64_t B,
                             int64_t R1, int64_t R2, int64_t C, int bn,
                             int n_b, int nsplit, int64_t k_per_split,
                             int vec_a, int vec_b, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* res = static_cast<float*>(out);
  float* dst = static_cast<float*>(nsplit > 1 ? ws : out);
  int* cnt = static_cast<int*>(counters);
  const float* p = static_cast<const float*>(pot);
  const float* a = static_cast<const float*>(w1);
  const float* w = static_cast<const float*>(w2);
  cudaError_t err =
      bn == 16 ? launch_fma<16>(p, a, w, dst, res, cnt, B, R1, R2, C, n_b,
                                nsplit, k_per_split, vec_a, vec_b, s)
      : bn == 32 ? launch_fma<32>(p, a, w, dst, res, cnt, B, R1, R2, C, n_b,
                                  nsplit, k_per_split, vec_a, vec_b, s)
                 : cudaErrorInvalidValue;
  return (int)err;
}

// Split the f32 pot [R1, R2, C] (element strides s1, s2, s3) into
// `nplanes` (3 or 1) bf16 planes in the layout jt_factored_contract reads
// (by_n: [R2][ld] rows of n = (r1, c); else [R1 * R2][ld] rows of c), each
// box of bk rows and 64 columns scaled by the exponent of its largest
// |pot|, which goes to exps[(g * n_k + ks) * ncb + cb] (g = r1 in the "c"
// tiling, else 0; n_k = ceil(R2 / bk), ncb = ceil(columns / 64)).  One
// launch on `stream`; returns its cudaError_t.
int jt_split_pot(const void* pot, void* planes, void* exps, int nplanes,
                 int by_n, int64_t R1, int64_t R2, int64_t C, int64_t s1,
                 int64_t s2, int64_t s3, int64_t ld, int bk, void* stream) {
  const int64_t ncols = by_n ? R1 * C : C;
  const int n_k = (int)((R2 + bk - 1) / bk);
  const int ncb = (int)((ncols + SPLIT_BOX - 1) / SPLIT_BOX);
  const int64_t boxes = (by_n ? 1 : R1) * n_k * ncb;
  if (bk * SPLIT_BOX > 8 * SPLIT_THREADS || boxes > 0x7FFFFFFF)
    return (int)cudaErrorInvalidValue;
  split_pot_kernel<<<(unsigned)boxes, SPLIT_THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pot), static_cast<__nv_bfloat16*>(planes),
      static_cast<int*>(exps), nplanes, by_n, (int)R2, (int)C, (int)ncols,
      ld, bk, n_k, ncb, by_n ? R2 : R1 * R2, s1, s2, s3);
  return (int)cudaGetLastError();
}

const char* jt_error_string(int err) {
  if (err >= MAP_ERROR) return "cuTensorMapEncodeTiled failed (CUresult in the code)";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Clusters of `cluster` blocks of the kernel (src, bn, by_n) that the card
// can hold at once (cudaOccupancyMaxActiveClusters), or -(cudaError_t).
int jt_max_clusters(int src, int bn, int by_n, int cluster) {
  if (src == 0) return tc::max_clusters<tc::BF16>(bn, by_n, cluster);
  if (src == 1) return tc::max_clusters<tc::F32X6>(bn, by_n, cluster);
  return tc::max_clusters<tc::F32X1>(bn, by_n, cluster);
}

}  // extern "C"
