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
// float32: what bounds it, and the design.
//   At the serving shapes (B = 4096, R1 = 64, R2 = 2048-4096, C <= 2) the
//   product is 2.15e9 operations over 36-69 MB, about 60 per byte, above the
//   card's f32 ridge of 20 (67 TFLOP/s over 3.35 TB/s): the FMA pipe bounds
//   it.  A model shard (R1 = 16, N = 16 or 32 columns) does a quarter of the
//   operations on the same w2, about 15 per byte: bytes bound it.
//   * A block of 128 threads owns BM x BN with BM * BN = 8192: BN = 64
//     columns by 128 rows, or for narrow products (N <= 32) BN = 32 by 256
//     rows or BN = 16 by 512 rows, so that no FMA falls on a zero-filled
//     column while every thread keeps its 8 x 8 micro-tile in registers and
//     reads its operands with 16-byte shared loads (16 FMAs per load).
//     Plain fmaf: no TF32, no tensor cores, so the result is exact f32.
//   * The block walks its range of r2 in steps of 16.  The w2 tile [BM, 16]
//     and the pot tile [16, BN] pass through three stages of shared memory
//     (dynamic: 43 KB, 68 KB at BN = 32, 126 KB at BN = 16) filled by
//     cp.async, so two tiles load while one is multiplied; one
//     __syncthreads() per step.  Operands whose rows are not 16-byte
//     aligned are staged with scalar loads.
//   * B = 4096 gives 8-32 row tiles for 132 SMs, so r2 is split across
//     blocks until every SM holds as many blocks as fit (two; one at
//     BN = 16, where neither a second block with r2 steps of 8 nor two
//     groups of 128 threads on alternate halves of each step measured
//     faster), and split_sum_kernel adds the [B, C] partials in a fixed
//     order: deterministic, no atomics.
//
// bfloat16: what bounds it, and the design.
//   The tensor cores do the product in microseconds; the bytes bound it, and
//   w2 is 91-96% of them.  So w2 is read from device memory exactly once and
//   nothing else of the bytes is repeated:
//   * A block of 288 threads owns BM = 128 rows and all N columns (BN = 64
//     or 128; wider N takes several column tiles): two consumer warpgroups
//     of 64 rows run wgmma.mma_async m64n64k16 (bf16 in, f32 accumulators in
//     registers), one producer warp keeps TMA loads in flight.
//   * Loads: cp.async.bulk.tensor of the w2 tile [BM, 64] (K-major) and of
//     the pot tile [64, BN] (MN-major, one 64-column box each, read with the
//     transpose bit) through a ring of 192 KB (6 stages at BN = 128, 8 at
//     64) with full and empty mbarriers, all with the 128-byte swizzle that
//     the wgmma shared-memory descriptors name.  TMA fills the ragged edges
//     of B, R2 and N with zeros.  Tensor maps are built on the host per call
//     (cuTensorMapEncodeTiled) and passed as __grid_constant__ parameters.
//   * Filling the card: B = 4096 gives 32 row tiles for 132 SMs, so r2 is
//     split over the blocks of one thread-block cluster, as many (up to 8)
//     as lets every tile's cluster be resident at once (the wrapper asks
//     cudaOccupancyMaxActiveClusters: 3 on an H100 at B = 4096).  Each
//     block writes its [BM, C] partial to its shared memory, and after a
//     cluster barrier each block adds a slice of rows over the cluster's
//     blocks in rank order through distributed shared memory: one launch,
//     no atomics, bitwise repeatable.  Only several column tiles of the "n"
//     tiling (N > 128) leave partials for split_sum_kernel.
//   * Each stage's products (64 r2, exact in f32) are summed by the tensor
//     cores and then added in f32 outside them: one tensor-core sum over a
//     block's whole r2 range (up to 1,365 terms here) strayed several times
//     further from the plain version.
//   * For C in {1, 2, 4, 8} (every serving shape) w1[b, r1(n)] is loaded
//     into registers before the loop and folded into each stage's products
//     at once, so the epilogue waits on no load; other C scale and add
//     through shared memory.  w1 stays f32.  bf16 subnormals (the floor
//     1e-38) are inputs the package's GPU tests hold against the plain
//     version.
//   * What holds it back: a block walks only 11-22 stages, so the ramp of
//     its ring weighs, and each w2 row arrives in 128-byte pieces; at C = 2
//     one library product is still faster.
//   * TMA needs 16-byte aligned addresses and row strides: the wrapper
//     copies other operands into an aligned, zero-padded buffer (counted).
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

// ===========================================================================
// float32: CUDA-core FMAs through a cp.async ring
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

// Blocks: blockIdx.x = (split * n_n + column tile) * n_b + row tile.
// BY_N: columns are n = (r1, c), pot is [R2, R1*C]; partial index
// split * n_n + column tile.  Otherwise columns are c, pot is [R1, R2, C],
// r1 is looped here; partial index split.  dst is [partials, B, C].
template <int BN, bool BY_N>
__global__ void __launch_bounds__(NT, 2)
factored_contract_kernel(const float* __restrict__ pot,
                         const float* __restrict__ w1,
                         const float* __restrict__ w2, float* __restrict__ dst,
                         int64_t B, int64_t R1, int64_t R2, int64_t C,
                         int n_b, int n_n, int64_t k_per_split, int vec_a,
                         int vec_b) {
  using S = Shape<BN>;
  using Fr = Frag<BN>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);

  const int tid = threadIdx.x;
  const int64_t bid = blockIdx.x;
  const int64_t b0 = (bid % n_b) * S::BM;
  const int64_t rest = bid / n_b;
  const int64_t n0 = (rest % n_n) * BN;
  const int64_t split = rest / n_n;
  const int64_t k_begin = split * k_per_split;
  const int64_t k_end = imin(R2, k_begin + k_per_split);
  const bool va = vec_a != 0, vb = vec_b != 0;

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  if constexpr (BY_N) {
    const int64_t N = R1 * C;
    const Loader<BN> loader(w2, pot, B, R2, N, N, b0, n0, k_end, va, vb);
    main_loop<BN>(acc, smem, loader, k_begin, k_end);
    float* sums = smem;  // the ring is drained
    // sums[row][col] = w1[b, r1(col)] * T[b, col].  The thread's rows and
    // the r1 of its columns are worked out once, and every w1 is loaded
    // from a clamped address without a branch, so the loads overlap.
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
      const int64_t n = n0 + Fr::col(s);
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
    const int width = (int)(imin(N, n0 + BN) - n0);
    for (int r = tid; r < S::BM; r += NT) {
      const int64_t b = b0 + r;
      if (b >= B) break;
      float* out_row = dst + (rest * B + b) * C;
      const float* sum_row = sums + r * (BN + 1);
      for (int c = 0; c < (int)C; ++c) {
        float s = 0.f;
        for (int j = (int)((c - n0 % C + C) % C); j < width; j += (int)C)
          s += sum_row[j];
        out_row[c] = s;
      }
    }
  } else {
    // the sums of each r1 are scaled by w1[b, r1] into a second tile
    float tot[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) tot[i] = 0.f;
    for (int64_t r1 = 0; r1 < R1; ++r1) {
      const Loader<BN> loader(w2, pot + r1 * R2 * C, B, R2, C, C, b0, n0,
                              k_end, va, vb);
      main_loop<BN>(acc, smem, loader, k_begin, k_end);
      float w[8];
#pragma unroll
      for (int s = 0; s < 8; ++s) {
        const int64_t b = b0 + Fr::row(s * 8);
        w[s] = b < B ? w1[b * R1 + r1] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        tot[i] = fmaf(w[i / 8], acc[i], tot[i]);
        acc[i] = 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int64_t b = b0 + Fr::row(i);
      const int64_t c = n0 + Fr::col(i);
      if (b < B && c < C) dst[(split * B + b) * C + c] = tot[i];
    }
  }
}

// out[i] = sum_z ws[z, i], z in order: the fixed-order sum of the partials.
__global__ void split_sum_kernel(const float* __restrict__ ws,
                                 float* __restrict__ out, int64_t n,
                                 int nparts) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int z = 0; z < nparts; ++z) s += ws[(int64_t)z * n + i];
  out[i] = s;
}

template <int BN, bool BY_N>
cudaError_t launch_f32(const float* pot, const float* w1, const float* w2,
                       float* dst, int64_t B, int64_t R1, int64_t R2,
                       int64_t C, int n_b, int n_n, int nsplit,
                       int64_t k_per_split, int vec_a, int vec_b,
                       cudaStream_t stream) {
  auto kern = factored_contract_kernel<BN, BY_N>;
  constexpr int bytes = Shape<BN>::BYTES;
  cudaError_t e = allow_smem<factored_contract_kernel<BN, BY_N>>(bytes);
  if (e != cudaSuccess) return e;
  const unsigned grid = (unsigned)((int64_t)n_b * n_n * nsplit);
  kern<<<grid, NT, bytes, stream>>>(pot, w1, w2, dst, B, R1, R2, C, n_b, n_n,
                                    k_per_split, vec_a, vec_b);
  return cudaGetLastError();
}

// ===========================================================================
// bfloat16: TMA loads and wgmma through an mbarrier ring
// ===========================================================================

namespace tc {

constexpr int NWG = 2;        // consumer warpgroups, 64 rows each
constexpr int BM = 64 * NWG;  // rows per block
constexpr int BK = 64;        // r2 per stage: one 128-byte swizzled bf16 row
constexpr int NCONS = 128 * NWG;  // consumer threads
constexpr int NT = NCONS + 32;  // and one producer warp
// One block an SM with a deep ring: two blocks of half the ring, 64-row
// blocks and 256-row blocks all measured no faster at the serving shapes.
constexpr int RING_BYTES = 192 * 1024;
constexpr int MAX_CLUSTER = 8;
constexpr int BOX = BK * 64 * 2;  // bytes of one [64 r2][64 n] pot box

// Shared memory of a block: the ring of NSTAGE stages (w2 tile, then the
// pot boxes), reused after the loop for the epilogue's [BM][BN + 1] tile of
// sums ("n" tiling) and the block's partial [BM][PW] behind it, then the
// full and empty mbarriers of the stages.
template <int BN, bool BY_N> struct Layout {
  static constexpr int A_BYTES = BM * BK * 2;  // w2 tile [BM rows][64 r2]
  static constexpr int B_BYTES = (BN / 64) * BOX;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int NSTAGE = RING_BYTES / STAGE;
  static constexpr int RING = NSTAGE * STAGE;
  static constexpr int PW = BY_N ? 32 : 64;  // C <= 32, or 64 columns of c
  static constexpr int SUMS = BY_N ? BM * (BN + 1) * 4 : 0;
  static constexpr int PART = SUMS;            // offset of the partial
  static constexpr int BARS = RING;            // offset of the mbarriers
  // + 1024: the ring starts at the first 1024-byte boundary (128-byte
  // swizzle atoms) of the dynamic shared memory
  static constexpr int BYTES = RING + 2 * NSTAGE * 8 + 1024;
  static_assert(SUMS + BM * PW * 4 <= RING, "the epilogue fits the ring");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
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

// d[64 x 64] = A[64 x 16] (K-major) * B[16 x 64] (MN-major: transposed),
// plus d itself if `accumulate`.
// Thread t of the warpgroup holds d[i] at row 16 (t / 32) + (t % 32) / 4 +
// 8 ((i / 2) % 2), column 8 (i / 4) + 2 (t % 4) + i % 2.
__device__ __forceinline__ void wgmma_64x64(float (&d)[32], uint64_t da,
                                            uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// How a block turns its products into its partial.
//   BY_C: the "c" tiling; each r1's sums are scaled by w1[b, r1] into `tot`.
//   FOLD: the "n" tiling with C in {1, 2, 4, 8}: every stage's products are
//     scaled by w1 (prefetched into registers before the loop) and added
//     into 2 x 2 sums a thread, one per row and column parity; the 4 lanes
//     of a quad that share c add theirs after the loop.
//   SMEM: the "n" tiling with other C: the stages are added into one f32
//     sum per column, scaled and added by columns through shared memory.
enum Epi { BY_C, FOLD, SMEM };

// Blocks: blockIdx.x = (column tile * n_b + row tile) * nsplit + split; the
// nsplit blocks of one tile form a cluster.  "n" tiling: columns n = (r1,
// c) of the pot map [R2, R1*C]; the block's [BM, C] sum goes to partial
// `column tile` of dst ([n_n, B, C]).  "c" tiling: columns c of the pot map
// [R1, R2, C], r1 looped here; the block's [BM, 64] sum goes to its columns
// of dst ([B, C]).  Block `split` of a cluster takes the r2 steps split,
// split + nsplit, ..., so that the cluster reads neighbouring pieces of the
// same w2 rows at once.
template <int BN, Epi EPI>
__global__ void __launch_bounds__(NT, 1)
factored_contract_bf16_kernel(const __grid_constant__ CUtensorMap map_w2,
                              const __grid_constant__ CUtensorMap map_pot,
                              const float* __restrict__ w1,
                              float* __restrict__ dst, int B, int R1, int R2,
                              int C, int n_b, int nsplit) {
  constexpr bool BY_N = EPI != BY_C;
  using L = Layout<BN, BY_N>;
  constexpr int NSTAGE = L::NSTAGE, PW = L::PW;
  static_assert(BY_N || BN == 64, "the c tiling takes 64 columns");
  constexpr int NB = BN / 64;  // pot boxes and wgmma per 16 r2
  extern __shared__ unsigned char smem_dyn[];
  const uint32_t pad = (1024 - (smem_u32(smem_dyn) & 1023)) & 1023;
  unsigned char* smem = smem_dyn + pad;
  const uint32_t ring = smem_u32(smem);
  float* part = reinterpret_cast<float*>(smem + L::PART);
  const uint32_t full = smem_u32(smem + L::BARS);
  const uint32_t empty = full + NSTAGE * 8;

  const int tid = threadIdx.x;
  const int split = blockIdx.x % nsplit;
  const int tile = blockIdx.x / nsplit;
  const int b0 = (tile % n_b) * BM;
  const int n0 = (tile / n_b) * BN;
  const int N = R1 * C;
  const int nk_all = (R2 + BK - 1) / BK;
  const int nk = split < nk_all ? (nk_all - split + nsplit - 1) / nsplit : 0;
  const int n_iter = nk * (BY_N ? 1 : R1);

  if (tid == 0) {
    for (int s = 0; s < NSTAGE; ++s) {
      mbar_init(full + 8 * s, 1);      // the producer's expect_tx
      mbar_init(empty + 8 * s, NCONS / 32);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Thread t of warpgroup g holds, per 64-column box j, acc[j][i] at row
  // 64 g + 16 (t / 32) + (t % 32) / 4 + 8 ((i / 2) % 2), column 64 j +
  // 8 (i / 4) + 2 (t % 4) + i % 2.  acc holds one stage's products (64 r2,
  // added by the tensor cores); the stages are added in f32 outside them,
  // so that no tensor-core sum runs longer than 64 terms.
  const int g = tid / 128, lane = tid % 32, warp = (tid % 128) / 32;
  const int row0 = 64 * g + 16 * warp + lane / 4;  // rows row0, row0 + 8
  float acc[NB][32];
  float sum[EPI == FOLD ? 1 : NB][32];  // BY_C, SMEM: the stages' sums
  float wv[EPI == FOLD ? NB : 1][32];   // FOLD: w1[b, r1(n)] of each
  float fold[2][2] = {};                // FOLD: per row and column parity
#pragma unroll
  for (int j = 0; j < (EPI == FOLD ? 1 : NB); ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) sum[j][i] = 0.f;
  if constexpr (EPI == FOLD) {
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int b = b0 + row0 + 8 * ((i / 2) % 2);
        const int n = n0 + 64 * j + 8 * (i / 4) + 2 * (lane % 4) + i % 2;
        wv[j][i] = tid < NCONS && b < B && n < N
                       ? __ldg(w1 + (int64_t)b * R1 + n / C) : 0.f;
      }
  }
  float tot[EPI == BY_C ? 32 : 1];
#pragma unroll
  for (int i = 0; i < (EPI == BY_C ? 32 : 1); ++i) tot[i] = 0.f;

  if (tid >= NCONS) {
    // producer: one thread keeps the ring full
    if (tid == NCONS) {
      for (int it = 0; it < n_iter; ++it) {
        const int s = it % NSTAGE;
        if (it >= NSTAGE) mbar_wait(empty + 8 * s, ((it / NSTAGE) - 1) & 1);
        mbar_expect_tx(full + 8 * s, L::STAGE);
        const int k0 = ((it % nk) * nsplit + split) * BK;
        const uint32_t st = ring + s * L::STAGE;
        tma_2d(st, &map_w2, k0, b0, full + 8 * s);
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          const uint32_t dst_b = st + L::A_BYTES + j * BOX;
          if constexpr (BY_N)
            tma_2d(dst_b, &map_pot, n0 + 64 * j, k0, full + 8 * s);
          else
            tma_3d(dst_b, &map_pot, n0 + 64 * j, k0, it / nk, full + 8 * s);
        }
      }
    }
  } else {
    // consumers: warpgroup g multiplies rows 64 g .. 64 g + 63
    for (int it = 0; it < n_iter; ++it) {
      const int s = it % NSTAGE;
      mbar_wait(full + 8 * s, (it / NSTAGE) & 1);
      const uint32_t a = ring + s * L::STAGE + g * 64 * 128;
      const uint32_t bt = ring + s * L::STAGE + L::A_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int j = 0; j < NB; ++j)
          // A: 128-byte rows, 8-row groups 1024 bytes apart, 16 r2 = 32
          // bytes along the row.  B: rows of 64 n, 128 bytes; 8-row groups
          // 1024 bytes apart, 16 r2 = 2048 bytes on.
          wgmma_64x64(acc[j], desc_sw128(a + kk * 32, 16, 1024),
                      desc_sw128(bt + j * BOX + kk * 2048, BOX, 1024),
                      kk > 0);
      wgmma_commit();
      wgmma_wait0();
      if (lane == 0) mbar_arrive(empty + 8 * s);
      if constexpr (EPI == FOLD) {
        // boxes, then columns, ascending
#pragma unroll
        for (int j = 0; j < NB; ++j)
#pragma unroll
          for (int i = 0; i < 32; ++i)
            fold[(i / 2) % 2][i % 2] =
                fmaf(wv[j][i], acc[j][i], fold[(i / 2) % 2][i % 2]);
      } else {
#pragma unroll
        for (int j = 0; j < NB; ++j)
#pragma unroll
          for (int i = 0; i < 32; ++i) sum[j][i] += acc[j][i];
      }
      if constexpr (EPI == BY_C) {
        if (it % nk == nk - 1) {  // the last step of r1 = it / nk
          const int r1 = it / nk, rb = b0 + row0;
          const float w_lo = rb < B ? w1[(int64_t)rb * R1 + r1] : 0.f;
          const float w_hi = rb + 8 < B ? w1[(int64_t)(rb + 8) * R1 + r1] : 0.f;
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            tot[i] = fmaf((i / 2) % 2 ? w_hi : w_lo, sum[0][i], tot[i]);
            sum[0][i] = 0.f;
          }
        }
      }
    }
  }
  __syncthreads();  // every load landed and was read: the ring is free

  if constexpr (EPI == FOLD) {
    // column n of quad lane t has c = (n0 + 2 t + n % 2) mod C; the lanes
    // that share c add their sums in a fixed butterfly, one lane writes
    if (tid < NCONS) {
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
    if (tid < NCONS) {
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int row = row0 + 8 * ((i / 2) % 2);
          const int col = 64 * j + 8 * (i / 4) + 2 * (lane % 4) + i % 2;
          const int b = b0 + row, n = n0 + col;
          sums[row * (BN + 1) + col] =
              b < B && n < N ? w1[(int64_t)b * R1 + n / C] * sum[j][i] : 0.f;
        }
    }
    __syncthreads();
    const int width = min(N, n0 + BN) - n0;
    for (int e = tid; e < BM * C; e += NT) {
      const int r = e / C, c = e % C;
      const float* sum_row = sums + r * (BN + 1);
      float s = 0.f;
#pragma unroll 8
      for (int j = (c - n0 % C + C) % C; j < width; j += C) s += sum_row[j];
      part[r * PW + c] = s;
    }
  } else {
    if (tid < NCONS) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int row = row0 + 8 * ((i / 2) % 2);
        const int col = 8 * (i / 4) + 2 * (lane % 4) + i % 2;
        part[row * PW + col] = tot[i];
      }
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
  for (int e = tid; e < (hi - lo) * W; e += NT) {
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
    if constexpr (BY_N)
      dst[((int64_t)(n0 / BN) * B + b) * C + col] = s;
    else
      dst[(int64_t)b * C + n0 + col] = s;
  }
  cluster.sync();  // no block leaves while another reads its partial
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

// A bf16 tensor map with the 128-byte swizzle: dims and box innermost
// first, strides in bytes of every dimension above the first.  Out-of-range
// elements read as zero.
CUresult make_map(CUtensorMap* map, const void* base, int rank,
                  const cuuint64_t* dims, const cuuint64_t* strides,
                  const cuuint32_t* box) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return CUDA_ERROR_NOT_SUPPORTED;
  const cuuint32_t ones[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, (cuuint32_t)rank,
            const_cast<void*>(base), dims, strides, box, ones,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int BN, Epi EPI>
cudaError_t launch(const CUtensorMap& mw2, const CUtensorMap& mpot,
                   const float* w1, float* dst, int B, int R1, int R2, int C,
                   int n_b, int n_n, int nsplit, cudaStream_t stream) {
  auto kern = factored_contract_bf16_kernel<BN, EPI>;
  constexpr int bytes = Layout<BN, EPI != BY_C>::BYTES;
  cudaError_t e = allow_smem<factored_contract_bf16_kernel<BN, EPI>>(bytes);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(n_b * n_n * nsplit));
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
  e = cudaLaunchKernelEx(&cfg, kern, mw2, mpot, w1, dst, B, R1, R2, C, n_b,
                         nsplit);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace tc

// Error codes above this are a CUresult of cuTensorMapEncodeTiled.
constexpr int MAP_ERROR = 100000;

}  // namespace

extern "C" {

// Launch the contraction on `stream`.  `by_n` picks the tiling and with it
// pot's layout ([R2, R1*C] rows if set, else [R1, R2, C]); bn, n_b, n_n,
// nsplit and k_per_split are the wrapper's launch_config.  With nparts > 1,
// `ws` is a [nparts, B, C] float32 scratch buffer that split_sum_kernel adds
// into `out`; with nparts == 1 it is unused and the kernel writes `out`.
// float32: vec_a / vec_b say that w2 / pot may be staged in 16-byte chunks.
// bfloat16: ld_pot / ld_w2 are the row strides (elements) of pot's rows of
// n or c and of w2, both multiples of 8 with 16-byte aligned bases; nsplit
// is the cluster size, and block `split` of a cluster takes the r2 steps of
// 64 numbered split, split + nsplit, ... (k_per_split is not read).  Returns the cudaError_t of the launches (0 on
// success), or MAP_ERROR + the CUresult of a tensor map that could not be
// made; it does not synchronise.
int jt_factored_contract(const void* pot, const void* w1, const void* w2,
                         void* out, void* ws, int is_bf16, int by_n,
                         int64_t B, int64_t R1, int64_t R2, int64_t C, int bn,
                         int n_b, int n_n, int nsplit, int64_t k_per_split,
                         int nparts, int vec_a, int vec_b, int64_t ld_pot,
                         int64_t ld_w2, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dst = static_cast<float*>(nparts > 1 ? ws : out);
  const float* a = static_cast<const float*>(w1);
  cudaError_t err = cudaErrorInvalidValue;
  if (is_bf16) {
    CUtensorMap mw2, mpot;
    const cuuint64_t w2_dims[2] = {(cuuint64_t)R2, (cuuint64_t)B};
    const cuuint64_t w2_strides[1] = {(cuuint64_t)ld_w2 * 2};
    const cuuint32_t w2_box[2] = {tc::BK, tc::BM};
    CUresult r = tc::make_map(&mw2, w2, 2, w2_dims, w2_strides, w2_box);
    if (r == CUDA_SUCCESS) {
      const cuuint32_t pot_box[3] = {64, tc::BK, 1};
      if (by_n) {
        const cuuint64_t dims[2] = {(cuuint64_t)(R1 * C), (cuuint64_t)R2};
        const cuuint64_t strides[1] = {(cuuint64_t)ld_pot * 2};
        r = tc::make_map(&mpot, pot, 2, dims, strides, pot_box);
      } else {
        const cuuint64_t dims[3] = {(cuuint64_t)C, (cuuint64_t)R2,
                                    (cuuint64_t)R1};
        const cuuint64_t strides[2] = {(cuuint64_t)ld_pot * 2,
                                       (cuuint64_t)(ld_pot * R2 * 2)};
        r = tc::make_map(&mpot, pot, 3, dims, strides, pot_box);
      }
    }
    if (r != CUDA_SUCCESS) return MAP_ERROR + (int)r;
    const int b = (int)B, r1 = (int)R1, r2 = (int)R2, c = (int)C;
    const bool fold = 8 % c == 0;  // C in {1, 2, 4, 8}
    if (!by_n && bn == 64)
      err = tc::launch<64, tc::BY_C>(mw2, mpot, a, dst, b, r1, r2, c, n_b,
                                     n_n, nsplit, s);
    else if (by_n && bn == 64)
      err = fold ? tc::launch<64, tc::FOLD>(mw2, mpot, a, dst, b, r1, r2, c,
                                            n_b, n_n, nsplit, s)
                 : tc::launch<64, tc::SMEM>(mw2, mpot, a, dst, b, r1, r2, c,
                                            n_b, n_n, nsplit, s);
    else if (by_n && bn == 128)
      err = fold ? tc::launch<128, tc::FOLD>(mw2, mpot, a, dst, b, r1, r2, c,
                                             n_b, n_n, nsplit, s)
                 : tc::launch<128, tc::SMEM>(mw2, mpot, a, dst, b, r1, r2, c,
                                             n_b, n_n, nsplit, s);
  } else {
    const float* p = static_cast<const float*>(pot);
    const float* w = static_cast<const float*>(w2);
    if (!by_n && bn == 64)
      err = launch_f32<64, false>(p, a, w, dst, B, R1, R2, C, n_b, n_n,
                                  nsplit, k_per_split, vec_a, vec_b, s);
    else if (by_n && bn == 64)
      err = launch_f32<64, true>(p, a, w, dst, B, R1, R2, C, n_b, n_n,
                                 nsplit, k_per_split, vec_a, vec_b, s);
    else if (by_n && bn == 32)
      err = launch_f32<32, true>(p, a, w, dst, B, R1, R2, C, n_b, n_n,
                                 nsplit, k_per_split, vec_a, vec_b, s);
    else if (by_n && bn == 16)
      err = launch_f32<16, true>(p, a, w, dst, B, R1, R2, C, n_b, n_n,
                                 nsplit, k_per_split, vec_a, vec_b, s);
  }
  if (err != cudaSuccess || nparts == 1) return (int)err;
  const int64_t n = B * C;
  const int threads = 256;
  split_sum_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0, s>>>(
      static_cast<const float*>(ws), static_cast<float*>(out), n, nparts);
  return (int)cudaGetLastError();
}

const char* jt_error_string(int err) {
  if (err >= MAP_ERROR) return "cuTensorMapEncodeTiled failed (CUresult in the code)";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Clusters of `cluster` blocks of the bf16 kernel (bn, by_n) that the card
// can hold at once (cudaOccupancyMaxActiveClusters), or -(cudaError_t).
int jt_bf16_max_clusters(int bn, int by_n, int cluster) {
  auto pick = [&](auto kern, int bytes) -> int {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return -(int)e;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)(cluster * 64));
    cfg.blockDim = dim3(tc::NT);
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
  if (!by_n) return pick(tc::factored_contract_bf16_kernel<64, tc::BY_C>,
                         tc::Layout<64, false>::BYTES);
  if (bn == 64) return pick(tc::factored_contract_bf16_kernel<64, tc::FOLD>,
                            tc::Layout<64, true>::BYTES);
  return pick(tc::factored_contract_bf16_kernel<128, tc::FOLD>,
              tc::Layout<128, true>::BYTES);
}

}  // extern "C"
