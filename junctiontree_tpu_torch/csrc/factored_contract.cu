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
// What bounds it.  The work is a matrix product
//   T[b, n] = sum_{r2} w2[b, r2] * P[r2, n],   n = (r1, c),
// with M = B, N = R1*C, K = R2, followed by out[b, c] = sum_{r1} w1[b, r1] *
// T[b, (r1, c)].  At the shapes of the 2^18-state clique (B = 4096, R1 = 64,
// R2 = 2048-4096, C <= 2) that is 2.15e9 operations over 36-69 MB: about 60
// operations per byte in f32, above the card's f32 ridge of 20 (67 TFLOP/s
// over 3.35 TB/s), so in f32 the FMA pipe bounds it.  With bf16 inputs the
// tensor cores do the product in microseconds and the bytes bound it.
// T [B, R1, C] never goes to device memory: the TPU kernel keeps it on chip,
// and the plain version spills it.
//
// Design.
//   * A block of 128 threads owns BM = 128 batch rows by BN = 64 columns and
//     walks its range of r2 in steps of BK (16 floats or 32 bf16).  The w2
//     tile [BM, BK] and the pot tile [BK, BN] pass through three stages of
//     shared memory filled by cp.async (16 bytes a thread), so two tiles
//     load while one is multiplied; one __syncthreads() per step.  Each
//     thread works out the addresses of its chunks once, before the loop.
//   * f32: every thread holds an 8 x 8 micro-tile in registers and reads
//     its operands with 16-byte shared loads (16 FMAs per load).  Plain
//     fmaf: no TF32, no tensor cores, so the result is exact f32.
//   * bf16: the product runs on the tensor cores, mma.sync m16n8k16 with an
//     f32 accumulator, fragments loaded with ldmatrix (transposed for pot,
//     whose tile is stored [k][n]).  mma.sync was taken over wgmma: at these
//     shapes bytes, not the tensor-core rate, bound the kernel, and
//     mma.sync's register fragments need no shared-memory descriptor or
//     swizzle that could only be debugged on the card.  Products of two bf16
//     values are exact in f32; w1 stays f32 and is applied in the epilogue.
//     bf16 subnormals (the floor 1e-38) are not flushed by mma.sync: the
//     package's GPU tests hold that against the plain version.  All of a
//     step's fragments are loaded before its first mma, so that no mma waits
//     on a load placed after the one before it.
//   * Two tilings of the columns, chosen by the wrapper from C:
//       "n" (C <= 32): the columns are n = (r1, c) of pot stored [R2, R1*C].
//         Each thread scales its sums by w1[b, r1(n)] (loads without a
//         branch, r1 worked out once per column) into shared memory, then
//         thread i adds row i's columns of equal c in ascending n: a fixed
//         order.  Each (column tile, r2 range) writes one [B, C] partial.
//       "c" (C > 32): the columns are c of pot stored [R1, R2, C], r1 is
//         looped in the block, and each thread adds w1[b, r1] * sums into a
//         second register tile.  Each r2 range writes one [B, C] partial.
//   * B = 4096 gives 32 row tiles for 132 SMs, so r2 is split across blocks
//     until two blocks are resident on every SM (the launch bounds keep the
//     registers under that), and split_sum_kernel adds the partials in a
//     fixed order: deterministic, no atomics.
//   * Rows, columns and r2 beyond the edge are filled with zeros, which add
//     nothing.  An operand whose rows are not 16-byte aligned (R2 or the
//     column count not a multiple of 4 floats / 8 bf16, or a view at an odd
//     offset) is staged with plain scalar loads instead of cp.async.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 (no fast math, no
// flush-to-zero: the serving floor 1e-38 is subnormal in f32).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;    // threads per block
constexpr int BM = 128;    // batch rows per block
constexpr int BN = 64;     // columns per block
constexpr int NSTAGE = 3;  // shared-memory stages

// Per input type: r2 elements per step and the padded row strides of the
// w2 tile [BM][LDA] and the pot tile [BK][LDB] (rows stay 16-byte aligned;
// the padding spreads rows over the banks).  A thread holds 64 accumulators.
template <typename T> struct Tile;
template <> struct Tile<float> {
  static constexpr int BK = 16, LDA = BK + 4, LDB = BN;
};
template <> struct Tile<__nv_bfloat16> {
  static constexpr int BK = 32, LDA = BK + 8, LDB = BN + 8;
};

// Elements of one stage, and the block's shared memory in bytes: the ring,
// reused by the epilogue for the [BM][BN + 1] tile of sums.
template <typename T> struct Smem {
  using Ti = Tile<T>;
  static constexpr int A_ELEMS = BM * Ti::LDA;
  static constexpr int STAGE_ELEMS = A_ELEMS + Ti::BK * Ti::LDB;
  static constexpr int PIPE_BYTES = NSTAGE * STAGE_ELEMS * (int)sizeof(T);
  static constexpr int SUMS_BYTES = BM * (BN + 1) * (int)sizeof(float);
  static constexpr int BYTES =
      PIPE_BYTES > SUMS_BYTES ? PIPE_BYTES : SUMS_BYTES;
};

__device__ __forceinline__ int64_t imin(int64_t a, int64_t b) {
  return a < b ? a : b;
}
__device__ __forceinline__ float zero_of(float) { return 0.f; }
__device__ __forceinline__ __nv_bfloat16 zero_of(__nv_bfloat16) {
  return __float2bfloat16(0.f);
}

// 16-byte asynchronous copy to shared memory; bytes past src_bytes are
// filled with zeros (src_bytes = 0 reads nothing).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
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
template <typename T>
struct Loader {
  using Ti = Tile<T>;
  static constexpr int E = 16 / (int)sizeof(T);  // elements per chunk
  static constexpr int CPR_A = Ti::BK / E, CPR_B = BN / E;  // chunks per row
  static constexpr int PA = BM * CPR_A / NT, PB = Ti::BK * CPR_B / NT;

  const T* w2;
  const T* bmat;
  int64_t B, R2, ld, ncols, b0, n0, k_end;
  bool vec_a, vec_b;
  const T* a_src[PA];  // w2 + b * R2 + the chunk's k offset; null if b >= B
  const T* b_src[PB];  // bmat + row * ld + n; null if n >= ncols

  __device__ __forceinline__ Loader(const T* w2_, const T* bmat_, int64_t B_,
                                    int64_t R2_, int64_t ld_, int64_t ncols_,
                                    int64_t b0_, int64_t n0_, int64_t k_end_,
                                    bool vec_a_, bool vec_b_)
      : w2(w2_), bmat(bmat_), B(B_), R2(R2_), ld(ld_), ncols(ncols_), b0(b0_),
        n0(n0_), k_end(k_end_), vec_a(vec_a_), vec_b(vec_b_) {
    const int tid = threadIdx.x;
#pragma unroll
    for (int p = 0; p < PA; ++p) {
      const int id = tid + p * NT;
      const int64_t b = b0 + id / CPR_A;
      a_src[p] = b < B ? w2 + b * R2 + (id % CPR_A) * E : nullptr;
    }
#pragma unroll
    for (int p = 0; p < PB; ++p) {
      const int id = tid + p * NT;
      const int64_t n = n0 + (id % CPR_B) * E;
      b_src[p] = n < ncols ? bmat + (id / CPR_B) * ld + n : nullptr;
    }
  }

  // Stage the tiles of r2 = k0.. into As, Bs.
  __device__ __forceinline__ void load(T* __restrict__ As, T* __restrict__ Bs,
                                       int64_t k0) const {
    const int tid = threadIdx.x;
    if (vec_a) {
#pragma unroll
      for (int p = 0; p < PA; ++p) {
        const int id = tid + p * NT;
        const int row = id / CPR_A, ch = id % CPR_A;
        // a chunk is whole or outside: k_end is R2 or a multiple of BK
        const bool ok = a_src[p] != nullptr && k0 + ch * E < k_end;
        cp_async16(As + row * Ti::LDA + ch * E, ok ? a_src[p] + k0 : w2,
                   ok ? 16 : 0);
      }
    } else {
      for (int e = tid; e < BM * Ti::BK; e += NT) {
        const int row = e / Ti::BK, col = e % Ti::BK;
        const int64_t b = b0 + row, k = k0 + col;
        As[row * Ti::LDA + col] =
            (b < B && k < k_end) ? w2[b * R2 + k] : zero_of(T());
      }
    }
    if (vec_b) {
      const int64_t k_off = k0 * ld;
#pragma unroll
      for (int p = 0; p < PB; ++p) {
        const int id = tid + p * NT;
        const int row = id / CPR_B, ch = id % CPR_B;
        const bool ok = b_src[p] != nullptr && k0 + row < k_end;
        cp_async16(Bs + row * Ti::LDB + ch * E, ok ? b_src[p] + k_off : bmat,
                   ok ? 16 : 0);
      }
    } else {
      for (int e = tid; e < Ti::BK * BN; e += NT) {
        const int row = e / BN, col = e % BN;
        const int64_t k = k0 + row, n = n0 + col;
        Bs[row * Ti::LDB + col] =
            (k < k_end && n < ncols) ? bmat[k * ld + n] : zero_of(T());
      }
    }
  }
};

// Where accumulator idx lies in the block's tile, per input type.  A
// thread's 64 values share NROW rows and NCOL columns: row_slot / col_slot
// number them, and row_rep / col_rep give one idx of each slot.
template <typename T> struct Frag;

// ---- f32: 8 x 8 register micro-tile on the CUDA cores ----------------------
// Thread (ty, tx) = (tid / 8, tid % 8) holds rows ty + 16 i (i < 8) and
// columns 32 j + 4 tx + e (j < 2, e < 4): acc[i * 8 + 4 j + e].  Each
// operand comes from shared memory in 16-byte loads: four r2 of one row of
// w2, four columns of one r2 of pot (16 FMAs per load).

template <> struct Frag<float> {
  static constexpr int NROW = 8, NCOL = 8;
  static __device__ constexpr int row_slot(int idx) { return idx / 8; }
  static __device__ constexpr int col_slot(int idx) { return idx % 8; }
  static __device__ constexpr int row_rep(int s) { return s * 8; }
  static __device__ constexpr int col_rep(int s) { return s; }
  static __device__ __forceinline__ int row(int idx) {
    return threadIdx.x / 8 + 16 * (idx / 8);
  }
  static __device__ __forceinline__ int col(int idx) {
    return 32 * ((idx % 8) / 4) + 4 * (threadIdx.x % 8) + idx % 4;
  }
};

__device__ __forceinline__ void compute_stage(float (&acc)[64],
                                              const float* __restrict__ As,
                                              const float* __restrict__ Bs) {
  using Ti = Tile<float>;
  const int tx = threadIdx.x % 8, ty = threadIdx.x / 8;
#pragma unroll
  for (int kk = 0; kk < Ti::BK; kk += 4) {
    float4 a[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      a[i] =
          *reinterpret_cast<const float4*>(As + (ty + 16 * i) * Ti::LDA + kk);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float* brow = Bs + (kk + q) * Ti::LDB + 4 * tx;
      const float4 b0 = *reinterpret_cast<const float4*>(brow);
      const float4 b1 = *reinterpret_cast<const float4*>(brow + 32);
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

// ---- bf16: mma.sync m16n8k16 on the tensor cores ---------------------------
// Warp w holds rows 32 w .. 32 w + 31 and all 64 columns as 2 x 8 tiles of
// 16 x 8; acc[(mi * 8 + ni) * 4 + e] is element e of tile (mi, ni): row
// 16 mi + lane / 4 + 8 (e / 2), column 8 ni + 2 (lane % 4) + e % 2.

template <> struct Frag<__nv_bfloat16> {
  static constexpr int NROW = 4, NCOL = 16;
  static __device__ constexpr int row_slot(int idx) {
    return (idx / 32) * 2 + (idx % 4) / 2;
  }
  static __device__ constexpr int col_slot(int idx) {
    return ((idx / 4) % 8) * 2 + idx % 2;
  }
  static __device__ constexpr int row_rep(int s) {
    return (s / 2) * 32 + (s % 2) * 2;
  }
  static __device__ constexpr int col_rep(int s) {
    return (s / 2) * 4 + s % 2;
  }
  static __device__ __forceinline__ int row(int idx) {
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    return warp * 32 + (idx / 32) * 16 + lane / 4 + ((idx % 4) / 2) * 8;
  }
  static __device__ __forceinline__ int col(int idx) {
    return ((idx / 4) % 8) * 8 + 2 * (threadIdx.x % 4) + idx % 2;
  }
};

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void compute_stage(
    float (&acc)[64], const __nv_bfloat16* __restrict__ As,
    const __nv_bfloat16* __restrict__ Bs) {
  using Ti = Tile<__nv_bfloat16>;
  const int lane = threadIdx.x % 32, m0 = (threadIdx.x / 32) * 32;
  // ldmatrix: lane gives the address of row (lane % 8) of matrix (lane / 8)
  const int mat = lane / 8, r = lane % 8;
  // Every fragment of the step is loaded before the first mma: the asm
  // statements keep their order, so a load placed between two mma would
  // wait for the first and stall the second.
  constexpr int KS = Ti::BK / 16;
  uint32_t a[KS][2][4], b[KS][4][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
      // matrices: (rows 0-7, k 0-7), (rows 8-15, k 0-7), (rows 0-7, k 8-15),
      // (rows 8-15, k 8-15) = a0..a3 of the 16 x 16 A fragment
      ldmatrix_x4(a[ks][mi], As + (m0 + mi * 16 + r + (mat & 1) * 8) * Ti::LDA +
                                 ks * 16 + (mat >> 1) * 8);
#pragma unroll
    for (int np = 0; np < 4; ++np)
      // matrices, stored [k][n] and transposed on load: (k 0-7, n 0-7),
      // (k 8-15, n 0-7) = b0, b1 of column tile 2 np; (k 0-7, n 8-15),
      // (k 8-15, n 8-15) = b0, b1 of column tile 2 np + 1
      ldmatrix_x4_trans(b[ks][np],
                        Bs + (ks * 16 + r + (mat & 1) * 8) * Ti::LDB +
                            np * 16 + (mat >> 1) * 8);
  }
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
#pragma unroll
    for (int np = 0; np < 4; ++np)
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        mma_bf16(acc + (mi * 8 + 2 * np) * 4, a[ks][mi], b[ks][np][0],
                 b[ks][np][1]);
        mma_bf16(acc + (mi * 8 + 2 * np + 1) * 4, a[ks][mi], b[ks][np][2],
                 b[ks][np][3]);
      }
}

// acc += w2[b0.., k_begin..k_end) x bmat[k_begin..k_end), n0..] through the
// cp.async ring.  Leaves no copy in flight and every thread past a barrier.
template <typename T>
__device__ __forceinline__ void main_loop(float (&acc)[64],
                                          T* __restrict__ smem,
                                          const Loader<T>& loader,
                                          int64_t k_begin, int64_t k_end) {
  constexpr int BK = Tile<T>::BK;
  constexpr int A_ELEMS = Smem<T>::A_ELEMS;
  constexpr int STAGE_ELEMS = Smem<T>::STAGE_ELEMS;
  const int nk = (int)((k_end - k_begin + BK - 1) / BK);
#pragma unroll
  for (int s = 0; s < NSTAGE - 1; ++s) {
    if (s < nk) {
      T* st = smem + s * STAGE_ELEMS;
      loader.load(st, st + A_ELEMS, k_begin + (int64_t)s * BK);
    }
    cp_async_commit();
  }
  for (int it = 0; it < nk; ++it) {
    cp_async_wait<NSTAGE - 2>();  // tile `it` has landed
    __syncthreads();              // ... for every thread; tile it-1 is read
    const int nx = it + NSTAGE - 1;
    if (nx < nk) {
      T* st = smem + (nx % NSTAGE) * STAGE_ELEMS;
      loader.load(st, st + A_ELEMS, k_begin + (int64_t)nx * BK);
    }
    cp_async_commit();
    const T* st = smem + (it % NSTAGE) * STAGE_ELEMS;
    compute_stage(acc, st, st + A_ELEMS);
  }
  cp_async_wait<0>();
  __syncthreads();
}

// Blocks: blockIdx.x = (split * n_n + column tile) * n_b + row tile.
// BY_N: columns are n = (r1, c), pot is [R2, R1*C]; partial index
// split * n_n + column tile.  Otherwise columns are c, pot is [R1, R2, C],
// r1 is looped here; partial index split.  dst is [partials, B, C].
template <typename T, bool BY_N>
__global__ void __launch_bounds__(NT, 2)
factored_contract_kernel(const T* __restrict__ pot,
                         const float* __restrict__ w1,
                         const T* __restrict__ w2, float* __restrict__ dst,
                         int64_t B, int64_t R1, int64_t R2, int64_t C,
                         int n_b, int n_n, int64_t k_per_split, int vec_a,
                         int vec_b) {
  using Fr = Frag<T>;
  __shared__ __align__(128) unsigned char smem_raw[Smem<T>::BYTES];
  T* smem = reinterpret_cast<T*>(smem_raw);

  const int tid = threadIdx.x;
  const int64_t bid = blockIdx.x;
  const int64_t b0 = (bid % n_b) * BM;
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
    const Loader<T> loader(w2, pot, B, R2, N, N, b0, n0, k_end, va, vb);
    main_loop<T>(acc, smem, loader, k_begin, k_end);
    float* sums = reinterpret_cast<float*>(smem_raw);  // the ring is drained
    // sums[row][col] = w1[b, r1(col)] * T[b, col].  The thread's rows and
    // the r1 of its columns are worked out once, and every w1 is loaded
    // from a clamped address without a branch, so the loads overlap.
    const float* w1_row[Fr::NROW];
    bool row_ok[Fr::NROW];
#pragma unroll
    for (int s = 0; s < Fr::NROW; ++s) {
      const int64_t b = b0 + Fr::row(Fr::row_rep(s));
      row_ok[s] = b < B;
      w1_row[s] = w1 + imin(b, B - 1) * R1;
    }
    uint32_t r1_of[Fr::NCOL];
    bool col_ok[Fr::NCOL];
#pragma unroll
    for (int s = 0; s < Fr::NCOL; ++s) {
      const int64_t n = n0 + Fr::col(Fr::col_rep(s));
      col_ok[s] = n < N;
      r1_of[s] = (uint32_t)imin(n, N - 1) / (uint32_t)C;
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int rs = Fr::row_slot(i), cs = Fr::col_slot(i);
      const float w = w1_row[rs][r1_of[cs]];
      sums[Fr::row(i) * (BN + 1) + Fr::col(i)] =
          row_ok[rs] && col_ok[cs] ? w * acc[i] : 0.f;
    }
    __syncthreads();
    // thread i, row i: out[b, c] = the row's columns n = c (mod C), ascending
    static_assert(NT == BM, "one thread a row");
    const int width = (int)(imin(N, n0 + BN) - n0);
    const int64_t b = b0 + tid;
    if (b < B) {
      float* out_row = dst + (rest * B + b) * C;
      const float* sum_row = sums + tid * (BN + 1);
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
      const Loader<T> loader(w2, pot + r1 * R2 * C, B, R2, C, C, b0, n0, k_end,
                             va, vb);
      main_loop<T>(acc, smem, loader, k_begin, k_end);
      float w[Fr::NROW];
#pragma unroll
      for (int s = 0; s < Fr::NROW; ++s) {
        const int64_t b = b0 + Fr::row(Fr::row_rep(s));
        w[s] = b < B ? w1[b * R1 + r1] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        tot[i] = fmaf(w[Fr::row_slot(i)], acc[i], tot[i]);
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

template <typename T>
cudaError_t launch(int by_n, const void* pot, const void* w1, const void* w2,
                   float* dst, int64_t B, int64_t R1, int64_t R2, int64_t C,
                   int n_b, int n_n, int nsplit, int64_t k_per_split,
                   int vec_a, int vec_b, cudaStream_t stream) {
  const unsigned grid = (unsigned)((int64_t)n_b * n_n * nsplit);
  const T* p = static_cast<const T*>(pot);
  const float* a = static_cast<const float*>(w1);
  const T* w = static_cast<const T*>(w2);
  if (by_n)
    factored_contract_kernel<T, true><<<grid, NT, 0, stream>>>(
        p, a, w, dst, B, R1, R2, C, n_b, n_n, k_per_split, vec_a, vec_b);
  else
    factored_contract_kernel<T, false><<<grid, NT, 0, stream>>>(
        p, a, w, dst, B, R1, R2, C, n_b, n_n, k_per_split, vec_a, vec_b);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch the contraction on `stream`.  `by_n` picks the tiling and with it
// pot's layout ([R2, R1*C] if set, else [R1, R2, C]); n_b, n_n, nsplit and
// k_per_split are the wrapper's launch_config.  With nparts > 1, `ws` is a [nparts, B, C] float32
// scratch buffer that split_sum_kernel adds into `out`; with nparts == 1 it
// is unused and the kernel writes `out`.  vec_a / vec_b say that w2 / pot
// may be staged in 16-byte chunks.  Returns the cudaError_t of the launches
// (0 on success); it does not synchronise.
int jt_factored_contract(const void* pot, const void* w1, const void* w2,
                         void* out, void* ws, int is_bf16, int by_n,
                         int64_t B, int64_t R1, int64_t R2, int64_t C,
                         int n_b, int n_n, int nsplit, int64_t k_per_split,
                         int nparts, int vec_a, int vec_b, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dst = static_cast<float*>(nparts > 1 ? ws : out);
  cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(by_n, pot, w1, w2, dst, B, R1, R2, C,
                                      n_b, n_n, nsplit, k_per_split, vec_a,
                                      vec_b, s)
              : launch<float>(by_n, pot, w1, w2, dst, B, R1, R2, C, n_b, n_n,
                              nsplit, k_per_split, vec_a, vec_b, s);
  if (err != cudaSuccess || nparts == 1) return (int)err;
  const int64_t n = B * C;
  const int threads = 256;
  split_sum_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0, s>>>(
      static_cast<const float*>(ws), static_cast<float*>(out), n, nparts);
  return (int)cudaGetLastError();
}

const char* jt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
