// Factored big-clique contraction on Hopper (sm_90a).
//
//   out[b, c] = sum_{r1, r2} pot[r1, r2, c] * w1[b, r1] * w2[b, r2]
//
// Replaces the Pallas TPU kernel factored_masked_contract
// (junctiontree_tpu/ops/pallas_contract.py:181-307).  pot is the clique
// potential [R1, R2, C] (row-major), w1 [B, R1] and w2 [B, R2] are the two
// batched evidence weight groups, out [B, C] is float32.  pot and w2 are
// float or bfloat16, w1 is float; every product and sum is an f32 FMA
// (no TF32, no tensor cores).
//
// What bounds it.  On the serving path C is tiny (1 for the partition
// function, 2 for a binary marginal), so this is B independent weighted sums
// over the R1*R2*C potential: 2*B*R1*R2*C flops over S + B*(R1+R2+C) floats
// of input.  At the shapes of the 2^18-state clique (B=4096, R1=64,
// R2=2048-4096, C<=2) that is about 60 flops per byte read, above the
// card's f32 ridge of about 20 (67 TFLOP/s over 3.35 TB/s), so f32 FMA
// issue and shared-memory bandwidth bound it, not device memory.
//
// Design (simple and correct first; wgmma and TMA are later work):
//   * one thread per batch row b and TC output columns, 128 rows per block;
//     blocks tile (c, b) and, when those alone cannot fill the card, split
//     r2 into ranges whose partial sums split_sum_kernel adds in a fixed
//     order (deterministic, no atomics);
//   * per r2 tile of KT elements the block stages w2[128 rows, KT] through
//     shared memory with coalesced loads and each thread keeps its row's KT
//     weights in registers;
//   * then for each r1 the block stages pot[r1, KT, TC] (R1T rows of r1 per
//     pass) in shared memory, every thread reads it by broadcast, forms
//     partial[c] = sum_k w2[b, k] * pot[r1, k, c] in registers and adds
//     w1[b, r1] * partial[c] to its f32 accumulator.  The r2 tile loop is
//     outside the r1 loop, so w2 is read from device memory once per block.
// Ragged B, R1, R2 and C are masked with zeros, which add nothing.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 (no fast math, no
// flush-to-zero: the serving floor 1e-38 is subnormal in f32).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TB = 128;  // threads per block = batch rows per block
constexpr int KT = 32;   // r2 elements per shared-memory tile
constexpr int R1T = 8;   // r1 rows of pot staged per pass

__device__ __forceinline__ int64_t imin(int64_t a, int64_t b) {
  return a < b ? a : b;
}
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T, int TC>
__global__ void __launch_bounds__(TB)
factored_contract_kernel(const T* __restrict__ pot,
                         const float* __restrict__ w1,
                         const T* __restrict__ w2, float* __restrict__ out,
                         int64_t B, int64_t R1, int64_t R2, int64_t C,
                         int64_t k_per_split) {
  __shared__ float w2_s[TB][KT + 1];  // +1: conflict-free row reads
  __shared__ float pot_s[R1T][KT][TC];

  const int tid = threadIdx.x;
  const int64_t c0 = (int64_t)blockIdx.x * TC;
  const int64_t b0 = (int64_t)blockIdx.y * TB;
  const int64_t b = b0 + tid;
  const int64_t k_begin = (int64_t)blockIdx.z * k_per_split;
  const int64_t k_end = imin(R2, k_begin + k_per_split);

  float acc[TC];
#pragma unroll
  for (int c = 0; c < TC; ++c) acc[c] = 0.f;

  for (int64_t k0 = k_begin; k0 < k_end; k0 += KT) {
    __syncthreads();  // the previous tile's readers are done
    for (int e = tid; e < TB * KT; e += TB) {
      const int row = e / KT, col = e % KT;
      const int64_t bb = b0 + row, kk = k0 + col;
      w2_s[row][col] = (bb < B && kk < k_end) ? to_f32(w2[bb * R2 + kk]) : 0.f;
    }
    __syncthreads();
    float w2r[KT];
#pragma unroll
    for (int j = 0; j < KT; ++j) w2r[j] = w2_s[tid][j];

    for (int64_t r0 = 0; r0 < R1; r0 += R1T) {
      __syncthreads();  // pot_s readers of the previous pass are done
      for (int e = tid; e < R1T * KT * TC; e += TB) {
        const int i = e / (KT * TC);
        const int j = (e / TC) % KT;
        const int c = e % TC;
        const int64_t r1 = r0 + i, kk = k0 + j, cc = c0 + c;
        pot_s[i][j][c] = (r1 < R1 && kk < k_end && cc < C)
                             ? to_f32(pot[(r1 * R2 + kk) * C + cc])
                             : 0.f;
      }
      __syncthreads();
      const int n_r1 = (int)imin(R1T, R1 - r0);
      for (int i = 0; i < n_r1; ++i) {
        float part[TC];
#pragma unroll
        for (int c = 0; c < TC; ++c) part[c] = 0.f;
#pragma unroll
        for (int j = 0; j < KT; ++j) {
#pragma unroll
          for (int c = 0; c < TC; ++c)
            part[c] = fmaf(w2r[j], pot_s[i][j][c], part[c]);
        }
        const float a = (b < B) ? w1[b * R1 + r0 + i] : 0.f;
#pragma unroll
        for (int c = 0; c < TC; ++c) acc[c] = fmaf(a, part[c], acc[c]);
      }
    }
  }
  if (b < B) {
    float* dst = out + ((int64_t)blockIdx.z * B + b) * C;
#pragma unroll
    for (int c = 0; c < TC; ++c)
      if (c0 + c < C) dst[c0 + c] = acc[c];
  }
}

// out[i] = sum_z ws[z, i], z in order: the r2 split's fixed-order reduction.
__global__ void split_sum_kernel(const float* __restrict__ ws,
                                 float* __restrict__ out, int64_t n,
                                 int nsplit) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int z = 0; z < nsplit; ++z) s += ws[(int64_t)z * n + i];
  out[i] = s;
}

template <typename T, int TC>
void launch(const void* pot, const void* w1, const void* w2, float* dst,
            int64_t B, int64_t R1, int64_t R2, int64_t C, int nsplit,
            int64_t k_per_split, cudaStream_t stream) {
  const dim3 grid((unsigned)((C + TC - 1) / TC), (unsigned)((B + TB - 1) / TB),
                  (unsigned)nsplit);
  factored_contract_kernel<T, TC><<<grid, TB, 0, stream>>>(
      static_cast<const T*>(pot), static_cast<const float*>(w1),
      static_cast<const T*>(w2), dst, B, R1, R2, C, k_per_split);
}

template <typename T>
void launch_tc(int tc, const void* pot, const void* w1, const void* w2,
               float* dst, int64_t B, int64_t R1, int64_t R2, int64_t C,
               int nsplit, int64_t k_per_split, cudaStream_t stream) {
  switch (tc) {
    case 1: launch<T, 1>(pot, w1, w2, dst, B, R1, R2, C, nsplit, k_per_split, stream); break;
    case 2: launch<T, 2>(pot, w1, w2, dst, B, R1, R2, C, nsplit, k_per_split, stream); break;
    case 4: launch<T, 4>(pot, w1, w2, dst, B, R1, R2, C, nsplit, k_per_split, stream); break;
    default: launch<T, 8>(pot, w1, w2, dst, B, R1, R2, C, nsplit, k_per_split, stream); break;
  }
}

}  // namespace

extern "C" {

// Launch the contraction on `stream`.  With nsplit > 1, `ws` is a
// [nsplit, B, C] float32 scratch buffer; with nsplit == 1 it is unused and
// the kernel writes `out` directly.  Returns the cudaError_t of the launches
// (0 on success); it does not synchronise.
int jt_factored_contract(const void* pot, const void* w1, const void* w2,
                         void* out, void* ws, int is_bf16, int64_t B,
                         int64_t R1, int64_t R2, int64_t C, int tc,
                         int nsplit, int64_t k_per_split, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dst = static_cast<float*>(nsplit > 1 ? ws : out);
  if (is_bf16)
    launch_tc<__nv_bfloat16>(tc, pot, w1, w2, dst, B, R1, R2, C, nsplit,
                             k_per_split, s);
  else
    launch_tc<float>(tc, pot, w1, w2, dst, B, R1, R2, C, nsplit, k_per_split,
                     s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return (int)err;
  const int64_t n = B * C;
  const int threads = 256;
  split_sum_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0, s>>>(
      static_cast<const float*>(ws), static_cast<float*>(out), n, nsplit);
  return (int)cudaGetLastError();
}

const char* jt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
