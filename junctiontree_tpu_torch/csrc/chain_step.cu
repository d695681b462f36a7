// The row pass of the chain program's rescaled step on Hopper (sm_90a): the
// elementwise work around the step's product, in one launch.
//
// The product y = x @ A_k ([B, K] x [K, K], FP32, TF32 off) is the
// library's.  Then, in place over y, for every batch row b:
//
//   s[b]   = max(max_q y[b, q], 1e-38)
//   g      = y / s
//
// Forward step k (y = (F_k ⊙ M_k) @ A_k; m = M_{k+1}, null at the last step):
//
//   y      = g ⊙ m                   F_{k+1} ⊙ M_{k+1}: the next product's
//                                    operand, and what the posterior reads
//   scale  = s
//
// Backward step k (y = (M_{k+1} ⊙ G_{k+1}) @ A_kᵀ; post = F_k ⊙ M_k;
// m = M_k, null at the first position):
//
//   p      = post ⊙ g
//   post   = p / max(rowsum(p), 1e-38)      the position's posterior
//   y      = m ⊙ g                          the next product's operand
//
// The arithmetic is the plain step's (scan_executor._rescaled_step, its mask
// multiply and the posterior pass): the same products and IEEE divisions;
// only the order of a row's sum differs.
//
// Replaces no TPU kernel: the JAX package leaves the step to XLA's dot and
// elementwise ops.  The port's plain step takes five launches (multiply,
// product, max, clamp, divide) and writes and reads three [B, K] float32
// intermediates around the product, and its posterior pass makes four more
// passes over the [m+1, B, K] stacks.  Here a forward step reads y and m
// and writes y (3 BK floats), a backward step reads y, post and m and
// writes post and y (5 BK floats): at B = 16,384 and K = 500, 98 and 164 MB,
// 0.029 and 0.049 ms at 3.35 TB/s.  Measured (NVIDIA H100 80GB HBM3, 700
// W), the library's product and this pass: 0.216 ms forward and 0.233 ms
// backward, against 0.263 and 0.377 ms for the plain steps and 0.227 and
// 0.296 ms for a hand-written FP32 GEMM with the same work fused into its
// prologue and epilogue (its product loop ran at 54% of the FP32 rate,
// cuBLAS's at 68%).
//
// Design: one warp a row (8 rows a block); a lane holds the columns
// VEC (lane + 32 t), t < NC / 32 / VEC, in registers (NC = 256, 512 or 1024,
// at least K; VEC = 4 where every row is 16-byte aligned), so the row's
// maximum and sum are warp shuffles and y is read once.  No fast math:
// 1e-38 is subnormal in float32, and a flush to zero would turn an
// impossible row's 0 / 1e-38 into 0 / 0.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float CS_TINY = 1e-38f;
constexpr int ROWS_WARPS = 8;  // rows a block

struct RowsArgs {
  float* y;        // the product [B, K], overwritten
  const float* m;  // [B, K] or null
  float* scale;    // forward: the rows' floored maxima [B], or null
  float* post;     // backward: F_k ⊙ M_k in, the posterior out; forward null
  int B, K;
};

template <int VEC>
__device__ __forceinline__ void load(float* r, const float* p) {
  if constexpr (VEC == 4)
    *reinterpret_cast<float4*>(r) = *reinterpret_cast<const float4*>(p);
  else
    r[0] = p[0];
}

template <int VEC>
__device__ __forceinline__ void store(float* p, const float* r) {
  if constexpr (VEC == 4)
    *reinterpret_cast<float4*>(p) = *reinterpret_cast<const float4*>(r);
  else
    p[0] = r[0];
}

template <int NC, int VEC>
__global__ void __launch_bounds__(32 * ROWS_WARPS)
    chain_rows_kernel(const __grid_constant__ RowsArgs a) {
  constexpr int PER = NC / 32 / VEC;  // a lane's groups of VEC columns
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * ROWS_WARPS + (threadIdx.x >> 5);
  if (b >= a.B) return;
  const int K = a.K;
  const int64_t o = static_cast<int64_t>(b) * K;
  float* const y = a.y + o;
  float g[PER][VEC];
  float mx = __int_as_float(0xff800000);
#pragma unroll
  for (int t = 0; t < PER; ++t) {
    const int c = VEC * (lane + 32 * t);
    if (c < K) {
      load<VEC>(g[t], y + c);
#pragma unroll
      for (int v = 0; v < VEC; ++v) mx = fmaxf(mx, g[t][v]);
    }
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(full, mx, d));
  const float s = fmaxf(mx, CS_TINY);

  if (!a.post) {  // forward: y = g ⊙ m, scale = s
#pragma unroll
    for (int t = 0; t < PER; ++t) {
      const int c = VEC * (lane + 32 * t);
      if (c < K) {
        float mv[VEC];
        if (a.m) load<VEC>(mv, a.m + o + c);
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          g[t][v] = g[t][v] / s;
          if (a.m) g[t][v] = g[t][v] * mv[v];
        }
        store<VEC>(y + c, g[t]);
      }
    }
    if (a.scale && lane == 0) a.scale[b] = s;
    return;
  }

  // backward: p = post ⊙ g kept in g, y = m ⊙ g, then post = p / sum
  float* const post = a.post + o;
  float sum = 0.0f;
#pragma unroll
  for (int t = 0; t < PER; ++t) {
    const int c = VEC * (lane + 32 * t);
    if (c < K) {
      float w[VEC], mv[VEC];
      load<VEC>(w, post + c);
      if (a.m) load<VEC>(mv, a.m + o + c);
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        const float gv = g[t][v] / s;
        g[t][v] = w[v] * gv;
        sum += g[t][v];
        if (a.m) mv[v] = mv[v] * gv;
      }
      if (a.m) store<VEC>(y + c, mv);
    }
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) sum += __shfl_xor_sync(full, sum, d);
  const float tot = fmaxf(sum, CS_TINY);
#pragma unroll
  for (int t = 0; t < PER; ++t) {
    const int c = VEC * (lane + 32 * t);
    if (c < K) {
#pragma unroll
      for (int v = 0; v < VEC; ++v) g[t][v] = g[t][v] / tot;
      store<VEC>(post + c, g[t]);
    }
  }
}

template <int NC, int VEC>
cudaError_t launch_rows(const RowsArgs& a, cudaStream_t stream) {
  const int64_t blocks =
      (static_cast<int64_t>(a.B) + ROWS_WARPS - 1) / ROWS_WARPS;
  chain_rows_kernel<NC, VEC>
      <<<static_cast<unsigned>(blocks), 32 * ROWS_WARPS, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The row pass on `stream` (ops/chain_step.py).  y, m and post are [B][K]
// float32, row-major and contiguous; y is overwritten.  post null: the
// forward pass, y = (y / s) ⊙ m (m null: y / s) and scale (nullable, [B])
// = s.  post not null: the backward pass, post = its normalised product with
// y / s and, where m is not null, y = m ⊙ (y / s).  nc: 256, 512 or 1024, at
// least K; vec: 4 where K % 4 == 0 and every matrix is 16-byte aligned
// (read and written 16 bytes at a time), else 1.  Returns the first
// cudaError_t (0 on success), cudaErrorInvalidValue for arguments outside
// the kernel's limits; does not synchronise.
int jt_chain_rows(void* y, const void* m, void* scale, void* post, int64_t B,
                  int64_t K, int nc, int vec, void* stream) {
  auto misaligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 != 0;
  };
  if (B < 1 || B > 0x7FFFFFFF || K < 1 || K > nc || !y
      || (vec == 4 && (K % 4 != 0 || misaligned(y) || misaligned(m)
                       || misaligned(post))))
    return static_cast<int>(cudaErrorInvalidValue);
  RowsArgs a{};
  a.y = static_cast<float*>(y);
  a.m = static_cast<const float*>(m);
  a.scale = static_cast<float*>(scale);
  a.post = static_cast<float*>(post);
  a.B = static_cast<int>(B);
  a.K = static_cast<int>(K);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nc * 8 + vec) {
    case 256 * 8 + 4: return static_cast<int>(launch_rows<256, 4>(a, s));
    case 256 * 8 + 1: return static_cast<int>(launch_rows<256, 1>(a, s));
    case 512 * 8 + 4: return static_cast<int>(launch_rows<512, 4>(a, s));
    case 512 * 8 + 1: return static_cast<int>(launch_rows<512, 1>(a, s));
    case 1024 * 8 + 4: return static_cast<int>(launch_rows<1024, 4>(a, s));
    case 1024 * 8 + 1: return static_cast<int>(launch_rows<1024, 1>(a, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
