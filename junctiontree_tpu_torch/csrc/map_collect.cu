// Fused max-plus collect of the tree-MAP program on Hopper (sm_90a).
//
// For one clique of a junction tree, batch row b and output j:
//
//   s(b, v)    = pot[t_0(v)] + a_1(b, v) + ... + a_k(b, v)   (float32, in
//                this order)
//   val[j, b]  = max over r of s(b, j * rest_n + r)
//   idx[j, b]  = the lowest r that attains it
//
// v runs over the clique's states in the (separator, rest) order of the
// traceback (the root: one output, v the flat state in the clique's own
// order).  The addends are the clique's evidence masks, each clamped at
// -1e30 so that a forbidden state never sums to NaN, then its children's
// messages: addend i reads ptr_i[b * bstride_i + t_i(v) * ostride_i]
// (bstride_i = 0 for an unbatched addend).  t_i is a table of int32
// offsets, [1 + k][states], made once per clique by the wrapper
// (ops/map_collect.py): the potential's flat index, the staged row or the
// state of a mask, the flat separator state of a child's message.
//
// Replaces no TPU kernel: the JAX package leaves this step to XLA, and the
// port's plain path writes the [B, clique_states] sum to device memory
// (12 passes of 4 GiB at the 2^18-state clique and B = 4,096) only to
// reduce it to one score and one index per output.  Here nothing of that
// size exists.
//
// What bounds it: instructions.  At the 2^18-state clique with 12 masks
// and B = 4,096 there are 2^30 (row, state) pairs of 12 float32 adds and
// one compare, 1.4e10 FP32 instructions: 0.42 ms at 132 SMs x 128 lanes x
// 1.98 GHz.  The bytes are small: the potential (1 MiB), the masks (393
// KB) and the offset table stay in L2.
//
// Design.
//   * A block of 8 warps takes RT = 32 * RPT rows and a range of states;
//     a warp takes a run of consecutive states, a lane the rows lane + 32q
//     (q < RPT).  So a state's offsets are the same across the warp (one
//     broadcast read each) and each addend's operand is one conflict-free
//     shared-memory load, or one global load, for 32 rows.
//   * The block's rows of the first n_staged masks are staged once in
//     shared memory, clamped, as [stage row][RT]: the row of mask i's
//     state o is its prefix (the sizes of the masks before it) plus o.
//     The wrapper stages as many masks as fit the card's opt-in shared
//     memory (227 KB a block); a mask past them is read from global memory
//     and clamped there, in its place among the adds.
//   * A warp stages, 32 states at a time, their potential values and their
//     table rows of the first 32 addends in shared memory (coalesced
//     loads, one wait for all rows), so no state waits on a global load of
//     its own.  The launch's arguments describe those 32 addends; a clique
//     with more (a hub with many children) has the others described in
//     device memory, each read with its table offset from global memory.
//   * A warp steps over G states at a time: the innermost axes of the
//     rest, whose product G (at most 4) is.  An addend that does not vary
//     over them (at the 2^18-state clique the twelve masks, whose variables
//     are not the last two) is read once for the G states, so one
//     shared-memory load and one offset serve G adds.  The loop over the
//     staged masks, where none varies over the step, is unrolled by 4.
//     Measured on that clique (B = 4,096, twelve masks; NVIDIA H100 80GB
//     HBM3): 2.07, 1.30 and 0.93 ms at G = 1, 2 and 4, 1.67, 1.20 and
//     0.93 ms at RPT = 1, 2 and 4; G = 8 spills registers.  The loads and
//     the loop's own instructions, more than the adds, still set the time.
//   * Each lane keeps a running (max, index) per row over its warp's run
//     of states, taken in increasing order with a strict compare (a step's
//     largest sum against the running maximum, then the lowest of the
//     step's states that attains it), so the lowest index wins a tie.  At
//     the end of each output's segment and of the run it folds the pair
//     into a packed 64-bit key with atomicMax: the score's order-preserving
//     bits above the inverted index.  The largest key is the largest score
//     at the lowest index, whatever order the atomics land in, so the
//     result does not depend on timing; a second kernel unpacks the keys.
//   * Sums are plain float32 adds in the plain path's order (no fused
//     multiply-add can form: nothing is multiplied), so the scores equal
//     the plain path's bit for bit, except that a maximum of -0.0 may read
//     +0.0.  A NaN operand (not a valid mask, potential or message) is
//     passed over here, where the plain path's max would return it.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int MC_THREADS = 256;
constexpr int MC_WARPS = MC_THREADS / 32;
constexpr int MC_ARG_ADDENDS = 32;  // described in the launch's arguments
constexpr int MC_MAX_GROUP = 4;
constexpr int MC_SMEM_DEFAULT = 48 * 1024;
constexpr int MC_SMEM_BYTES = 227 * 1024;  // the opt-in of every sm_90 card
constexpr float MC_NEG = -1e30f;            // the plain path's clamp

// One addend; ops/map_collect.py packs the same 48 bytes (ADDEND_DTYPE).
struct Addend {
  const float* ptr;
  int64_t bstride, ostride;  // in elements; bstride 0: unbatched
  int size;                  // a mask's states, 0 for a message
  int vary;                  // its offsets differ across a step's states
  int inner[MC_MAX_GROUP];   // offset of a step's state u from its first
};
static_assert(sizeof(Addend) == 48, "Addend is packed by the wrapper");

struct CollectArgs {
  const float* pot;          // the clique's potential, flat
  const int* tab;            // [1 + nk][states]
  unsigned long long* keys;  // [out_n][B], zero on entry
  const Addend* ext;         // addends MC_ARG_ADDENDS.., device memory
  int64_t states, rest_n, wchunk;  // wchunk: states of a warp
  int B, n_masks, n_staged, nk;
  int mvary;                 // a staged mask varies over a step
  Addend add[MC_ARG_ADDENDS];
};

__host__ __device__ __forceinline__ int64_t min64(int64_t x, int64_t y) {
  return x < y ? x : y;
}

__device__ __forceinline__ float clamp_neg(float x) {
  return x < MC_NEG ? MC_NEG : x;  // as clamp_min: a NaN stays NaN
}

__device__ __forceinline__ unsigned long long pack_key(float v, int r) {
  const uint32_t u = __float_as_uint(v + 0.0f);  // -0 counts as +0
  const uint32_t ord = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<unsigned long long>(ord) << 32) | ~static_cast<uint32_t>(r);
}

// acc += addend d at table offset o for the G states of a step and the
// lane's RPT rows, read from global memory (clamped if it is a mask).
template <int RPT, int G>
__device__ __forceinline__ void add_global(float (&acc)[G][RPT],
                                           const Addend& d, int o,
                                           const int (&brow)[RPT],
                                           bool clamp) {
  const float* m = d.ptr + o * d.ostride;
  if (d.vary) {
#pragma unroll
    for (int u = 0; u < G; ++u) {
      const float* mu = m + d.inner[u] * d.ostride;
#pragma unroll
      for (int q = 0; q < RPT; ++q) {
        const float x = __ldg(mu + brow[q] * d.bstride);
        acc[u][q] += clamp ? clamp_neg(x) : x;
      }
    }
  } else {
#pragma unroll
    for (int q = 0; q < RPT; ++q) {
      float x = __ldg(m + brow[q] * d.bstride);
      x = clamp ? clamp_neg(x) : x;
#pragma unroll
      for (int u = 0; u < G; ++u) acc[u][q] += x;
    }
  }
}

// RPT rows a lane; G consecutive states a step (the innermost axes of the
// rest, whose product G is): an addend that does not vary over them is
// loaded once for the G states.
template <int RPT, int G>
__global__ void __launch_bounds__(MC_THREADS, RPT * G > 8 ? 3 : 4)
    map_collect_kernel(const __grid_constant__ CollectArgs a) {
  constexpr int RT = 32 * RPT;
  constexpr int CS = 32 / G * G;  // states a warp stages at a time
  // [stage rows][RT] masks, then each warp's [1 + nt][32] staged states
  extern __shared__ float stage[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = blockIdx.x * RT;
  const int nt = a.nk < MC_ARG_ADDENDS ? a.nk : MC_ARG_ADDENDS;

  int base = 0;
  for (int i = 0; i < a.n_staged; ++i) {
    const Addend& d = a.add[i];
    for (int e = threadIdx.x; e < d.size * RT; e += MC_THREADS) {
      const int o = e / RT, r = e % RT;
      const int b = row0 + r;
      stage[(base + o) * RT + r] =
          b < a.B ? clamp_neg(d.ptr[b * d.bstride + o * d.ostride]) : 0.0f;
    }
    base += d.size;
  }
  __syncthreads();

  const int64_t vb = (static_cast<int64_t>(blockIdx.y) * MC_WARPS + warp)
                     * a.wchunk;
  const int64_t ve = min64(vb + a.wchunk, a.states);
  if (vb >= ve) return;

  int brow[RPT];  // a lane's rows, held inside the batch for the loads
  bool live[RPT];
#pragma unroll
  for (int q = 0; q < RPT; ++q) {
    const int b = row0 + lane + 32 * q;
    live[q] = b < a.B;
    brow[q] = live[q] ? b : a.B - 1;
  }
  int64_t j = vb / a.rest_n;
  int r = static_cast<int>(vb - j * a.rest_n);
  const float kNegInf = __int_as_float(0xff800000);
  float best[RPT];
  int arg[RPT];
#pragma unroll
  for (int q = 0; q < RPT; ++q) {
    best[q] = kNegInf;
    arg[q] = r;  // an all -inf segment keeps its first state
  }
  auto flush = [&](int64_t out) {
#pragma unroll
    for (int q = 0; q < RPT; ++q)
      if (live[q])
        atomicMax(a.keys + out * a.B + brow[q], pack_key(best[q], arg[q]));
  };

  const float* sl = stage + lane;
  // row 0: the potential's values of the CS states; row i: addend i - 1's
  // offsets from the table
  int* tb = reinterpret_cast<int*>(stage + base * RT) + warp * (nt + 1) * 32;
  const float* pv = reinterpret_cast<const float*>(tb);
  for (int64_t c0 = vb; c0 < ve; c0 += CS) {
    const int cn = static_cast<int>(min64(CS, ve - c0));
    __syncwarp();
    if (lane < cn) {
      const int* src = a.tab + c0 + lane;
      tb[lane] = __float_as_int(__ldg(a.pot + __ldg(src)));
#pragma unroll 4
      for (int i = 1; i <= nt; ++i)
        tb[i * 32 + lane] = __ldg(src + i * a.states);
    }
    __syncwarp();
    for (int c = 0; c < cn; c += G) {
      float acc[G][RPT];
#pragma unroll
      for (int u = 0; u < G; ++u) {
        const float x = pv[c + u];
#pragma unroll
        for (int q = 0; q < RPT; ++q) acc[u][q] = x;
      }
      const int* t = tb + c + 32;  // addend i's offset: t[32 * i]
      if (!a.mvary) {  // no staged mask varies over the step's states
#pragma unroll 4
        for (int i = 0; i < a.n_staged; ++i) {
          const float* s = sl + t[32 * i] * RT;
#pragma unroll
          for (int q = 0; q < RPT; ++q) {
            const float x = s[32 * q];
#pragma unroll
            for (int u = 0; u < G; ++u) acc[u][q] += x;
          }
        }
      } else {
        for (int i = 0; i < a.n_staged; ++i) {
          const float* s = sl + t[32 * i] * RT;
          if (a.add[i].vary) {
#pragma unroll
            for (int u = 0; u < G; ++u) {
              const float* su = s + a.add[i].inner[u] * RT;
#pragma unroll
              for (int q = 0; q < RPT; ++q) acc[u][q] += su[32 * q];
            }
          } else {
#pragma unroll
            for (int q = 0; q < RPT; ++q) {
              const float x = s[32 * q];
#pragma unroll
              for (int u = 0; u < G; ++u) acc[u][q] += x;
            }
          }
        }
      }
      for (int i = a.n_staged; i < nt; ++i)
        add_global<RPT, G>(acc, a.add[i], t[32 * i], brow, i < a.n_masks);
      for (int i = nt; i < a.nk; ++i)
        add_global<RPT, G>(acc, a.ext[i - MC_ARG_ADDENDS],
                           __ldg(a.tab + (i + 1) * a.states + c0 + c), brow,
                           i < a.n_masks);
      // the step's largest sum first; only where it beats the running
      // maximum is the lowest state that attains it looked for
#pragma unroll
      for (int q = 0; q < RPT; ++q) {
        float top = acc[0][q];
#pragma unroll
        for (int u = 1; u < G; ++u) top = fmaxf(top, acc[u][q]);
        if (top > best[q]) {
          int first = 0;
#pragma unroll
          for (int u = G - 1; u >= 0; --u)
            if (acc[u][q] == top) first = u;
          best[q] = top;
          arg[q] = r + first;
        }
      }
      r += G;
      if (r == a.rest_n) {
        flush(j);
        ++j;
        r = 0;
#pragma unroll
        for (int q = 0; q < RPT; ++q) {
          best[q] = kNegInf;
          arg[q] = 0;
        }
      }
    }
  }
  if (r != 0) flush(j);
}

__global__ void map_decode_kernel(const unsigned long long* keys, float* vals,
                                  int* idx, int64_t n) {
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       e < n; e += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const unsigned long long k = keys[e];
    const uint32_t ord = static_cast<uint32_t>(k >> 32);
    vals[e] = __uint_as_float((ord & 0x80000000u) ? (ord & 0x7FFFFFFFu) : ~ord);
    idx[e] = static_cast<int>(~static_cast<uint32_t>(k));
  }
}

template <int RPT, int G>
cudaError_t launch_collect(const CollectArgs& a, int tiles, int nsplit,
                           size_t smem, cudaStream_t s) {
  if (smem > MC_SMEM_DEFAULT) {
    // once per device: cudaFuncSetAttribute costs host time on every call
    static bool done[64] = {};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev >= 64 || !done[dev]) {
      e = cudaFuncSetAttribute(map_collect_kernel<RPT, G>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               MC_SMEM_BYTES);
      if (e != cudaSuccess) return e;
      if (dev < 64) done[dev] = true;
    }
  }
  map_collect_kernel<RPT, G>
      <<<dim3(static_cast<unsigned>(tiles), static_cast<unsigned>(nsplit)),
         MC_THREADS, smem, s>>>(a);
  return cudaGetLastError();
}

template <int RPT>
cudaError_t launch_rpt(const CollectArgs& a, int group, int tiles, int nsplit,
                       size_t smem, cudaStream_t s) {
  switch (group) {
    case 1: return launch_collect<RPT, 1>(a, tiles, nsplit, smem, s);
    case 2: return launch_collect<RPT, 2>(a, tiles, nsplit, smem, s);
    case 3: return launch_collect<RPT, 3>(a, tiles, nsplit, smem, s);
    case 4: return launch_collect<RPT, 4>(a, tiles, nsplit, smem, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// The fused collect of one clique on `stream`.  `pot` is the potential
// (float32, flat), `tab` the [1 + k][states] int32 offsets (k = n_masks +
// n_msgs).  `desc` (int64): states, rest_n, B, n_masks, n_msgs, n_staged
// (the masks staged in shared memory, a prefix of at most 32), rpt (1, 2
// or 4 rows a lane), group (1-4 states a step), wchunk (states a warp, a
// multiple of group), nsplit (blocks along the states).  `adds`: the k
// addends (masks first), host memory; `ext`: addends 32.. again, in
// device memory (null if k <= 32).  `keys` ([out_n][B] uint64, out_n =
// states / rest_n) is zeroed, the warps fold into it, and a second kernel
// unpacks it into `vals` and `idx` ([out_n][B]).  Returns the first
// cudaError_t (0 on success), cudaErrorInvalidValue for arguments outside
// the kernel's limits; does not synchronise.
int jt_map_collect(const void* pot, const void* tab, void* keys, void* vals,
                   void* idx, const int64_t* desc, const void* adds,
                   const void* ext, void* stream) {
  const int64_t states = desc[0], rest_n = desc[1], B = desc[2],
                n_masks = desc[3], n_msgs = desc[4], n_staged = desc[5],
                rpt = desc[6], group = desc[7], wchunk = desc[8],
                nsplit = desc[9];
  const int64_t nk = n_masks + n_msgs;
  const int64_t nt = min64(nk, MC_ARG_ADDENDS);
  const int64_t rt = 32 * rpt;
  const int64_t tiles = (B + rt - 1) / rt;
  if (states < 1 || states > 0x7FFFFFFF || rest_n < 1 || states % rest_n
      || B < 1 || B > 0x7FFFFFFF || tiles > 0x7FFFFFFF || n_masks < 0
      || n_msgs < 0 || n_staged < 0
      || n_staged > min64(n_masks, MC_ARG_ADDENDS) || (nk > nt && !ext)
      || nsplit < 1 || nsplit > 65535 || !(rpt == 1 || rpt == 2 || rpt == 4)
      || group < 1 || group > MC_MAX_GROUP || rest_n % group || wchunk < 1
      || wchunk % group || nsplit * MC_WARPS * wchunk < states)
    return static_cast<int>(cudaErrorInvalidValue);
  CollectArgs a{};
  a.pot = static_cast<const float*>(pot);
  a.tab = static_cast<const int*>(tab);
  a.keys = static_cast<unsigned long long*>(keys);
  a.ext = static_cast<const Addend*>(ext);
  a.states = states;
  a.rest_n = rest_n;
  a.wchunk = wchunk;
  a.B = static_cast<int>(B);
  a.n_masks = static_cast<int>(n_masks);
  a.n_staged = static_cast<int>(n_staged);
  a.nk = static_cast<int>(nk);
  const Addend* in = static_cast<const Addend*>(adds);
  int64_t stage_rows = 0;
  for (int i = 0; i < nt; ++i) {
    a.add[i] = in[i];
    if (i < n_staged) {
      stage_rows += a.add[i].size;
      a.mvary |= a.add[i].vary;
    }
  }
  const size_t smem = static_cast<size_t>(stage_rows * rt + MC_WARPS * (nt + 1) * 32) * 4;
  if (smem > MC_SMEM_BYTES) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t n = states / rest_n * B;
  cudaError_t e = cudaMemsetAsync(keys, 0, n * sizeof(unsigned long long), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int t = static_cast<int>(tiles), g = static_cast<int>(group),
            ns = static_cast<int>(nsplit);
  e = rpt == 1   ? launch_rpt<1>(a, g, t, ns, smem, s)
      : rpt == 2 ? launch_rpt<2>(a, g, t, ns, smem, s)
                 : launch_rpt<4>(a, g, t, ns, smem, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t blocks = min64((n + 255) / 256, 4096);
  map_decode_kernel<<<static_cast<unsigned>(blocks), 256, 0, s>>>(
      static_cast<const unsigned long long*>(keys), static_cast<float*>(vals),
      static_cast<int*>(idx), n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
