// Device code shared by the blockwise cross-entropy kernels
// (blockwise_ce.cu) and the fused LM/MLM-head kernels (fused_head_fwd.cu;
// fused_head_bwd.cu takes the ds helpers and builds its score tiles on the
// tensor cores, mma_sm90.cuh).
//
// Counterpart of paddle_tpu/ops/pallas/blockwise_ce.py:69-106
// (_online_lse_update, _label_hit, _finalize_loss, _p_ds), plus the score
// tile the head kernels build from shared-memory tiles of hidden and weight
// (_head_tile there).
//
//   - online logsumexp: a row's running max m and running sum l of
//     exp(x - m), carried across vocab tiles and merged in a fixed order;
//   - the label hit: column v holds the row's label iff v == label; a label
//     outside [0, V) (an ignore_index of -100) hits no column and is never
//     used as an address;
//   - ds = (exp(s - lse) - onehot) * dloss;
//   - finalisation: lse = m + log(max(l, 1e-30)), loss = lse - s[label].
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace ptt_ce {

constexpr float kNegInf = -1e30f;   // the TPU kernels' running-max start
constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// ---------------------------------------------------------------------------
// online logsumexp, label hit, ds, finalisation
// ---------------------------------------------------------------------------

// Fold one value into (m, l): one exp, and a rescale when the max moves.
__device__ __forceinline__ void lse_push(float& m, float& l, float x) {
  if (x > m) {
    l = l * expf(m - x) + 1.f;
    m = x;
  } else {
    l += expf(x - m);
  }
}

// Merge (m2, l2) into (m, l).
__device__ __forceinline__ void lse_merge(float& m, float& l, float m2,
                                          float l2) {
  const float mn = fmaxf(m, m2);
  l = l * expf(m - mn) + l2 * expf(m2 - mn);
  m = mn;
}

// Start a new tile whose largest value is tile_max: move the running max,
// rescale the running sum; the tile's exp(x - m) terms are added after.
__device__ __forceinline__ void lse_rescale(float& m, float& l,
                                            float tile_max) {
  const float mn = fmaxf(m, tile_max);
  l *= expf(m - mn);
  m = mn;
}

__device__ __forceinline__ bool label_hit(long long col, long long label) {
  return col == label;
}

__device__ __forceinline__ float ce_ds(float s, float lse, float dloss,
                                       bool hit) {
  return (expf(s - lse) - (hit ? 1.f : 0.f)) * dloss;
}

__device__ __forceinline__ float finalize_lse(float m, float l) {
  return m + logf(fmaxf(l, 1e-30f));
}

// Reductions over the `lanes` consecutive lanes that share a row (a power
// of two up to 32); every one of them gets the result, in a fixed order.
template <int lanes>
__device__ __forceinline__ float lanes_max(float v) {
#pragma unroll
  for (int o = lanes / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
template <int lanes>
__device__ __forceinline__ float lanes_sum(float v) {
#pragma unroll
  for (int o = lanes / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---------------------------------------------------------------------------
// score tiles of the head kernels
// ---------------------------------------------------------------------------
//
// A head kernel keeps BR rows of one operand resident in shared memory (R:
// a token tile of hidden, or a vocab tile of the (V, D) weight) and streams
// kBS-row tiles of the other (S). Both sit in shared memory as f32 with row
// stride ld = D4 + 4 (D4: D rounded up to 4, the pad columns zero), so a
// row starts on 16 bytes and rows 8 apart fall in different banks.
// score_tile forms P[r][c] = R[r] . S[c] (BR x kBS, row stride kLdP): each
// thread computes a 4 x 4 patch (rows pr + BR/4 * i, columns pc + 8 * j)
// over every KG-th group of 4 elements of D, read as float4; the KG
// partial tiles go to shared memory and are summed in a fixed order, so a
// score is the same bits on every run.

constexpr int kBS = 32;         // rows of a streamed tile
constexpr int kLdP = kBS + 1;   // row stride of the score / partial tiles

template <int BR>
struct TileShape {
  static constexpr int kPatches = (BR / 4) * (kBS / 4);
  static constexpr int KG = kThreads / kPatches;        // d-groups
  static constexpr int LPR = kThreads / BR;              // lanes per row
  static constexpr int CPL = kBS / LPR;                  // cols per lane
};

__host__ __device__ constexpr int padded_d(int D) { return (D + 3) & ~3; }
__host__ __device__ constexpr int tile_ld(int D) { return padded_d(D) + 4; }

// Shared floats a head kernel needs: R, S, the KG partial tiles and P.
template <int BR>
__host__ __device__ constexpr size_t head_smem_floats(int D) {
  return (size_t)(BR + kBS) * tile_ld(D) +
         (size_t)(TileShape<BR>::KG + 1) * BR * kLdP;
}

__device__ __forceinline__ void cp_async16(float* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

__device__ __forceinline__ void store_row16(float* dst, uint4 v, float) {
  *reinterpret_cast<uint4*>(dst) = v;
}
__device__ __forceinline__ void store_row16(float* dst, uint4 v,
                                            __nv_bfloat16) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
  float2 f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) f[i] = __bfloat1622float2(p[i]);
  *reinterpret_cast<float4*>(dst) = make_float4(f[0].x, f[0].y, f[1].x,
                                                f[1].y);
  *reinterpret_cast<float4*>(dst + 4) = make_float4(f[2].x, f[2].y, f[3].x,
                                                    f[3].y);
}

// ROWS x D of a row-major (n_total, D) matrix into dst (row stride
// tile_ld(D)), widened to f32; rows at or past n_total and the pad columns
// are zeros. vec: the rows start on 16 bytes (src aligned, D a multiple of
// 16 bytes' elements), so they move in 16-byte pieces: f32 by cp.async
// straight into shared memory (every piece of the tile in flight at once),
// bf16 through registers. Otherwise a warp per row, a lane per element.
// The caller synchronises the block before reading dst.
template <typename T, int ROWS>
__device__ __forceinline__ void load_rows(float* dst, const T* src, int row0,
                                          int n_total, int D, bool vec) {
  constexpr int kWarps = kThreads / 32;
  constexpr int RPW = ROWS / kWarps;          // rows per warp
  constexpr int E = 16 / sizeof(T);           // elements per 16 bytes
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ld = tile_ld(D), D4 = padded_d(D);
  if (vec) {
    const int nv = D / E;
    for (int c = lane; c < nv; c += 32) {
      uint4 v[RPW];
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const int r = warp + kWarps * i, g = row0 + r;
        float* out = dst + (size_t)r * ld + c * E;
        const T* in = src + (size_t)g * D + c * E;
        if (sizeof(T) == 4) {
          if (g < n_total)
            cp_async16(out, in);
          else
            *reinterpret_cast<uint4*>(out) = make_uint4(0, 0, 0, 0);
        } else {
          v[i] = g < n_total ? *reinterpret_cast<const uint4*>(in)
                             : make_uint4(0, 0, 0, 0);
        }
      }
      if (sizeof(T) != 4) {
#pragma unroll
        for (int i = 0; i < RPW; ++i)
          store_row16(dst + (size_t)(warp + kWarps * i) * ld + c * E, v[i],
                      T());
      }
    }
    if (sizeof(T) == 4) cp_async_wait_all();
  } else {
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int r = warp + kWarps * i, g = row0 + r;
      float* out = dst + (size_t)r * ld;
      const T* in = src + (size_t)g * D;
      for (int c = lane; c < D4; c += 32)
        out[c] = (g < n_total && c < D) ? to_f32(in[c]) : 0.f;
    }
  }
}

// P = R S^T over D (see above). Ends with the block synchronised and P
// complete.
template <int BR>
__device__ __forceinline__ void score_tile(const float* Rs, const float* Ss,
                                           float* Part, float* P, int D) {
  using TS = TileShape<BR>;
  constexpr int PR = BR / 4;                  // patch rows
  const int ld = tile_ld(D), D4 = padded_d(D);
  const int kg = threadIdx.x / TS::kPatches;
  const int patch = threadIdx.x % TS::kPatches;
  const int pr = patch / (kBS / 4), pc = patch % (kBS / 4);
  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;
#pragma unroll 2
  for (int d = 4 * kg; d < D4; d += 4 * TS::KG) {
    float4 a[4], b[4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[r] = *reinterpret_cast<const float4*>(Rs + (pr + PR * r) * ld + d);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b[j] = *reinterpret_cast<const float4*>(Ss + (pc + 8 * j) * ld + d);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[r][j] = fmaf(a[r].x, b[j].x, acc[r][j]);
        acc[r][j] = fmaf(a[r].y, b[j].y, acc[r][j]);
        acc[r][j] = fmaf(a[r].z, b[j].z, acc[r][j]);
        acc[r][j] = fmaf(a[r].w, b[j].w, acc[r][j]);
      }
  }
  float* part = Part + (size_t)kg * BR * kLdP;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      part[(pr + PR * r) * kLdP + pc + 8 * j] = acc[r][j];
  __syncthreads();
  for (int i = threadIdx.x; i < BR * kBS; i += kThreads) {
    const int r = i / kBS, c = i % kBS;
    float s = 0.f;
#pragma unroll
    for (int g = 0; g < TS::KG; ++g) s += Part[(g * BR + r) * kLdP + c];
    P[r * kLdP + c] = s;
  }
  __syncthreads();
}

// Whether load_rows may move a (n, D) operand in 16-byte pieces.
template <typename T>
__host__ inline bool rows_vectorizable(const void* p, int D) {
  return (D % (16 / sizeof(T))) == 0 &&
         (reinterpret_cast<size_t>(p) & 15) == 0;
}

}  // namespace ptt_ce
