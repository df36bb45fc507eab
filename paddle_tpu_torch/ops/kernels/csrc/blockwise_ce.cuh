// Device code shared by the blockwise cross-entropy kernels
// (blockwise_ce.cu) and the fused LM/MLM-head kernels (fused_head_fwd.cu,
// fused_head_bwd.cu), which build their score tiles on the tensor cores
// (wgmma_sm90.cuh, mma_sm90.cuh).
//
// Counterpart of paddle_tpu/ops/pallas/blockwise_ce.py:69-106
// (_online_lse_update, _label_hit, _finalize_loss, _p_ds).
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

// a NaN sum (a NaN logit) stays NaN, as jnp.maximum keeps it in the
// Pallas kernel's max(l, 1e-30); fmaxf alone would drop it
__device__ __forceinline__ float finalize_lse(float m, float l) {
  return m + logf(l != l ? l : fmaxf(l, 1e-30f));
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

// Whether a (n, D) operand's rows start on 16 bytes, so that they move in
// 16-byte pieces.
template <typename T>
__host__ inline bool rows_vectorizable(const void* p, int D) {
  return (D % (16 / sizeof(T))) == 0 &&
         (reinterpret_cast<size_t>(p) & 15) == 0;
}

}  // namespace ptt_ce
