// Shared pieces of the LayerNorm forward and backward kernels (sm_90a):
// the launch plan's constants, 16-byte row packs and the warp reduction.
//
// Both kernels hold a row in registers. A thread of a row's team (one warp,
// or a block of warps for wide rows) holds K packs of V values: pack j of
// thread t covers columns (j * team + t) * V ... + V - 1. V is 16 bytes of
// x's type (4 f32, 8 bf16) when cols is a multiple of it and every pointer
// is 16-byte aligned, else 1; K * V <= kMaxPerLane. The wrapper's _ln_plan
// (ops/kernels/layer_norm.py) picks V, K, the team and the grid.
#pragma once
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <type_traits>

namespace ptt_ln {

constexpr int kMaxCols = 16384;
constexpr int kMaxPerLane = 32;       // values of a row one thread holds
constexpr int kRowWarps = 8;          // warp tier: one row per warp
constexpr int kRowThreads = 32 * kRowWarps;
constexpr int kMaxTeam = 512;         // block tier: up to 16 warps a row

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

// V values of T, loaded and stored as one access (16 bytes when V > 1).
// Kept raw in registers until used, so a load issued ahead does not wait.
template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ Pack<T, V> load_pack(const T* p) {
  return *reinterpret_cast<const Pack<T, V>*>(p);
}

template <typename T, int V>
__device__ __forceinline__ void store_pack(T* p, const Pack<T, V>& v) {
  *reinterpret_cast<Pack<T, V>*>(p) = v;
}

// V f32 values of a (cols,) vector; 16-byte loads when V is a multiple of 4
// (the plan's alignment covers scale and bias too).
template <int V>
__device__ __forceinline__ void load_f32(const float* p, float (&out)[V]) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int i = 0; i < V; i += 4) {
      const float4 f = *reinterpret_cast<const float4*>(p + i);
      out[i] = f.x; out[i + 1] = f.y; out[i + 2] = f.z; out[i + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) out[i] = p[i];
  }
}

// A team member's K packs of an optional (cols,) f32 vector; `fill` where
// the pointer is null or the pack lies past the row.
template <int V, int K>
__device__ __forceinline__ void load_vec(const float* p, int t, int team,
                                         int cols, float fill,
                                         float (&out)[K][V]) {
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int c = (j * team + t) * V;
    if (p != nullptr && c < cols) {
      load_f32<V>(p + c, out[j]);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) out[j][e] = fill;
    }
  }
}

// Sum over the warp by the xor butterfly: every lane gets the same bits
// (each step adds the same two values, in either order).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Calls launch(std::integral_constant<int, W>()) for a block-tier team of
// W warps; the block kernels take W as a template argument, so their
// __launch_bounds__ fit the team (255 registers a thread up to 8 warps).
template <typename F>
cudaError_t with_team(int warps, F&& launch) {
  switch (warps) {
    case 2: return launch(std::integral_constant<int, 2>());
    case 4: return launch(std::integral_constant<int, 4>());
    case 8: return launch(std::integral_constant<int, 8>());
    case 16: return launch(std::integral_constant<int, 16>());
  }
  return cudaErrorInvalidValue;
}

// The K values of x's type for which a C entry instantiates kernels: the
// plan's ladder of packs per thread.
#define PTT_LN_FOR_EACH_K(X) X(1) X(2) X(3) X(4) X(6) X(8) X(16) X(32)

}  // namespace ptt_ln
