// LayerNorm forward for Hopper (sm_90a), plain C interface.
//
// Replaces paddle_tpu/ops/pallas/layer_norm.py:_ln_call_fwd (kernel body
// _ln_fwd_kernel): per row of x (rows, cols), mean first, then the
// variance of the centred values, both in f32; y = (x - mean) * rstd *
// scale + bias written in x's dtype, plus the f32 per-row mean and rstd.
//
// What bounds it on the H100: ~8 flops per element against 8 (f32) or 4
// (bf16) bytes read and written, so the bytes bound it: at (8192, 768) f32
// ~50 MB, 15 us at 3.35 TB/s. Reaching that rate takes ~16-20 KB of loads
// in flight on every SM, and no per-row barriers or re-reads.
//
// Design (layer_norm.cuh for the row layout): the row lives in registers.
// - Warp tier (cols <= 1024, every main path): one warp per row, each lane
//   holding K 16-byte packs. Mean and centred variance are xor-shuffle sums
//   of the registers; no shared memory, no block barrier.
// - Block tier (wider rows): a block of 2-16 warps per row; the warps'
//   sums meet in shared memory, in warp order, one barrier per sum (two
//   buffers, so no second barrier).
// - Persistent grid: the plan launches about two blocks per SM; each warp
//   (team) loads scale and bias into registers once and walks rows r,
//   r + warps, ... . The warp tier issues the next row's loads before the
//   current row's sums, so two rows per warp are in flight.
// - 16-byte loads and stores when cols is a multiple of the pack and all
//   pointers are aligned; else the same kernels with one element a pack.
// The launch plan comes from the caller; no attribute is set per launch.
#include <cstdint>

#include "layer_norm.cuh"

namespace {

using namespace ptt_ln;

template <typename T, int V, int K>
__device__ __forceinline__ void load_row(const T* __restrict__ row, int t,
                                         int team, int cols,
                                         Pack<T, V> (&p)[K]) {
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int c = (j * team + t) * V;
    if (c < cols) p[j] = load_pack<T, V>(row + c);
  }
}

// The row's f32 values (0 past the row) and this thread's share of its sum,
// packs in order, values in order within a pack.
template <typename T, int V, int K>
__device__ __forceinline__ float unpack_row(const Pack<T, V> (&p)[K], int t,
                                            int team, int cols,
                                            float (&v)[K][V]) {
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const bool in = (j * team + t) * V < cols;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      v[j][e] = in ? to_f32(p[j].v[e]) : 0.f;
      sum += v[j][e];
    }
  }
  return sum;
}

template <int V, int K>
__device__ __forceinline__ float centred_sq(const float (&v)[K][V],
                                            float mean, int t, int team,
                                            int cols) {
  float sq = 0.f;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    if ((j * team + t) * V < cols) {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float d = v[j][e] - mean;
        sq += d * d;
      }
    }
  }
  return sq;
}

template <typename T, int V, int K>
__device__ __forceinline__ void store_row(T* __restrict__ row,
                                          const float (&v)[K][V],
                                          const float (&s)[K][V],
                                          const float (&b)[K][V], float mean,
                                          float rstd, int t, int team,
                                          int cols) {
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int c = (j * team + t) * V;
    if (c < cols) {
      Pack<T, V> o;
#pragma unroll
      for (int e = 0; e < V; ++e)
        o.v[e] = from_f32<T>((v[j][e] - mean) * rstd * s[j][e] + b[j][e]);
      store_pack<T, V>(row + c, o);
    }
  }
}

// Two blocks an SM while a lane holds up to 24 values (768 f32 columns: x,
// the next row, scale and bias in 128 registers), one above.
template <typename T, int V, int K>
__global__ void __launch_bounds__(kRowThreads, K * V > 24 ? 1 : 2)
ln_fwd_warp_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                   const float* __restrict__ bias, T* __restrict__ y,
                   float* __restrict__ mean_out, float* __restrict__ rstd_out,
                   int rows, int cols, float eps) {
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * kRowWarps;
  int row = blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  if (row >= rows) return;                     // the whole warp leaves
  float s[K][V], b[K][V];
  load_vec<V, K>(scale, lane, 32, cols, 1.f, s);
  load_vec<V, K>(bias, lane, 32, cols, 0.f, b);
  const float n = (float)cols;
  Pack<T, V> cur[K], nxt[K];
  load_row<T, V, K>(x + (size_t)row * cols, lane, 32, cols, cur);
  for (; row < rows; row += warps) {
    if (row + warps < rows)                    // the next row, in flight
      load_row<T, V, K>(x + (size_t)(row + warps) * cols, lane, 32, cols,
                        nxt);
    float v[K][V];
    const float mean = warp_sum(unpack_row<T, V, K>(cur, lane, 32, cols, v))
                       / n;
    const float var = warp_sum(centred_sq<V, K>(v, mean, lane, 32, cols)) / n;
    const float rstd = rsqrtf(var + eps);
    store_row<T, V, K>(y + (size_t)row * cols, v, s, b, mean, rstd, lane, 32,
                       cols);
    if (lane == 0) {
      mean_out[row] = mean;
      rstd_out[row] = rstd;
    }
#pragma unroll
    for (int j = 0; j < K; ++j) cur[j] = nxt[j];
  }
}

// Sum of v over the block's W warps, in warp order, to every thread. `red`
// must not be written again before every thread has passed the next
// barrier (the callers alternate two buffers).
template <int W>
__device__ __forceinline__ float team_sum(float v, float* red) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < W; ++w) t += red[w];
  return t;
}

template <typename T, int V, int K, int W>
__global__ void __launch_bounds__(32 * W, 1)
ln_fwd_block_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                    const float* __restrict__ bias, T* __restrict__ y,
                    float* __restrict__ mean_out,
                    float* __restrict__ rstd_out, int rows, int cols,
                    float eps) {
  __shared__ float red[2][W];
  const int t = threadIdx.x, team = 32 * W;
  float s[K][V], b[K][V];
  load_vec<V, K>(scale, t, team, cols, 1.f, s);
  load_vec<V, K>(bias, t, team, cols, 0.f, b);
  const float n = (float)cols;
  for (int row = blockIdx.x; row < rows; row += gridDim.x) {
    Pack<T, V> p[K];
    load_row<T, V, K>(x + (size_t)row * cols, t, team, cols, p);
    float v[K][V];
    const float mean =
        team_sum<W>(unpack_row<T, V, K>(p, t, team, cols, v), red[0]) / n;
    const float var =
        team_sum<W>(centred_sq<V, K>(v, mean, t, team, cols), red[1]) / n;
    const float rstd = rsqrtf(var + eps);
    store_row<T, V, K>(y + (size_t)row * cols, v, s, b, mean, rstd, t, team,
                       cols);
    if (t == 0) {
      mean_out[row] = mean;
      rstd_out[row] = rstd;
    }
  }
}

struct Args {
  const void *x, *scale, *bias;
  void *y, *mean, *rstd;
  int rows, cols;
  float eps;
  int team_warps, grid;
  cudaStream_t stream;
};

template <typename T, int V, int K>
cudaError_t launch(const Args& a) {
  if constexpr (K * V > kMaxPerLane) {
    return cudaErrorInvalidValue;
  } else {
    const T* x = static_cast<const T*>(a.x);
    const float* s = static_cast<const float*>(a.scale);
    const float* b = static_cast<const float*>(a.bias);
    T* y = static_cast<T*>(a.y);
    float* mean = static_cast<float*>(a.mean);
    float* rstd = static_cast<float*>(a.rstd);
    if (a.team_warps == 1) {
      ln_fwd_warp_kernel<T, V, K><<<a.grid, kRowThreads, 0, a.stream>>>(
          x, s, b, y, mean, rstd, a.rows, a.cols, a.eps);
    } else if constexpr (2 * K * V > kMaxPerLane) {
      // the block tier starts where a warp's 32 values a lane run out, so
      // its threads hold more than half of kMaxPerLane
      return with_team(a.team_warps, [&](auto w) {
        ln_fwd_block_kernel<T, V, K, decltype(w)::value>
            <<<a.grid, 32 * decltype(w)::value, 0, a.stream>>>(
                x, s, b, y, mean, rstd, a.rows, a.cols, a.eps);
        return cudaGetLastError();
      });
    } else {
      return cudaErrorInvalidValue;
    }
    return cudaGetLastError();
  }
}

template <typename T, int V>
cudaError_t launch_k(int k, const Args& a) {
  switch (k) {
#define PTT_LN_CASE(K) \
  case K:              \
    return launch<T, V, K>(a);
    PTT_LN_FOR_EACH_K(PTT_LN_CASE)
#undef PTT_LN_CASE
  }
  return cudaErrorInvalidValue;
}

bool aligned16(const void* p) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" int ptt_layer_norm_max_cols() { return kMaxCols; }

// dtype: 0 = float32, 1 = bfloat16. scale/bias: float32 (cols,) or null.
// The plan (ops/kernels/layer_norm.py:_ln_plan): vec values a pack (1, or
// 16 bytes of x's type), k packs a thread, team_warps warps a row (1: the
// warp tier, 8 rows a block; 2-16: the block tier), grid blocks. Returns a
// cudaError_t.
extern "C" int ptt_layer_norm_fwd(const void* x, const void* scale,
                                  const void* bias, void* y, void* mean,
                                  void* rstd, int rows, int cols, int dtype,
                                  float eps, int vec, int k, int team_warps,
                                  int grid, void* stream) {
  if (cols < 1 || cols > kMaxCols || rows < 1 || grid < 1 || k < 1 ||
      team_warps < 1 || team_warps > kMaxTeam / 32 ||
      (long long)k * vec * 32 * team_warps < cols)
    return (int)cudaErrorInvalidValue;
  if (vec > 1 && (cols % vec || !aligned16(x) || !aligned16(y) ||
                  !aligned16(scale) || !aligned16(bias)))
    return (int)cudaErrorMisalignedAddress;
  const Args a{x, scale, bias, y, mean, rstd, rows, cols, eps, team_warps,
               grid, static_cast<cudaStream_t>(stream)};
  if (dtype == 0 && vec == 4) return launch_k<float, 4>(k, a);
  if (dtype == 0 && vec == 1) return launch_k<float, 1>(k, a);
  if (dtype == 1 && vec == 8) return launch_k<__nv_bfloat16, 8>(k, a);
  if (dtype == 1 && vec == 1) return launch_k<__nv_bfloat16, 1>(k, a);
  return (int)cudaErrorInvalidValue;
}
