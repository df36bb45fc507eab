// LayerNorm forward for Hopper (sm_90a), plain C interface.
//
// Replaces paddle_tpu/ops/pallas/layer_norm.py:_ln_call_fwd (kernel body
// _ln_fwd_kernel): per row of x (rows, cols), mean first, then the
// variance of the centred values, both in f32; y = (x - mean) * rstd *
// scale + bias written in x's dtype, plus the f32 per-row mean and rstd.
//
// What bounds it on the H100: it does ~8 flops per element against 4 or
// 2 bytes read and written per element, far below the card's ~20 f32
// flops per byte, so the bytes bound it: at (4096, 768) f32 that is
// ~25 MB, ~7.5 us at 3.35 TB/s.
//
// Design: one 256-thread block per row. The row is read from device memory
// once into shared memory (widened to f32); the mean and the centred
// variance are two block reductions over the shared copy (warp shuffles,
// then one value per warp), and the normalised row is written once. So
// device memory sees each input byte read once and each output byte
// written once, as the bound assumes. Scale and bias are optional f32
// pointers. The shared row caps cols at kMaxCols.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCols = 16384;

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

// Sum of v over the block, returned to every thread.
__device__ __forceinline__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();  // an earlier call's readers are done with red
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) t += red[w];
  return t;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ln_fwd_kernel(const T* __restrict__ x, const float* __restrict__ scale,
              const float* __restrict__ bias, T* __restrict__ y,
              float* __restrict__ mean_out, float* __restrict__ rstd_out,
              int cols, float eps) {
  extern __shared__ float row[];
  __shared__ float red[kWarps];
  const size_t base = (size_t)blockIdx.x * cols;
  const float inv_cols = 1.f / (float)cols;

  float sum = 0.f;
  for (int c = threadIdx.x; c < cols; c += kThreads) {
    const float v = to_f32(x[base + c]);
    row[c] = v;
    sum += v;
  }
  const float mean = block_sum(sum, red) * inv_cols;

  float sq = 0.f;
  for (int c = threadIdx.x; c < cols; c += kThreads) {
    const float d = row[c] - mean;
    sq += d * d;
  }
  const float rstd = rsqrtf(block_sum(sq, red) * inv_cols + eps);

  for (int c = threadIdx.x; c < cols; c += kThreads) {
    float t = (row[c] - mean) * rstd;
    if (scale) t *= scale[c];
    if (bias) t += bias[c];
    y[base + c] = from_f32<T>(t);
  }
  if (threadIdx.x == 0) {
    mean_out[blockIdx.x] = mean;
    rstd_out[blockIdx.x] = rstd;
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* scale, const void* bias,
                   void* y, void* mean, void* rstd, int rows, int cols,
                   float eps, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)cols;
  cudaError_t err = cudaFuncSetAttribute(
      ln_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(sizeof(float) * kMaxCols));
  if (err != cudaSuccess) return err;
  ln_fwd_kernel<T><<<rows, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<T*>(y),
      static_cast<float*>(mean), static_cast<float*>(rstd), cols, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ptt_layer_norm_max_cols() { return kMaxCols; }

// dtype: 0 = float32, 1 = bfloat16. scale/bias: float32 (cols,) or null.
// Returns a cudaError_t.
extern "C" int ptt_layer_norm_fwd(const void* x, const void* scale,
                                  const void* bias, void* y, void* mean,
                                  void* rstd, int rows, int cols, int dtype,
                                  float eps, void* stream) {
  if (cols < 1 || cols > kMaxCols || rows < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, scale, bias, y, mean, rstd, rows, cols, eps, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, scale, bias, y, mean, rstd, rows, cols,
                                 eps, s);
  return (int)cudaErrorInvalidValue;
}
