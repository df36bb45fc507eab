// LayerNorm backward for Hopper (sm_90a), plain C interface: two entries,
// the per-row pass and the column reduction.
//
// Replaces paddle_tpu/ops/pallas/layer_norm.py:_ln_bwd (kernel body
// _ln_bwd_kernel): with x_hat = (x - mean) * rstd and gs = g * scale,
//   dx     = rstd * (gs - mean(gs) - x_hat * mean(gs * x_hat))   per row,
//   dscale = sum over rows of g * x_hat,  dbias = sum over rows of g,
// row sums and column sums in f32, from the forward's per-row f32 mean and
// rstd. dx is written in x's dtype, dscale/dbias in f32.
//
// What bounds it on the H100: ~12 flops per element against reading x and
// g and writing dx (12 bytes per f32 element), far below the card's ~20 f32
// flops per byte, so the bytes bound it: at (4096, 768) f32 that is
// ~38 MB, ~11 us at 3.35 TB/s.
//
// Design: the TPU kernel carries dscale/dbias in VMEM scratch across its
// sequential row-block grid; CUDA blocks run in no order, and atomics would
// make the sums depend on the order of arrival. So pass 1 gives each
// 256-thread block a fixed run of rows: for each row it reads x and g once
// for the two row sums (block reductions), a second time (from L1/L2, the
// row being a few KB) to write dx, and adds the row's g * x_hat and g into
// per-column f32 partials held in shared memory (each column owned by one
// thread, so no race). The block writes its partials as one row of a
// (blocks, cols) array. Pass 2 sums that array down its columns, one thread
// per column in a fixed order. Two runs give equal bits. Shared memory caps
// cols at the forward's kMaxCols.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCols = 16384;    // as layer_norm_fwd.cu

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

// Sums of a and b over the block, returned to every thread.
__device__ __forceinline__ void block_sum2(float& a, float& b, float* red) {
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  __syncthreads();  // an earlier call's readers are done with red
  if ((threadIdx.x & 31) == 0) {
    red[threadIdx.x >> 5] = a;
    red[kWarps + (threadIdx.x >> 5)] = b;
  }
  __syncthreads();
  a = b = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    a += red[w];
    b += red[kWarps + w];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ln_bwd_rows_kernel(const T* __restrict__ x, const T* __restrict__ g,
                   const float* __restrict__ scale,
                   const float* __restrict__ mean,
                   const float* __restrict__ rstd, T* __restrict__ dx,
                   float* __restrict__ dscale_part,
                   float* __restrict__ dbias_part, int rows, int cols,
                   int rows_per_block) {
  extern __shared__ float part[];   // [2][cols]: dscale, dbias partials
  __shared__ float red[2 * kWarps];
  float* ds_acc = part;
  float* db_acc = part + cols;
  for (int c = threadIdx.x; c < cols; c += kThreads)
    ds_acc[c] = db_acc[c] = 0.f;
  const float inv_cols = 1.f / (float)cols;
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(rows, r0 + rows_per_block);

  for (int row = r0; row < r1; ++row) {
    const size_t base = (size_t)row * cols;
    const float mu = mean[row], rs = rstd[row];
    float sg = 0.f, sgx = 0.f;
    for (int c = threadIdx.x; c < cols; c += kThreads) {
      const float gv = to_f32(g[base + c]);
      const float xh = (to_f32(x[base + c]) - mu) * rs;
      const float gs = scale ? gv * scale[c] : gv;
      sg += gs;
      sgx += gs * xh;
      ds_acc[c] += gv * xh;
      db_acc[c] += gv;
    }
    block_sum2(sg, sgx, red);
    const float mg = sg * inv_cols, mgx = sgx * inv_cols;
    for (int c = threadIdx.x; c < cols; c += kThreads) {
      const float gv = to_f32(g[base + c]);
      const float xh = (to_f32(x[base + c]) - mu) * rs;
      const float gs = scale ? gv * scale[c] : gv;
      dx[base + c] = from_f32<T>(rs * (gs - mg - xh * mgx));
    }
  }
  for (int c = threadIdx.x; c < cols; c += kThreads) {
    dscale_part[(size_t)blockIdx.x * cols + c] = ds_acc[c];
    dbias_part[(size_t)blockIdx.x * cols + c] = db_acc[c];
  }
}

__global__ void __launch_bounds__(kThreads)
ln_bwd_cols_kernel(const float* __restrict__ dscale_part,
                   const float* __restrict__ dbias_part,
                   float* __restrict__ dscale, float* __restrict__ dbias,
                   int blocks, int cols) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= cols) return;
  float s = 0.f, b = 0.f;
  for (int i = 0; i < blocks; ++i) {
    s += dscale_part[(size_t)i * cols + c];
    b += dbias_part[(size_t)i * cols + c];
  }
  dscale[c] = s;
  dbias[c] = b;
}

template <typename T>
cudaError_t launch_rows(const void* x, const void* g, const void* scale,
                        const void* mean, const void* rstd, void* dx,
                        void* dscale_part, void* dbias_part, int rows,
                        int cols, int rows_per_block, cudaStream_t stream) {
  const size_t smem = 2 * sizeof(float) * (size_t)cols;
  cudaError_t err = cudaFuncSetAttribute(
      ln_bwd_rows_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(2 * sizeof(float) * kMaxCols));
  if (err != cudaSuccess) return err;
  const int blocks = (rows + rows_per_block - 1) / rows_per_block;
  ln_bwd_rows_kernel<T><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g),
      static_cast<const float*>(scale), static_cast<const float*>(mean),
      static_cast<const float*>(rstd), static_cast<T*>(dx),
      static_cast<float*>(dscale_part), static_cast<float*>(dbias_part), rows,
      cols, rows_per_block);
  return cudaGetLastError();
}

}  // namespace

// Pass 1. dtype: 0 = float32, 1 = bfloat16 (x, g, dx). scale: float32
// (cols,) or null (ones). mean/rstd: float32 (rows,). dscale_part and
// dbias_part: float32 (ceil(rows / rows_per_block), cols). Returns a
// cudaError_t.
extern "C" int ptt_layer_norm_bwd(const void* x, const void* g,
                                  const void* scale, const void* mean,
                                  const void* rstd, void* dx,
                                  void* dscale_part, void* dbias_part,
                                  int rows, int cols, int dtype,
                                  int rows_per_block, void* stream) {
  if (cols < 1 || cols > kMaxCols || rows < 1 || rows_per_block < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_rows<float>(x, g, scale, mean, rstd, dx, dscale_part,
                              dbias_part, rows, cols, rows_per_block, s);
  if (dtype == 1)
    return launch_rows<__nv_bfloat16>(x, g, scale, mean, rstd, dx,
                                      dscale_part, dbias_part, rows, cols,
                                      rows_per_block, s);
  return (int)cudaErrorInvalidValue;
}

// Pass 2: dscale/dbias (cols,) float32 = column sums of the (blocks, cols)
// partials. Returns a cudaError_t.
extern "C" int ptt_layer_norm_bwd_reduce(const void* dscale_part,
                                         const void* dbias_part,
                                         void* dscale, void* dbias,
                                         int blocks, int cols, void* stream) {
  if (cols < 1 || blocks < 1) return (int)cudaErrorInvalidValue;
  ln_bwd_cols_kernel<<<(cols + kThreads - 1) / kThreads, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dscale_part),
      static_cast<const float*>(dbias_part), static_cast<float*>(dscale),
      static_cast<float*>(dbias), blocks, cols);
  return cudaGetLastError();
}
