// Blockwise softmax cross-entropy of existing logits for Hopper (sm_90a),
// plain C interface: two kernels, forward (loss and logsumexp per row) and
// backward (dlogits).
//
// Replaces paddle_tpu/ops/pallas/blockwise_ce.py:_ce_call_fwd (kernel body
// _ce_fwd_kernel) and _ce_bwd (kernel body _ce_bwd_kernel):
//   forward:  lse = logsumexp(x[t, :]), loss = lse - x[t, label]   (T,)
//   backward: dx = (exp(x - lse) - onehot(label)) * dloss          (T, V)
// in one streaming pass each, so no log-softmax or softmax (T, V)
// intermediate exists; dx has the logits' shape and dtype.
//
// What bounds it on the H100: a few operations per element against reading
// the logits once (forward) or reading them and writing dx (backward). At
// GPT-base's (T, V) = (8192, 32000) f32 that is 1.05 GB, 0.31 ms at
// 3.35 TB/s, and 2.1 GB, 0.63 ms: the bytes bound them.
//
// Design: one 256-thread block per row. The forward folds each element into
// a per-thread online logsumexp (blockwise_ce.cuh:lse_push, one exp per
// element), merges the 256 partial (max, sum) pairs by a fixed shuffle tree
// and then warp by warp in order (equal bits on every run), and reads the
// label's logit once when the label lies in [0, V). The backward is one
// elementwise pass. f32 rows whose length is a multiple of 4 are read (and
// written) as float4.
#include "blockwise_ce.cuh"

namespace {

using namespace ptt_ce;

constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ bool vec4_ok(const void* p, int V) {
  return (V & 3) == 0 && (reinterpret_cast<size_t>(p) & 15) == 0;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ce_fwd_kernel(const T* __restrict__ logits,
              const long long* __restrict__ labels, float* __restrict__ loss,
              float* __restrict__ lse_out, int V) {
  __shared__ float red_m[kWarps], red_l[kWarps];
  const int row = blockIdx.x;
  const T* x = logits + (size_t)row * V;
  float m = kNegInf, l = 0.f;
  if (sizeof(T) == 4 && vec4_ok(logits, V)) {
    const float4* x4 = reinterpret_cast<const float4*>(x);
    for (int c = threadIdx.x; c < V / 4; c += kThreads) {
      const float4 v = x4[c];
      lse_push(m, l, v.x);
      lse_push(m, l, v.y);
      lse_push(m, l, v.z);
      lse_push(m, l, v.w);
    }
  } else {
    for (int c = threadIdx.x; c < V; c += kThreads) lse_push(m, l, to_f32(x[c]));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
    const float l2 = __shfl_xor_sync(0xffffffffu, l, o);
    lse_merge(m, l, m2, l2);
  }
  if ((threadIdx.x & 31) == 0) {
    red_m[threadIdx.x >> 5] = m;
    red_l[threadIdx.x >> 5] = l;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    m = red_m[0];
    l = red_l[0];
    for (int i = 1; i < kWarps; ++i) lse_merge(m, l, red_m[i], red_l[i]);
    const long long label = labels[row];
    const float hit = (label >= 0 && label < V) ? to_f32(x[label]) : 0.f;
    const float lse = finalize_lse(m, l);
    lse_out[row] = lse;
    loss[row] = lse - hit;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ce_bwd_kernel(const T* __restrict__ logits,
              const long long* __restrict__ labels,
              const float* __restrict__ lse, const float* __restrict__ dloss,
              T* __restrict__ dx, int V) {
  const int row = blockIdx.x;
  const size_t base = (size_t)row * V;
  const long long label = labels[row];
  const float l = lse[row], dl = dloss[row];
  if (sizeof(T) == 4 && vec4_ok(logits, V) && vec4_ok(dx, V)) {
    const float4* x4 = reinterpret_cast<const float4*>(logits + base);
    float4* d4 = reinterpret_cast<float4*>(dx + base);
    for (int c = threadIdx.x; c < V / 4; c += kThreads) {
      const float4 v = x4[c];
      const long long col = 4LL * c;
      float4 o;
      o.x = ce_ds(v.x, l, dl, label_hit(col, label));
      o.y = ce_ds(v.y, l, dl, label_hit(col + 1, label));
      o.z = ce_ds(v.z, l, dl, label_hit(col + 2, label));
      o.w = ce_ds(v.w, l, dl, label_hit(col + 3, label));
      d4[c] = o;
    }
  } else {
    for (int c = threadIdx.x; c < V; c += kThreads)
      dx[base + c] = from_f32<T>(
          ce_ds(to_f32(logits[base + c]), l, dl, label_hit(c, label)));
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 logits (T, V), dense; labels int64 (T,).
// Writes loss and lse, float32 (T,). Returns a cudaError_t.
extern "C" int ptt_ce_fwd(const void* logits, const void* labels, void* loss,
                          void* lse, int Tn, int V, int dtype, void* stream) {
  if (Tn < 1 || V < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* lab = static_cast<const long long*>(labels);
  if (dtype == 0)
    ce_fwd_kernel<float><<<Tn, kThreads, 0, s>>>(
        static_cast<const float*>(logits), lab, static_cast<float*>(loss),
        static_cast<float*>(lse), V);
  else if (dtype == 1)
    ce_fwd_kernel<__nv_bfloat16><<<Tn, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(logits), lab,
        static_cast<float*>(loss), static_cast<float*>(lse), V);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// As ptt_ce_fwd, from the forward's lse and the loss cotangent dloss
// (float32 (T,)); writes dlogits (T, V) in the logits' dtype.
extern "C" int ptt_ce_bwd(const void* logits, const void* labels,
                          const void* lse, const void* dloss, void* dlogits,
                          int Tn, int V, int dtype, void* stream) {
  if (Tn < 1 || V < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* lab = static_cast<const long long*>(labels);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(dloss);
  if (dtype == 0)
    ce_bwd_kernel<float><<<Tn, kThreads, 0, s>>>(
        static_cast<const float*>(logits), lab, l, dl,
        static_cast<float*>(dlogits), V);
  else if (dtype == 1)
    ce_bwd_kernel<__nv_bfloat16><<<Tn, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(logits), lab, l, dl,
        static_cast<__nv_bfloat16*>(dlogits), V);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
