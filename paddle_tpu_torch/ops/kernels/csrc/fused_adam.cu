// Fused Adam / AdamW update for Hopper (sm_90a), plain C interface.
//
// Replaces paddle_tpu/ops/pallas/fused_adam.py:fused_adam (kernel body
// _adam_kernel), which the JAX package's adam and adamw ops reach
// (paddle_tpu/ops/optimizer_ops.py:58-132): in one pass over a parameter,
//   m1' = b1 * m1 + (1 - b1) * g,   m2' = b2 * m2 + (1 - b2) * g * g,
//   p1  = rnd(p - lr_t * m1' / (sqrt(m2') + eps)),
//   lr_t = lr * sqrt(1 - b2^t) / (1 - b1^t),
// and for AdamW (coeff > 0) the decoupled decay from the parameter before
// the step and the raw learning rate,
//   p'  = rnd(p1 - (lr * coeff) * p),
// in f32, rnd rounding to the parameter's dtype (a bf16 parameter is
// widened and rounded back after each of the two steps, as the JAX
// package rounds its adam output before adamw's decay). p, m1 and m2 are
// updated in place; the old p stays in registers, so AdamW moves the
// same bytes as Adam. lr_t and lr * coeff are computed on the device from
// the LearningRate (a schedule's output), Beta1Pow and Beta2Pow tensors,
// so the host never waits for a value. The decay is a template argument:
// coeff = 0 launches the Adam instantiation, whose code is Adam's alone.
//
// What bounds it on the H100: ~12 flops per element against 28 bytes
// moved (read p, g, m1, m2; write p, m1, m2; f32), so the bytes bound it:
// BERT-base's ~110 M parameters are ~3.1 GB per step, ~0.92 ms at
// 3.35 TB/s.
//
// Design: an elementwise grid-stride loop, each element read and written
// once. When every pointer is 16-byte aligned (and the parameter is f32)
// threads move float4s, the widest plain load; otherwise one element per
// thread. The TPU kernel's floor of one (8, 128) tile and its lane padding
// are TPU tiling rules: this kernel takes any size and never pads.
//
// Launch config (the TPU kernel's block_rows; ops/kernel_dispatch.py picks
// it per call site from a sweep's verdict): the grid's cap in blocks an
// SM, 1-64; 0 keeps the default, 16. The update of an element does not
// depend on it.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kDefaultBlocksPerSm = 16;

struct Hyper {
  float b1, one_minus_b1, b2, one_minus_b2, eps, coeff;
};

__device__ __forceinline__ float lr_t(const float* lr, const float* b1p,
                                      const float* b2p) {
  return lr[0] * sqrtf(1.f - b2p[0]) / (1.f - b1p[0]);
}

__device__ __forceinline__ void adam1(float& p, float g, float& m1, float& m2,
                                      float lt, const Hyper& h) {
  m1 = h.b1 * m1 + h.one_minus_b1 * g;
  m2 = h.b2 * m2 + h.one_minus_b2 * g * g;
  p = p - lt * m1 / (sqrtf(m2) + h.eps);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// x rounded to the parameter's dtype P and widened back to f32
template <typename P>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// AdamW's decay of the updated p1 from the old p0: rounded multiply and
// subtract (no fused multiply-add), as the plain version computes it
template <typename P>
__device__ __forceinline__ float decay(float p1, float p0, float lc) {
  return __fsub_rn(round_to<P>(p1), __fmul_rn(lc, p0));
}

template <typename P, bool kDecay>
__global__ void __launch_bounds__(kThreads)
adam_kernel(P* __restrict__ p, const float* __restrict__ g,
            float* __restrict__ m1, float* __restrict__ m2,
            const float* __restrict__ lr, const float* __restrict__ b1p,
            const float* __restrict__ b2p, Hyper h, long long n) {
  const float lt = lr_t(lr, b1p, b2p);
  const float lc = kDecay ? __fmul_rn(lr[0], h.coeff) : 0.f;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride) {
    const float p0 = to_f32(p[i]);
    float pv = p0, a = m1[i], b = m2[i];
    adam1(pv, g[i], a, b, lt, h);
    if (kDecay) pv = decay<P>(pv, p0, lc);
    store(p + i, pv);
    m1[i] = a;
    m2[i] = b;
  }
}

template <bool kDecay>
__global__ void __launch_bounds__(kThreads)
adam_kernel_vec4(float4* __restrict__ p, const float4* __restrict__ g,
                 float4* __restrict__ m1, float4* __restrict__ m2,
                 const float* __restrict__ lr, const float* __restrict__ b1p,
                 const float* __restrict__ b2p, Hyper h, long long n4) {
  const float lt = lr_t(lr, b1p, b2p);
  const float lc = kDecay ? __fmul_rn(lr[0], h.coeff) : 0.f;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n4;
       i += stride) {
    const float4 p0 = p[i];
    float4 pv = p0, gv = g[i], a = m1[i], b = m2[i];
    adam1(pv.x, gv.x, a.x, b.x, lt, h);
    adam1(pv.y, gv.y, a.y, b.y, lt, h);
    adam1(pv.z, gv.z, a.z, b.z, lt, h);
    adam1(pv.w, gv.w, a.w, b.w, lt, h);
    if (kDecay) {
      pv.x = decay<float>(pv.x, p0.x, lc);
      pv.y = decay<float>(pv.y, p0.y, lc);
      pv.z = decay<float>(pv.z, p0.z, lc);
      pv.w = decay<float>(pv.w, p0.w, lc);
    }
    p[i] = pv;
    m1[i] = a;
    m2[i] = b;
  }
}

int grid_for(long long work, int blocks_per_sm) {
  const long long blocks = (work + kThreads - 1) / kThreads;
  const long long cap = 132LL * blocks_per_sm;
  return (int)(blocks < cap ? blocks : cap);
}

bool aligned16(const void* a) { return ((uintptr_t)a & 15u) == 0; }

template <bool kDecay>
int launch(void* p, const void* g, void* m1, void* m2, const float* lrp,
           const float* b1p, const float* b2p, long long n, int dtype,
           const Hyper& h, int bps, cudaStream_t s) {
  if (dtype == 0) {
    long long n4 = 0;
    if (aligned16(p) && aligned16(g) && aligned16(m1) && aligned16(m2)) {
      n4 = n / 4;
      if (n4)
        adam_kernel_vec4<kDecay><<<grid_for(n4, bps), kThreads, 0, s>>>(
            static_cast<float4*>(p), static_cast<const float4*>(g),
            static_cast<float4*>(m1), static_cast<float4*>(m2), lrp, b1p,
            b2p, h, n4);
    }
    const long long done = 4 * n4;
    if (done < n)
      adam_kernel<float, kDecay><<<grid_for(n - done, bps), kThreads, 0, s>>>(
          static_cast<float*>(p) + done, static_cast<const float*>(g) + done,
          static_cast<float*>(m1) + done, static_cast<float*>(m2) + done,
          lrp, b1p, b2p, h, n - done);
    return cudaGetLastError();
  }
  if (dtype == 1) {
    adam_kernel<__nv_bfloat16, kDecay><<<grid_for(n, bps), kThreads, 0, s>>>(
        static_cast<__nv_bfloat16*>(p), static_cast<const float*>(g),
        static_cast<float*>(m1), static_cast<float*>(m2), lrp, b1p, b2p, h,
        n);
    return cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (the parameter p). g, m1, m2: float32,
// n elements each, dense; p, m1 and m2 are updated in place. lr, beta1_pow
// and beta2_pow point at one float32 each. coeff: AdamW's decoupled weight
// decay, 0 for Adam. blocks_per_sm: the launch config (1-64; 0 the
// default). Returns a cudaError_t.
extern "C" int ptt_fused_adam(void* p, const void* g, void* m1, void* m2,
                              const void* lr, const void* beta1_pow,
                              const void* beta2_pow, long long n, int dtype,
                              float beta1, float beta2, float one_minus_beta1,
                              float one_minus_beta2, float eps, float coeff,
                              int blocks_per_sm, void* stream) {
  if (blocks_per_sm == 0) blocks_per_sm = kDefaultBlocksPerSm;
  if (n < 1 || blocks_per_sm < 1 || blocks_per_sm > 64)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Hyper h{beta1, one_minus_beta1, beta2, one_minus_beta2, eps, coeff};
  const float* lrp = static_cast<const float*>(lr);
  const float* b1p = static_cast<const float*>(beta1_pow);
  const float* b2p = static_cast<const float*>(beta2_pow);
  return coeff != 0.f
             ? launch<true>(p, g, m1, m2, lrp, b1p, b2p, n, dtype, h,
                            blocks_per_sm, s)
             : launch<false>(p, g, m1, m2, lrp, b1p, b2p, n, dtype, h,
                             blocks_per_sm, s);
}
