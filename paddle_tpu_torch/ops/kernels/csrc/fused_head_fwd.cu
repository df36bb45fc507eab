// Fused LM/MLM head forward for Hopper (sm_90a), plain C interface:
// hidden (T, D) @ weight^T (+ bias) -> per-token softmax cross-entropy
// loss (T,) and logsumexp (T,), without a (T, V) logits buffer.
//
// Replaces paddle_tpu/ops/pallas/blockwise_ce.py:_head_call_fwd (kernel
// body _head_fwd_kernel). The weight is the tied (V, D) embedding table,
// read as stored: the JAX op transposes it to (D, V) before its kernel
// (paddle_tpu/ops/nn_ops.py:434); this kernel reads (V, D) rows in place.
//
// What bounds it on the H100: 2*T*D*V operations against reading hidden and
// weight once. At GPT-base's head (T, D, V) = (8192, 768, 32000) in f32 that
// is 402.7 GFLOP, 2.44 ms at the 165 TFLOP/s of f32-accurate tensor-core
// work (3xTF32: 495 TFLOP/s over three), against 124 MB, 0.04 ms at 3.35
// TB/s: the operations bound it. This version still runs f32 FFMA on the
// CUDA cores (no TF32, no tensor cores), whose own rate, 67 TFLOP/s, would
// allow 6.0 ms; bf16 operands are widened to f32 in shared memory, so bf16
// is no faster.
//
// Design: a 256-thread block owns BR tokens (32, or 16 above D = 768): their
// hidden rows stay in shared memory while a loop walks the vocabulary in
// 32-row weight tiles, each moved in 16-byte pieces (cp.async for f32) when
// its rows allow (blockwise_ce.cuh:load_rows, score_tile). The (BR, 32)
// score tile is folded into each row's online logsumexp (8 or 16 lanes per
// row, shuffle reductions) and its label logit; nothing of size (T, V)
// reaches memory.
// Ragged T and V are masked in-kernel; D runs to 1024 (the smem tiles).
#include "blockwise_ce.cuh"

namespace {

using namespace ptt_ce;

constexpr int kMaxD = 1024;

template <typename T, int BR>
__global__ void __launch_bounds__(kThreads, 1)
head_fwd_kernel(const T* __restrict__ h, const T* __restrict__ w,
                const float* __restrict__ bias,
                const long long* __restrict__ labels,
                float* __restrict__ loss, float* __restrict__ lse_out, int Tn,
                int V, int D, bool vec_h, bool vec_w) {
  using TS = TileShape<BR>;
  extern __shared__ __align__(16) float smem[];
  const int ld = tile_ld(D);
  float* Rs = smem;                           // [BR][ld] hidden rows
  float* Ss = Rs + (size_t)BR * ld;           // [kBS][ld] weight rows
  float* Part = Ss + (size_t)kBS * ld;        // [KG][BR][kLdP]
  float* P = Part + (size_t)TS::KG * BR * kLdP;   // [BR][kLdP]

  const int t0 = blockIdx.x * BR;
  const int row = threadIdx.x / TS::LPR, lane_c = threadIdx.x % TS::LPR;
  const int tg = t0 + row;
  const long long label = tg < Tn ? labels[tg] : -1;
  load_rows<T, BR>(Rs, h, t0, Tn, D, vec_h);

  float m = kNegInf, l = 0.f, ll = 0.f;
  for (int v0 = 0; v0 < V; v0 += kBS) {
    __syncthreads();  // the previous tile's S and P are no longer read
    load_rows<T, kBS>(Ss, w, v0, V, D, vec_w);
    __syncthreads();
    score_tile<BR>(Rs, Ss, Part, P, D);
    float s[TS::CPL];
    float tmax = kNegInf;
#pragma unroll
    for (int j = 0; j < TS::CPL; ++j) {
      const int c = lane_c * TS::CPL + j, vg = v0 + c;
      s[j] = kNegInf;
      if (vg < V) {
        s[j] = P[row * kLdP + c] + (bias ? bias[vg] : 0.f);
        tmax = fmaxf(tmax, s[j]);
        if (label_hit(vg, label)) ll += s[j];
      }
    }
    lse_rescale(m, l, lanes_max<TS::LPR>(tmax));
    float part = 0.f;
#pragma unroll
    for (int j = 0; j < TS::CPL; ++j)
      if (v0 + lane_c * TS::CPL + j < V) part += expf(s[j] - m);
    l += lanes_sum<TS::LPR>(part);
  }
  ll = lanes_sum<TS::LPR>(ll);   // the hit is in one lane, the rest add 0
  if (lane_c == 0 && tg < Tn) {
    const float lse = finalize_lse(m, l);
    lse_out[tg] = lse;
    loss[tg] = lse - ll;
  }
}

template <typename T, int BR>
cudaError_t launch(const void* h, const void* w, const void* bias,
                   const void* labels, void* loss, void* lse, int Tn, int V,
                   int D, cudaStream_t stream) {
  const size_t smem = sizeof(float) * head_smem_floats<BR>(D);
  cudaError_t err = cudaFuncSetAttribute(
      head_fwd_kernel<T, BR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  head_fwd_kernel<T, BR><<<(Tn + BR - 1) / BR, kThreads, smem, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(w),
      static_cast<const float*>(bias), static_cast<const long long*>(labels),
      static_cast<float*>(loss), static_cast<float*>(lse), Tn, V, D,
      rows_vectorizable<T>(h, D), rows_vectorizable<T>(w, D));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* h, const void* w, const void* bias,
                     const void* labels, void* loss, void* lse, int Tn, int V,
                     int D, cudaStream_t s) {
  if (D <= 768)
    return launch<T, 32>(h, w, bias, labels, loss, lse, Tn, V, D, s);
  return launch<T, 16>(h, w, bias, labels, loss, lse, Tn, V, D, s);
}

}  // namespace

extern "C" int ptt_fused_head_max_d() { return kMaxD; }

// dtype: 0 = float32, 1 = bfloat16 (hidden (T, D) and weight (V, D), dense,
// row-major); bias: float32 (V,) or null; labels: int64 (T,). Writes loss
// and lse, float32 (T,). Returns a cudaError_t.
extern "C" int ptt_fused_head_fwd(const void* h, const void* w,
                                  const void* bias, const void* labels,
                                  void* loss, void* lse, int Tn, int V, int D,
                                  int dtype, void* stream) {
  if (Tn < 1 || V < 1 || D < 1 || D > kMaxD) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<float>(h, w, bias, labels, loss, lse, Tn, V, D, s);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(h, w, bias, labels, loss, lse, Tn, V, D,
                                   s);
  return (int)cudaErrorInvalidValue;
}
