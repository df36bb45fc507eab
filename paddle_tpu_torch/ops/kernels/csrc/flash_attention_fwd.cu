// Flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces paddle_tpu/ops/pallas/flash_attention.py:_pallas_forward
// (kernel body _fwd_kernel): out = softmax(q k^T * scale + mask) v with
// the logsumexp residual lse, online softmax over key tiles, additive mask
// "none" / "k" (B,1,1,Tk) / "qk" (B,1,Tq,Tk), bottom-right causal
// (query i sees keys j <= i + Tk - Tq), masked logits filled with the
// same finite -1e30 as the TPU kernel.
//
// What bounds it on the H100: the work is 4*Tq*Tk*D flops per (batch,
// head) against reading q/k/v and writing out once. At BERT-base shapes
// (8 x 12 heads, Tq = Tk = 512, D = 64, f32) that is 6.44 GFLOP, ~96 us at
// 67 TFLOP/s, against ~50 MB, ~15 us at 3.35 TB/s: the operations bound
// it. This first version
// computes in f32 on the CUDA cores (no tensor cores, no wgmma/TMA), so its
// ceiling is the 67 TFLOP/s f32 rate; bf16 inputs are widened to f32 on
// load and accumulate in f32.
//
// Design: one thread block per (b*h, 64-row query tile). A loop inside the
// block walks the 64-key tiles (the TPU grid's sequential k axis). Q stays
// in shared memory for the whole loop; each K/V tile is staged in shared
// memory, widened to f32; the running max, running sum and the output
// accumulator stay in f32 registers. Each of the 256 threads owns 4 query
// rows x 4 key columns of the score tile and 4 rows x D/16 columns of the
// output, so a row's softmax statistics reduce across 16 lanes of one warp
// with shuffles. Key tiles above the causal diagonal are skipped unless the
// query tile holds a row that sees no key at all (causal with Tq > Tk):
// those rows need every key to come out uniform, as the reference defines
// them. Ragged Tq/Tk edges are masked in-kernel: out-of-range keys get
// probability 0, out-of-range query rows are computed on zeros and never
// stored.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;  // paddle_tpu's _NEG_INF

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

__device__ __forceinline__ float row_max16(float v) {
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float row_sum16(float v) {
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kBlockQ * D + kBlockK * (D + 1) + kBlockK * D +
                          kBlockQ * (kBlockK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ mask,
                 T* __restrict__ out, float* __restrict__ lse, int H, int Tq,
                 int Tk, long long mask_stride_b, int mask_stride_q,
                 float scale, int causal) {
  constexpr int DC = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                     // [kBlockQ][D]
  float* Ks = Qs + kBlockQ * D;         // [kBlockK][D + 1]
  float* Vs = Ks + kBlockK * (D + 1);   // [kBlockK][D]
  float* Ps = Vs + kBlockK * D;         // [kBlockQ][kBlockK + 1]

  const int tid = threadIdx.x;
  const int tx = tid & 15;   // column group within the row's 16 lanes
  const int ty = tid >> 4;   // owns query rows ty*4 .. ty*4+3
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBlockQ;
  const int offset = Tk - Tq;
  const T* qb = q + (size_t)bh * Tq * D;
  const T* kb = k + (size_t)bh * Tk * D;
  const T* vb = v + (size_t)bh * Tk * D;
  const float* mb =
      mask ? mask + (size_t)(bh / H) * (size_t)mask_stride_b : nullptr;

  for (int i = tid; i < kBlockQ * D; i += kThreads) {
    const int qg = q0 + i / D;
    Qs[i] = qg < Tq ? to_f32(qb[(size_t)qg * D + i % D]) : 0.f;
  }

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[r][c] = 0.f;
  }

  // key tiles past the causal diagonal contribute nothing — unless a row of
  // this tile sees no key at all (q0 + offset < 0)
  const int q_last = min(q0 + kBlockQ, Tq) - 1;
  int k_end = Tk;
  if (causal && q0 + offset >= 0) k_end = min(Tk, q_last + offset + 1);

  for (int k0 = 0; k0 < k_end; k0 += kBlockK) {
    __syncthreads();  // the previous tile's K/V are no longer read
    for (int i = tid; i < kBlockK * D; i += kThreads) {
      const int r = i / D, c = i % D, kg = k0 + r;
      float kv = 0.f, vv = 0.f;
      if (kg < Tk) {
        kv = to_f32(kb[(size_t)kg * D + c]);
        vv = to_f32(vb[(size_t)kg * D + c]);
      }
      Ks[r * (D + 1) + c] = kv;
      Vs[r * D + c] = vv;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[r][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) qv[r] = Qs[(ty * 4 + r) * D + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[r][j] = fmaf(qv[r], kv[j], s[r][j]);
    }

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qg = q0 + ty * 4 + r;
      const float* mrow =
          mb ? mb + (size_t)min(qg, Tq - 1) * mask_stride_q : nullptr;
      float mblk = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kg = k0 + tx + 16 * j;
        float x = -INFINITY;  // out-of-range key: probability exactly 0
        if (kg < Tk) {
          x = s[r][j] * scale;
          if (mrow) x += mrow[kg];
          if (causal && qg + offset < kg) x = kNegInf;
        }
        s[r][j] = x;
        mblk = fmaxf(mblk, x);
      }
      const float m_new = fmaxf(m[r], row_max16(mblk));
      const float corr = expf(m[r] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[r][j] - m_new);
        Ps[(ty * 4 + r) * (kBlockK + 1) + tx + 16 * j] = p;
        psum += p;
      }
      l[r] = corr * l[r] + row_sum16(psum);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[r][c] *= corr;
    }
    __syncwarp();  // a row's P is written and read by the same 16 lanes

#pragma unroll 4
    for (int kk = 0; kk < kBlockK; ++kk) {
      float pv[4], vv[DC];
#pragma unroll
      for (int r = 0; r < 4; ++r) pv[r] = Ps[(ty * 4 + r) * (kBlockK + 1) + kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) vv[c] = Vs[kk * D + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[r][c] = fmaf(pv[r], vv[c], acc[r][c]);
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qg = q0 + ty * 4 + r;
    if (qg >= Tq) continue;
    const float lc = fmaxf(l[r], 1e-30f);
    T* orow = out + ((size_t)bh * Tq + qg) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) orow[tx + 16 * c] = from_f32<T>(acc[r][c] / lc);
    if (tx == 0) lse[(size_t)bh * Tq + qg] = m[r] + logf(lc);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* mask, void* out, void* lse, int B, int H,
                   int Tq, int Tk, long long mask_stride_b, int mask_stride_q,
                   float scale, int causal, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Tq + kBlockQ - 1) / kBlockQ, B * H);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(mask),
      static_cast<T*>(out), static_cast<float*>(lse), H, Tq, Tk,
      mask_stride_b, mask_stride_q, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. mask is float32 or null; its element
// for (batch b, query i, key j) is mask[b * mask_stride_b + i *
// mask_stride_q + j] (mask_stride_q = 0 for a (B,1,1,Tk) key mask,
// mask_stride_b = 0 for a mask shared by the batch). Returns a cudaError_t.
extern "C" int ptt_flash_attention_fwd(const void* q, const void* k,
                                       const void* v, const void* mask,
                                       void* out, void* lse, int B, int H,
                                       int Tq, int Tk, int D, int dtype,
                                       long long mask_stride_b,
                                       int mask_stride_q, float scale,
                                       int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return launch<float, 64>(q, k, v, mask, out, lse, B, H, Tq, Tk,
                             mask_stride_b, mask_stride_q, scale, causal, s);
  if (dtype == 0 && D == 128)
    return launch<float, 128>(q, k, v, mask, out, lse, B, H, Tq, Tk,
                              mask_stride_b, mask_stride_q, scale, causal, s);
  if (dtype == 1 && D == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, mask, out, lse, B, H, Tq, Tk,
                                     mask_stride_b, mask_stride_q, scale,
                                     causal, s);
  if (dtype == 1 && D == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, mask, out, lse, B, H, Tq, Tk,
                                      mask_stride_b, mask_stride_q, scale,
                                      causal, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* ptt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
