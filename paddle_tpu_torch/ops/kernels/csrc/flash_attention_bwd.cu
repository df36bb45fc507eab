// Flash-attention backward for Hopper (sm_90a), plain C interface: two
// kernels, dK/dV and dQ.
//
// Replaces paddle_tpu/ops/pallas/flash_attention.py:_pallas_backward
// (kernel bodies _bwd_dkv_kernel and _bwd_dq_kernel, shared core
// _bwd_p_ds): from the forward's residual lse and delta = rowsum(dO * O),
// each key/query tile recomputes p = exp(s - lse) with s = q k^T * scale +
// mask and ds = p * (dO v^T - delta); then dV = p^T dO, dK = scale * ds^T q,
// dQ = scale * ds k. No (Tq, Tk) matrix reaches device memory. Same
// masks ("none", "k" (B,1,1,Tk), "qk" (B,1,Tq,Tk)) and bottom-right causal
// rule (query i sees keys j <= i + Tk - Tq) as the forward kernel.
//
// Rows that see no key (causal with Tq > Tk, rows i < Tq - Tk): the forward
// defines them as uniform over all Tk keys, and the reference's gradient of
// that (autodiff of its XLA attention) is dq = 0, no contribution to dk,
// and dv += dO / Tk. Recomputing p = exp(s - lse) cannot give that: in f32
// lse = -1e30 + log(Tk) rounds to -1e30, so p would come out 1. Both
// kernels therefore treat such a row explicitly: p = 1/Tk, ds = 0.
//
// What bounds it on the H100: per visible (query, key) pair the dK/dV
// kernel does 8*D flops (s, dp, dv, dk) and the dQ kernel 6*D (s, dp, dq),
// against reading q/k/v/dO once and writing dq/dk/dv once. At BERT-base
// training shapes (32 x 12 heads, T = 128, D = 64, f32) that is 1.4
// GFLOP, ~21 us at 67 TFLOP/s, against ~38 MB, ~11 us at 3.35 TB/s: the
// operations bound it. This first version computes in f32 on the CUDA cores
// (no tensor cores, no wgmma/TMA), so its ceiling is the 67 TFLOP/s f32
// rate; bf16 inputs are widened to f32 on load and accumulate in f32.
//
// Design: the TPU's two-kernel split, which needs no atomics. dK/dV: one
// 256-thread block owns a (b*h, 64-key tile); K and V stay in shared memory
// while a loop walks the 64-row query tiles (Q, dO staged in shared memory),
// and dK, dV accumulate in f32 registers (4 key rows x D/16 columns per
// thread). dQ: one block owns a (b*h, 64-query tile) and walks the key tiles,
// dQ accumulating in registers. In both, each thread computes a 4 x 4 patch
// of s and dp (a row's 16 lanes are one half-warp), writes p and ds to
// shared memory, and the block then multiplies them out. Every output
// element is summed by one thread in a fixed order, so two runs give equal
// bits. Tiles past the causal diagonal are skipped unless they hold a row
// that sees no key. Ragged Tq/Tk edges are masked in-kernel: out-of-range
// keys and queries are loaded as zeros, get p = ds = 0 and are never stored.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;
constexpr int kLd = kBlockK + 1;   // row stride of the p / ds tiles

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

struct Problem {
  int H, Tq, Tk;
  long long mask_stride_b;
  int mask_stride_q;
  float scale;
  int causal;
};

// rows x D tile of a (T, D) matrix into shared memory with row stride ld,
// widened to f32; rows at or past T are zeros.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          int row0, int T_) {
  for (int i = threadIdx.x; i < 64 * D; i += kThreads) {
    const int r = i / D, c = i % D, g = row0 + r;
    dst[r * ld + c] = g < T_ ? to_f32(src[(size_t)g * D + c]) : 0.f;
  }
}

// s = Q K^T and dp = dO V^T for the thread's 4 query rows x 4 keys, then
// p and ds into shared memory (Ps, dSs: [kBlockQ][kLd]). Qs, dOs have row
// stride D; Ks, Vs row stride D + 1.
template <int D>
__device__ __forceinline__ void p_ds_tile(
    const float* Qs, const float* dOs, const float* Ks, const float* Vs,
    float* Ps, float* dSs, int q0, int k0, const float* lse,
    const float* delta, const float* mb, const Problem& pr) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float s[4][4], dp[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[r][j] = dp[r][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qv[4], ov[4], kv[4], vv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      qv[r] = Qs[(ty * 4 + r) * D + d];
      ov[r] = dOs[(ty * 4 + r) * D + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      kv[j] = Ks[(tx + 16 * j) * (D + 1) + d];
      vv[j] = Vs[(tx + 16 * j) * (D + 1) + d];
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[r][j] = fmaf(qv[r], kv[j], s[r][j]);
        dp[r][j] = fmaf(ov[r], vv[j], dp[r][j]);
      }
  }
  const int offset = pr.Tk - pr.Tq;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qg = q0 + ty * 4 + r;
    const bool q_ok = qg < pr.Tq;
    const float l = q_ok ? lse[qg] : 0.f;
    const float dl = q_ok ? delta[qg] : 0.f;
    const bool no_key = pr.causal && qg + offset < 0;
    const float* mrow =
        mb ? mb + (size_t)min(qg, pr.Tq - 1) * pr.mask_stride_q : nullptr;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kg = k0 + tx + 16 * j;
      float p = 0.f, ds = 0.f;
      if (q_ok && kg < pr.Tk) {
        if (no_key) {
          p = 1.f / (float)pr.Tk;   // uniform row: dv only
        } else if (!(pr.causal && qg + offset < kg)) {
          float x = s[r][j] * pr.scale;
          if (mrow) x += mrow[kg];
          p = expf(x - l);
          ds = p * (dp[r][j] - dl);
        }
      }
      Ps[(ty * 4 + r) * kLd + tx + 16 * j] = p;
      dSs[(ty * 4 + r) * kLd + tx + 16 * j] = ds;
    }
  }
}

template <int D>
constexpr size_t dkv_smem_floats() {
  return 2 * kBlockK * (D + 1) + 2 * kBlockQ * D + 2 * kBlockQ * kLd;
}

template <int D>
constexpr size_t dq_smem_floats() {
  return 2 * kBlockQ * D + 2 * kBlockK * (D + 1) + kBlockQ * kLd;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const float* __restrict__ mask, T* __restrict__ dk,
                     T* __restrict__ dv, Problem pr) {
  constexpr int DC = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;                      // [kBlockK][D + 1]
  float* Vs = Ks + kBlockK * (D + 1);    // [kBlockK][D + 1]
  float* Qs = Vs + kBlockK * (D + 1);    // [kBlockQ][D]
  float* dOs = Qs + kBlockQ * D;         // [kBlockQ][D]
  float* Ps = dOs + kBlockQ * D;         // [kBlockQ][kLd]
  float* dSs = Ps + kBlockQ * kLd;       // [kBlockQ][kLd]

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kBlockK;
  const int offset = pr.Tk - pr.Tq;
  const T* qb = q + (size_t)bh * pr.Tq * D;
  const T* ob = dout + (size_t)bh * pr.Tq * D;
  const float* lb = lse + (size_t)bh * pr.Tq;
  const float* db = delta + (size_t)bh * pr.Tq;
  const float* mb =
      mask ? mask + (size_t)(bh / pr.H) * (size_t)pr.mask_stride_b : nullptr;

  load_tile<T, D>(Ks, D + 1, k + (size_t)bh * pr.Tk * D, k0, pr.Tk);
  load_tile<T, D>(Vs, D + 1, v + (size_t)bh * pr.Tk * D, k0, pr.Tk);

  float dk_acc[4][DC], dv_acc[4][DC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk_acc[r][c] = dv_acc[r][c] = 0.f;

  for (int q0 = 0; q0 < pr.Tq; q0 += kBlockQ) {
    // a query tile below this key tile's diagonal sees none of its keys,
    // unless it holds a row that sees no key at all (uniform: dv only)
    if (pr.causal && min(q0 + kBlockQ, pr.Tq) - 1 + offset < k0 &&
        q0 + offset >= 0)
      continue;
    __syncthreads();  // the previous tile's Q/dO/p/ds are no longer read
    load_tile<T, D>(Qs, D, qb, q0, pr.Tq);
    load_tile<T, D>(dOs, D, ob, q0, pr.Tq);
    __syncthreads();
    p_ds_tile<D>(Qs, dOs, Ks, Vs, Ps, dSs, q0, k0, lb, db, mb, pr);
    __syncthreads();
#pragma unroll 4
    for (int i = 0; i < kBlockQ; ++i) {
      float pv[4], sv[4], qv[DC], ov[DC];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        pv[r] = Ps[i * kLd + ty * 4 + r];
        sv[r] = dSs[i * kLd + ty * 4 + r];
      }
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        qv[c] = Qs[i * D + tx + 16 * c];
        ov[c] = dOs[i * D + tx + 16 * c];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          dv_acc[r][c] = fmaf(pv[r], ov[c], dv_acc[r][c]);
          dk_acc[r][c] = fmaf(sv[r], qv[c], dk_acc[r][c]);
        }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int kg = k0 + ty * 4 + r;
    if (kg >= pr.Tk) continue;
    T* dkrow = dk + ((size_t)bh * pr.Tk + kg) * D;
    T* dvrow = dv + ((size_t)bh * pr.Tk + kg) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      dkrow[tx + 16 * c] = from_f32<T>(pr.scale * dk_acc[r][c]);
      dvrow[tx + 16 * c] = from_f32<T>(dv_acc[r][c]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const float* __restrict__ mask, T* __restrict__ dq,
                    Problem pr) {
  constexpr int DC = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;                      // [kBlockQ][D]
  float* dOs = Qs + kBlockQ * D;         // [kBlockQ][D]
  float* Ks = dOs + kBlockQ * D;         // [kBlockK][D + 1]
  float* Vs = Ks + kBlockK * (D + 1);    // [kBlockK][D + 1]
  float* dSs = Vs + kBlockK * (D + 1);   // [kBlockQ][kLd]

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBlockQ;
  const int offset = pr.Tk - pr.Tq;
  const T* kb = k + (size_t)bh * pr.Tk * D;
  const T* vb = v + (size_t)bh * pr.Tk * D;
  const float* mb =
      mask ? mask + (size_t)(bh / pr.H) * (size_t)pr.mask_stride_b : nullptr;

  load_tile<T, D>(Qs, D, q + (size_t)bh * pr.Tq * D, q0, pr.Tq);
  load_tile<T, D>(dOs, D, dout + (size_t)bh * pr.Tq * D, q0, pr.Tq);

  float acc[4][DC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[r][c] = 0.f;

  // key tiles past the causal diagonal contribute nothing to dq (a row
  // that sees no key has ds = 0 everywhere)
  int k_end = pr.Tk;
  if (pr.causal) k_end = min(pr.Tk, min(q0 + kBlockQ, pr.Tq) + offset);

  for (int k0 = 0; k0 < k_end; k0 += kBlockK) {
    __syncthreads();  // the previous tile's K/V/ds are no longer read
    load_tile<T, D>(Ks, D + 1, kb, k0, pr.Tk);
    load_tile<T, D>(Vs, D + 1, vb, k0, pr.Tk);
    __syncthreads();
    // p goes to the same buffer as ds and is overwritten: dQ needs ds only
    p_ds_tile<D>(Qs, dOs, Ks, Vs, dSs, dSs, q0, k0,
                 lse + (size_t)bh * pr.Tq, delta + (size_t)bh * pr.Tq, mb,
                 pr);
    __syncwarp();  // a row's ds is written and read by the same 16 lanes
#pragma unroll 4
    for (int kk = 0; kk < kBlockK; ++kk) {
      float sv[4], kv[DC];
#pragma unroll
      for (int r = 0; r < 4; ++r) sv[r] = dSs[(ty * 4 + r) * kLd + kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) kv[c] = Ks[kk * (D + 1) + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[r][c] = fmaf(sv[r], kv[c], acc[r][c]);
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qg = q0 + ty * 4 + r;
    if (qg >= pr.Tq) continue;
    T* row = dq + ((size_t)bh * pr.Tq + qg) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) row[tx + 16 * c] = from_f32<T>(pr.scale * acc[r][c]);
  }
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       const void* mask, void* dk, void* dv, int B,
                       const Problem& pr, cudaStream_t stream) {
  const size_t smem = sizeof(float) * dkv_smem_floats<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((pr.Tk + kBlockK - 1) / kBlockK, B * pr.H);
  flash_bwd_dkv_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const float*>(mask), static_cast<T*>(dk),
      static_cast<T*>(dv), pr);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      const void* mask, void* dq, int B, const Problem& pr,
                      cudaStream_t stream) {
  const size_t smem = sizeof(float) * dq_smem_floats<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((pr.Tq + kBlockQ - 1) / kBlockQ, B * pr.H);
  flash_bwd_dq_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const float*>(mask), static_cast<T*>(dq), pr);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; q/k/v/dout/dk/dv in that dtype, dense
// (B, H, T, D). lse and delta are float32 (B, H, Tq); mask is float32 or
// null with the forward's strides (see ptt_flash_attention_fwd). Returns a
// cudaError_t.
extern "C" int ptt_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* mask, void* dk, void* dv,
    int B, int H, int Tq, int Tk, int D, int dtype, long long mask_stride_b,
    int mask_stride_q, float scale, int causal, void* stream) {
  const Problem pr{H, Tq, Tk, mask_stride_b, mask_stride_q, scale, causal};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return launch_dkv<float, 64>(q, k, v, dout, lse, delta, mask, dk, dv, B,
                                 pr, s);
  if (dtype == 0 && D == 128)
    return launch_dkv<float, 128>(q, k, v, dout, lse, delta, mask, dk, dv, B,
                                  pr, s);
  if (dtype == 1 && D == 64)
    return launch_dkv<__nv_bfloat16, 64>(q, k, v, dout, lse, delta, mask, dk,
                                         dv, B, pr, s);
  if (dtype == 1 && D == 128)
    return launch_dkv<__nv_bfloat16, 128>(q, k, v, dout, lse, delta, mask,
                                          dk, dv, B, pr, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int ptt_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* mask, void* dq, int B,
    int H, int Tq, int Tk, int D, int dtype, long long mask_stride_b,
    int mask_stride_q, float scale, int causal, void* stream) {
  const Problem pr{H, Tq, Tk, mask_stride_b, mask_stride_q, scale, causal};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return launch_dq<float, 64>(q, k, v, dout, lse, delta, mask, dq, B, pr, s);
  if (dtype == 0 && D == 128)
    return launch_dq<float, 128>(q, k, v, dout, lse, delta, mask, dq, B, pr,
                                 s);
  if (dtype == 1 && D == 64)
    return launch_dq<__nv_bfloat16, 64>(q, k, v, dout, lse, delta, mask, dq,
                                        B, pr, s);
  if (dtype == 1 && D == 128)
    return launch_dq<__nv_bfloat16, 128>(q, k, v, dout, lse, delta, mask, dq,
                                         B, pr, s);
  return (int)cudaErrorInvalidValue;
}
