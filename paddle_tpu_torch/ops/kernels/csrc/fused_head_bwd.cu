// Fused LM/MLM head backward for Hopper (sm_90a), plain C interface: two
// kernels, dhidden and dweight (+ dbias), each recomputing the score tiles
// from the forward's per-token logsumexp, so no (T, V) buffer exists.
//
// Replaces paddle_tpu/ops/pallas/blockwise_ce.py:_head_bwd (kernel bodies
// _head_dh_kernel and _head_dwb_kernel, shared core _p_ds): with
// s = h W^T + b and ds = (exp(s - lse) - onehot(label)) * dloss,
//   dhidden = ds W            (T, D)
//   dweight = ds^T h          (V, D), the tied table's own layout, so the
//                             embedding's two gradient contributions add
//                             without a transpose
//   dbias   = sum_t ds        (V,)
//
// What bounds it on the H100: each kernel recomputes s (2*T*D*V operations)
// and forms its product (another 2*T*D*V). At (T, D, V) = (8192, 768, 32000)
// f32 that is 805 GFLOP per kernel, 12.0 ms at the 67 TFLOP/s f32 rate,
// against ~0.2 GB of operands and outputs: the operations bound them. This
// first version runs f32 FFMA on the CUDA cores.
//
// Design: the TPU's two-kernel split, without atomics. dhidden: a 256-thread
// block owns BR tokens and walks the vocabulary's 32-row weight tiles in
// order; dweight: a block owns BR vocab rows and walks the 32-token hidden
// tiles in order. The two are one template: the block's own rows (R) stay
// in shared memory, the streamed tile (S) is loaded per step, the score tile
// P = R S^T is formed (blockwise_ce.cuh:score_tile), turned into ds in
// place, and the block adds ds S into a (BR, D) accumulator held in
// registers (a warp per BR/8 rows, a lane per 4 of every 128 columns, read
// from shared memory as float4; up to 96 f32 a thread at BR = 32, D <= 768;
// BR = 16 above that, D <= 1024). Tiles move in 16-byte pieces (cp.async
// for f32) when their rows allow (blockwise_ce.cuh:load_rows). Every output
// element is summed by one thread in tile order and dbias by a fixed
// shuffle tree, so two runs give equal bits. Ragged T, V and D are masked
// in-kernel; labels outside [0, V) hit no column.
#include "blockwise_ce.cuh"

namespace {

using namespace ptt_ce;

constexpr int kMaxD = 1024;

// The shared walk. kTokensResident: R holds hidden rows (dhidden); else R
// holds weight rows (dweight). DC4: accumulator float4 columns per lane
// (128 * DC4 >= D).
template <typename T, int BR, int DC4, bool kTokensResident>
__device__ __forceinline__ void head_bwd_walk(
    const T* __restrict__ h, const T* __restrict__ w,
    const float* __restrict__ bias, const long long* __restrict__ labels,
    const float* __restrict__ lse, const float* __restrict__ dloss,
    T* __restrict__ out, float* __restrict__ dbias, int Tn, int V, int D,
    bool vec_h, bool vec_w) {
  using TS = TileShape<BR>;
  extern __shared__ __align__(16) float smem[];
  const int ld = tile_ld(D), D4 = padded_d(D);
  float* Rs = smem;                           // [BR][ld] own rows
  float* Ss = Rs + (size_t)BR * ld;           // [kBS][ld] streamed rows
  float* Part = Ss + (size_t)kBS * ld;        // [KG][BR][kLdP]
  float* P = Part + (size_t)TS::KG * BR * kLdP;   // [BR][kLdP] s, then ds

  const int r0 = blockIdx.x * BR;
  const int n_own = kTokensResident ? Tn : V;
  const int n_streamed = kTokensResident ? V : Tn;
  load_rows<T, BR>(Rs, kTokensResident ? h : w, r0, n_own, D,
                   kTokensResident ? vec_h : vec_w);

  // the ds phase: lane_c's CPL columns of row `row` of P
  const int row = threadIdx.x / TS::LPR, lane_c = threadIdx.x % TS::LPR;
  const int own = r0 + row;
  const bool own_ok = own < n_own;
  // per own row: a token's label, lse and dloss, or a vocab row's bias
  long long own_label = -1;
  float own_lse = 0.f, own_dl = 0.f, own_bias = 0.f;
  if (own_ok) {
    if (kTokensResident) {
      own_label = labels[own];
      own_lse = lse[own];
      own_dl = dloss[own];
    } else if (bias) {
      own_bias = bias[own];
    }
  }
  float db_acc = 0.f;

  // the accumulate phase: rows ty*RT + r, columns 4*lane + 128*c + q
  const int ty = threadIdx.x >> 5, tx = threadIdx.x & 31;
  float4 acc[TS::RT][DC4];
#pragma unroll
  for (int r = 0; r < TS::RT; ++r)
#pragma unroll
    for (int c = 0; c < DC4; ++c) acc[r][c] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int k0 = 0; k0 < n_streamed; k0 += kBS) {
    __syncthreads();  // the previous tile's S and P are no longer read
    load_rows<T, kBS>(Ss, kTokensResident ? w : h, k0, n_streamed, D,
                      kTokensResident ? vec_w : vec_h);
    __syncthreads();
    score_tile<BR>(Rs, Ss, Part, P, D);
    float db_part = 0.f;
#pragma unroll
    for (int j = 0; j < TS::CPL; ++j) {
      const int c = lane_c * TS::CPL + j, kg = k0 + c;
      float ds = 0.f;
      if (own_ok && kg < n_streamed) {
        const float s = P[row * kLdP + c];
        if (kTokensResident) {
          ds = ce_ds(s + (bias ? bias[kg] : 0.f), own_lse, own_dl,
                     label_hit(kg, own_label));
        } else {
          ds = ce_ds(s + own_bias, lse[kg], dloss[kg],
                     label_hit(own, labels[kg]));
        }
      }
      P[row * kLdP + c] = ds;
      db_part += ds;
    }
    if (!kTokensResident) db_acc += lanes_sum<TS::LPR>(db_part);
    __syncthreads();
#pragma unroll 2
    for (int k = 0; k < kBS; ++k) {
      float a[TS::RT];
      float4 b[DC4];
#pragma unroll
      for (int r = 0; r < TS::RT; ++r) a[r] = P[(ty * TS::RT + r) * kLdP + k];
#pragma unroll
      for (int c = 0; c < DC4; ++c) {
        const int col = 4 * tx + 128 * c;
        b[c] = col < D4 ? *reinterpret_cast<const float4*>(Ss + k * ld + col)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int r = 0; r < TS::RT; ++r)
#pragma unroll
        for (int c = 0; c < DC4; ++c) {
          acc[r][c].x = fmaf(a[r], b[c].x, acc[r][c].x);
          acc[r][c].y = fmaf(a[r], b[c].y, acc[r][c].y);
          acc[r][c].z = fmaf(a[r], b[c].z, acc[r][c].z);
          acc[r][c].w = fmaf(a[r], b[c].w, acc[r][c].w);
        }
    }
  }

#pragma unroll
  for (int r = 0; r < TS::RT; ++r) {
    const int g = r0 + ty * TS::RT + r;
    if (g >= n_own) continue;
    T* orow = out + (size_t)g * D;
#pragma unroll
    for (int c = 0; c < DC4; ++c) {
      const int col = 4 * tx + 128 * c;
      const float v[4] = {acc[r][c].x, acc[r][c].y, acc[r][c].z, acc[r][c].w};
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (col + q < D) orow[col + q] = from_f32<T>(v[q]);
    }
  }
  if (!kTokensResident && lane_c == 0 && own_ok) dbias[own] = db_acc;
}

template <typename T, int BR, int DC4>
__global__ void __launch_bounds__(kThreads, 1)
head_dh_kernel(const T* __restrict__ h, const T* __restrict__ w,
               const float* __restrict__ bias,
               const long long* __restrict__ labels,
               const float* __restrict__ lse, const float* __restrict__ dloss,
               T* __restrict__ dh, int Tn, int V, int D, bool vec_h,
               bool vec_w) {
  head_bwd_walk<T, BR, DC4, true>(h, w, bias, labels, lse, dloss, dh,
                                  nullptr, Tn, V, D, vec_h, vec_w);
}

template <typename T, int BR, int DC4>
__global__ void __launch_bounds__(kThreads, 1)
head_dw_kernel(const T* __restrict__ h, const T* __restrict__ w,
               const float* __restrict__ bias,
               const long long* __restrict__ labels,
               const float* __restrict__ lse, const float* __restrict__ dloss,
               T* __restrict__ dw, float* __restrict__ dbias, int Tn, int V,
               int D, bool vec_h, bool vec_w) {
  head_bwd_walk<T, BR, DC4, false>(h, w, bias, labels, lse, dloss, dw, dbias,
                                   Tn, V, D, vec_h, vec_w);
}

struct Args {
  const void *h, *w, *bias, *labels, *lse, *dloss;
  void *out, *dbias;
  int Tn, V, D;
};

template <typename T, int BR, int DC4>
cudaError_t launch(const Args& a, bool dweight, cudaStream_t stream) {
  const size_t smem = sizeof(float) * head_smem_floats<BR>(a.D);
  const T* h = static_cast<const T*>(a.h);
  const T* w = static_cast<const T*>(a.w);
  const bool vh = rows_vectorizable<T>(a.h, a.D);
  const bool vw = rows_vectorizable<T>(a.w, a.D);
  const float* bias = static_cast<const float*>(a.bias);
  const long long* labels = static_cast<const long long*>(a.labels);
  const float* lse = static_cast<const float*>(a.lse);
  const float* dl = static_cast<const float*>(a.dloss);
  cudaError_t err;
  if (dweight) {
    err = cudaFuncSetAttribute(head_dw_kernel<T, BR, DC4>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    head_dw_kernel<T, BR, DC4><<<(a.V + BR - 1) / BR, kThreads, smem,
                                 stream>>>(
        h, w, bias, labels, lse, dl, static_cast<T*>(a.out),
        static_cast<float*>(a.dbias), a.Tn, a.V, a.D, vh, vw);
  } else {
    err = cudaFuncSetAttribute(head_dh_kernel<T, BR, DC4>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    head_dh_kernel<T, BR, DC4><<<(a.Tn + BR - 1) / BR, kThreads, smem,
                                 stream>>>(
        h, w, bias, labels, lse, dl, static_cast<T*>(a.out), a.Tn, a.V, a.D,
        vh, vw);
  }
  return cudaGetLastError();
}

// The accumulator's width follows D: 32 lanes x DC4 float4s cover it.
template <typename T>
cudaError_t launch_d(const Args& a, bool dweight, cudaStream_t s) {
  if (a.D <= 256) return launch<T, 32, 2>(a, dweight, s);
  if (a.D <= 512) return launch<T, 32, 4>(a, dweight, s);
  if (a.D <= 768) return launch<T, 32, 6>(a, dweight, s);
  return launch<T, 16, 8>(a, dweight, s);
}

int dispatch(const Args& a, int dtype, bool dweight, void* stream) {
  if (a.Tn < 1 || a.V < 1 || a.D < 1 || a.D > kMaxD)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_d<float>(a, dweight, s);
  if (dtype == 1) return (int)launch_d<__nv_bfloat16>(a, dweight, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (hidden, weight and the gradient written,
// dense row-major); bias: float32 (V,) or null; labels int64 (T,); lse and
// dloss float32 (T,). Returns a cudaError_t.
extern "C" int ptt_fused_head_dh(const void* h, const void* w,
                                 const void* bias, const void* labels,
                                 const void* lse, const void* dloss, void* dh,
                                 int Tn, int V, int D, int dtype,
                                 void* stream) {
  const Args a{h, w, bias, labels, lse, dloss, dh, nullptr, Tn, V, D};
  return dispatch(a, dtype, false, stream);
}

// As ptt_fused_head_dh; writes dw (V, D) in the weight's dtype and dbias
// float32 (V,).
extern "C" int ptt_fused_head_dw(const void* h, const void* w,
                                 const void* bias, const void* labels,
                                 const void* lse, const void* dloss, void* dw,
                                 void* dbias, int Tn, int V, int D, int dtype,
                                 void* stream) {
  const Args a{h, w, bias, labels, lse, dloss, dw, dbias, Tn, V, D};
  return dispatch(a, dtype, true, stream);
}
