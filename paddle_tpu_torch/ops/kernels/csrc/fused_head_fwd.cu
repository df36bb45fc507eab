// Fused LM/MLM head forward for Hopper (sm_90a), plain C interface:
// hidden (T, D) @ weight^T (+ bias) -> per-token softmax cross-entropy
// loss (T,) and logsumexp (T,), without a (T, V) logits buffer.
//
// Replaces paddle_tpu/ops/pallas/blockwise_ce.py:_head_call_fwd (kernel
// body _head_fwd_kernel). The weight is the tied (V, D) embedding table,
// read as stored: the JAX op transposes it to (D, V) before its kernel
// (paddle_tpu/ops/nn_ops.py:434); here both h W^T operands are K-major as
// stored, which is what tf32 wgmma takes.
//
// What bounds it on the H100: 2*T*D*V operations against reading hidden and
// weight once. At GPT-base's head (T, D, V) = (8192, 768, 32000) in f32 that
// is 402.7 GFLOP, 2.44 ms at the 165 TFLOP/s of f32-accurate tensor-core
// work (3xTF32: 495 TFLOP/s over three), against 124 MB, 0.04 ms at 3.35
// TB/s: the operations bound it. The score tiles come from wgmma
// (wgmma_sm90.cuh); f32 keeps f32 accuracy by 3xTF32 (hi = tf32(x), lo =
// tf32(x - hi); lo*hi + hi*lo + hi*hi, never one tf32 pass), bf16
// multiplies exactly into f32 sums.
//
// Design, three launches on the caller's stream:
//   1. planes_kernel splits hidden and weight once into operand planes in
//      the caller's scratch: f32 as tf32 hi and lo planes, bf16 copied; rows
//      padded to whole tiles and D to whole 128-byte K-blocks with zeros, so
//      the main loop has no ragged edge along D and no split in it.
//   2. head_fwd_kernel: a block of two consumer warpgroups owns 128 tokens
//      (64 each) and walks its share of the vocabulary in 128-row tiles;
//      every (tile, K-block) step brings both operands' plane chunks by
//      cp.async into a ring of stages (three f32, four bf16) whose copies
//      run while the previous steps' wgmma run. A score is a few partial
//      sums, one per 128-column chunk of D, each from a fresh accumulator
//      (the tensor cores truncate their f32 sums: short chains, joined by
//      ordinary f32 adds). The bias, the online logsumexp and the label
//      logit are folded in from the accumulator's registers; a row is
//      shared by four lanes.
//   3. The vocabulary is split across blocks (T = 8192 makes only 64 token
//      blocks for 132 SMs), the split chosen so that the blocks fill whole
//      waves: each block writes its tokens' partial (m, l, label logit),
//      and merge_kernel joins the splits in a fixed order into lse and
//      loss. No atomics: the same inputs give the same bits.
// On the H100 the main loop runs near the rate at which L2 feeds the
// blocks (each token block streams all of W's planes: 25 GB a call at
// GPT-base's f32 head), above the operations' bound.
// A label outside [0, V) (an ignore_index of -100) hits no column. D runs to
// 1024 (kMaxD).
// Launch config (ops/kernel_dispatch.py picks it per call site from a
// sweep's verdict): the ring's stages, each its own instance: f32 2 or 3
// (64 KB a stage), bf16 3 or 4 (32 KB); 0 keeps the default, three f32
// and four bf16. The stages change when a copy is issued, never a sum.
#include "blockwise_ce.cuh"
#include "wgmma_sm90.cuh"

namespace {

using namespace ptt_ce;
namespace wg = ptt_wgmma;

constexpr int kMaxD = 1024;
constexpr int kBM = 128;            // tokens a block
constexpr int kBN = 128;            // vocabulary rows a tile
constexpr int kHeadThreads = 256;   // two consumer warpgroups
constexpr int kChunk = 128;         // D columns a chain
constexpr int kRow = wg::kSwizzleBytes;

template <typename T, int S = sizeof(T) == 4 ? 3 : 4>
struct Cfg {
  static constexpr bool kF32 = sizeof(T) == 4;
  static constexpr int kPlanes = kF32 ? 2 : 1;        // hi, lo | bf16
  static constexpr int kKE = kRow / sizeof(T);         // D a K-block
  static constexpr int kBPC = kChunk / kKE;            // K-blocks a chain
  static constexpr int kStages = S;
  static constexpr int kPlaneBytes = kBM * kRow;       // == kBN * kRow
  static constexpr int kStageBytes = 2 * kPlanes * kPlaneBytes;
  static constexpr int kSmem = kStages * kStageBytes + wg::kAtomBytes;
};

__host__ __device__ inline int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// hidden or weight (n, D) -> planes (n_pad, Dp), zero-padded: f32 as tf32
// hi and lo, bf16 copied
template <typename T>
__global__ void planes_kernel(const T* __restrict__ x, int n, int D,
                              int n_pad, int Dp, T* __restrict__ hi,
                              T* __restrict__ lo) {
  const long long total = (long long)n_pad * Dp;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const int r = (int)(i / Dp), c = (int)(i % Dp);
    const T v = r < n && c < D ? x[(size_t)r * D + c] : T(0.f);
    if constexpr (Cfg<T>::kF32) {
      uint32_t h, l;
      ptt_mma::split(v, h, l);
      hi[i] = __uint_as_float(h);
      lo[i] = __uint_as_float(l);
    } else {
      hi[i] = v;
    }
  }
}

struct HeadArgs {
  const char* h[2];     // hidden planes (Tp, Dp)
  const char* w[2];     // weight planes (Vp, Dp)
  const float* bias;
  const long long* labels;
  float* part;          // (splits, Tp, 3): m, l, label logit
  int Tn, V, Tp, row_bytes, tiles, tiles_per_split;
};

template <typename T, int S>
__global__ void __launch_bounds__(kHeadThreads, 1)
head_fwd_kernel(const HeadArgs a) {
  using C = Cfg<T, S>;
  extern __shared__ char smem_raw[];
  char* smem = wg::align_atom(smem_raw);
  const int tid = threadIdx.x;
  const int wgi = tid / 128, warp = (tid & 127) / 32;
  const int g = (tid & 31) / 4, q = tid & 3;
  const int t0 = blockIdx.x * kBM;
  const int tile0 = blockIdx.y * a.tiles_per_split;
  const int n_tiles = min(a.tiles, tile0 + a.tiles_per_split) - tile0;
  const int nkb = a.row_bytes / kRow;
  const int steps = n_tiles * nkb;

  // stage s: [hidden planes][weight planes], each kBM (= kBN) rows x 128 B
  auto plane = [&](int stage, int op, int p) {
    return smem + stage * C::kStageBytes +
           (op * C::kPlanes + p) * C::kPlaneBytes;
  };
  auto load = [&](int i) {      // (tile, K-block) step i into its stage
    if (i < steps) {
      const int stage = i % C::kStages, kb = i % nkb;
      const size_t row0[2] = {(size_t)t0, (size_t)(tile0 + i / nkb) * kBN};
#pragma unroll
      for (int op = 0; op < 2; ++op)
#pragma unroll
        for (int p = 0; p < C::kPlanes; ++p) {
          const char* src = (op ? a.w[p] : a.h[p]) + kb * kRow;
          char* dst = plane(stage, op, p);
#pragma unroll
          for (int j = 0; j < kBM * 8 / kHeadThreads; ++j) {
            const int id = tid + kHeadThreads * j, r = id / 8, c = id % 8;
            ptt_mma::cp_async16(
                dst + r * kRow + ((c ^ (r & 7)) << 4),
                src + (row0[op] + r) * a.row_bytes + (c << 4), true);
          }
        }
    }
    ptt_mma::cp_async_commit();
  };

  const int r0 = 64 * wgi + 16 * warp + g;     // this lane's rows r0, r0 + 8
  long long label[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = t0 + r0 + 8 * h;
    label[h] = t < a.Tn ? a.labels[t] : -1;
  }
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, ll[2] = {0.f, 0.f};
  float acc[kBN / 2], sum[kBN / 2];
#pragma unroll
  for (int e = 0; e < kBN / 2; ++e) acc[e] = 0.f;

#pragma unroll
  for (int i = 0; i < C::kStages - 1; ++i) load(i);
  for (int i = 0; i < steps; ++i) {
    ptt_mma::cp_async_wait<C::kStages - 2>();
    wg::fence_proxy_async();
    __syncthreads();   // step i's stage is in; step i - 1's wgmma are done
    const int stage = i % C::kStages, kb = i % nkb;
    const char* hs = plane(stage, 0, 0) + wgi * 64 * kRow;
    const char* ws = plane(stage, 1, 0);
    wg::fence();
#pragma unroll
    for (int s = 0; s < kRow / 32; ++s) {
      const int first = kb % C::kBPC == 0 && s == 0;
      const uint64_t dh = wg::desc_k(hs, kBM, 32 * s);
      const uint64_t dw = wg::desc_k(ws, kBN, 32 * s);
      if constexpr (C::kF32) {
        const uint64_t dhl = wg::desc_k(hs + C::kPlaneBytes, kBM, 32 * s);
        const uint64_t dwl = wg::desc_k(ws + C::kPlaneBytes, kBN, 32 * s);
        wg::mma_tf32_ss<kBN>(acc, dhl, dw, !first);
        wg::mma_tf32_ss<kBN>(acc, dh, dwl, 1);
        wg::mma_tf32_ss<kBN>(acc, dh, dw, 1);
      } else {
        wg::mma_bf16_ss<kBN>(acc, dh, dw, !first);
      }
    }
    wg::commit();
    load(i + C::kStages - 1);   // into the stage step i - 1 read
    wg::wait<0>();
    wg::fence_operand(acc);
    const bool chain_end = kb % C::kBPC == C::kBPC - 1 || kb == nkb - 1;
    if (chain_end) {
      if (kb < C::kBPC) {
#pragma unroll
        for (int e = 0; e < kBN / 2; ++e) sum[e] = acc[e];
      } else {
#pragma unroll
        for (int e = 0; e < kBN / 2; ++e) sum[e] += acc[e];
      }
    }
    if (kb != nkb - 1) continue;

    // a finished (128 x 128) score tile: bias, label, online logsumexp
    const int v0 = (tile0 + i / nkb) * kBN;
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int e = 0; e < kBN / 2; ++e) {
      const int h = (e >> 1) & 1;
      const int col = v0 + 8 * (e >> 2) + 2 * q + (e & 1);
      float x = -INFINITY;        // out-of-range column: probability 0
      if (col < a.V) {
        x = sum[e] + (a.bias ? a.bias[col] : 0.f);
        if (label_hit(col, label[h])) ll[h] += x;
      }
      sum[e] = x;
      tmax[h] = fmaxf(tmax[h], x);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) lse_rescale(m[h], l[h], lanes_max<4>(tmax[h]));
#pragma unroll
    for (int e = 0; e < kBN / 2; ++e) {
      const int h = (e >> 1) & 1;
      l[h] += expf(sum[e] - m[h]);
    }
  }
  ptt_mma::cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float lt = lanes_sum<4>(l[h]);
    const float lab = lanes_sum<4>(ll[h]);   // the hit is in one lane
    const int t = t0 + r0 + 8 * h;
    if (q == 0 && t < a.Tn) {
      float* p = a.part + ((size_t)blockIdx.y * a.Tp + t) * 3;
      p[0] = m[h];
      p[1] = lt;
      p[2] = lab;
    }
  }
}

// lse and loss of each token from its splits' partials, in split order
__global__ void merge_kernel(const float* __restrict__ part, int splits,
                             int Tn, int Tp, float* __restrict__ loss,
                             float* __restrict__ lse) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= Tn) return;
  float m = kNegInf, l = 0.f, ll = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float* p = part + ((size_t)s * Tp + t) * 3;
    lse_merge(m, l, p[0], p[1]);
    ll += p[2];
  }
  const float x = finalize_lse(m, l);
  lse[t] = x;
  loss[t] = x - ll;
}

// The work of one launch: padded extents, the vocabulary split, the
// scratch layout.
struct Plan {
  int Tp, Vp, Dp, tiles, splits, tiles_per_split, planes;
  size_t h_plane, w_plane, part;   // bytes of one plane / the partials
  size_t bytes() const { return (h_plane + w_plane) * planes + part; }
};

Plan plan(int Tn, int V, int D, int dtype) {
  Plan p;
  const int el = dtype == 0 ? 4 : 2;
  p.planes = dtype == 0 ? 2 : 1;
  p.Tp = round_up(Tn, kBM);
  p.Vp = round_up(V, kBN);
  p.Dp = round_up(D, kRow / el);
  p.tiles = p.Vp / kBN;
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // one block an SM: the fewest tile-steps on the busiest SM, then the
  // fewest splits
  const int blocks_t = p.Tp / kBM;
  long long best = -1;
  for (int s = 1; s <= min(p.tiles, 256); ++s) {
    const int per = (p.tiles + s - 1) / s;
    const int used = (p.tiles + per - 1) / per;
    const long long waves = ((long long)blocks_t * used + sms - 1) / sms;
    const long long cost = waves * per;
    if (best < 0 || cost < best) {
      best = cost;
      p.splits = used;
      p.tiles_per_split = per;
    }
  }
  p.h_plane = (size_t)p.Tp * p.Dp * el;
  p.w_plane = (size_t)p.Vp * p.Dp * el;
  p.part = (size_t)p.splits * p.Tp * 3 * sizeof(float);
  return p;
}

template <typename T, int S>
cudaError_t launch(const void* h, const void* w, const void* bias,
                   const void* labels, void* loss, void* lse, int Tn, int V,
                   int D, void* scratch, cudaStream_t stream) {
  const Plan p = plan(Tn, V, D, Cfg<T>::kF32 ? 0 : 1);
  char* s = static_cast<char*>(scratch);
  HeadArgs a;
  a.h[0] = s;
  a.h[1] = s + p.h_plane;
  a.w[0] = s + p.h_plane * p.planes;
  a.w[1] = a.w[0] + p.w_plane;
  a.part = reinterpret_cast<float*>(s + (p.h_plane + p.w_plane) * p.planes);
  planes_kernel<T><<<1024, 256, 0, stream>>>(
      static_cast<const T*>(h), Tn, D, p.Tp, p.Dp,
      reinterpret_cast<T*>(const_cast<char*>(a.h[0])),
      reinterpret_cast<T*>(const_cast<char*>(a.h[1])));
  planes_kernel<T><<<2048, 256, 0, stream>>>(
      static_cast<const T*>(w), V, D, p.Vp, p.Dp,
      reinterpret_cast<T*>(const_cast<char*>(a.w[0])),
      reinterpret_cast<T*>(const_cast<char*>(a.w[1])));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  a.bias = static_cast<const float*>(bias);
  a.labels = static_cast<const long long*>(labels);
  a.Tn = Tn;
  a.V = V;
  a.Tp = p.Tp;
  a.row_bytes = p.Dp * (int)sizeof(T);
  a.tiles = p.tiles;
  a.tiles_per_split = p.tiles_per_split;
  err = cudaFuncSetAttribute(head_fwd_kernel<T, S>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Cfg<T, S>::kSmem);
  if (err != cudaSuccess) return err;
  head_fwd_kernel<T, S><<<dim3(p.Tp / kBM, p.splits), kHeadThreads,
                          Cfg<T, S>::kSmem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  merge_kernel<<<(Tn + 255) / 256, 256, 0, stream>>>(
      a.part, p.splits, Tn, p.Tp, static_cast<float*>(loss),
      static_cast<float*>(lse));
  return cudaGetLastError();
}

}  // namespace

extern "C" int ptt_fused_head_max_d() { return kMaxD; }

// Bytes of scratch ptt_fused_head_fwd needs for these extents (operand
// planes and the splits' partials), on the current device.
extern "C" long long ptt_fused_head_fwd_scratch_bytes(int Tn, int V, int D,
                                                      int dtype) {
  if (Tn < 1 || V < 1 || D < 1 || D > kMaxD) return -1;
  return (long long)plan(Tn, V, D, dtype).bytes();
}

// dtype: 0 = float32, 1 = bfloat16 (hidden (T, D) and weight (V, D), dense,
// row-major); bias: float32 (V,) or null; labels: int64 (T,); scratch: at
// least ptt_fused_head_fwd_scratch_bytes, 16-byte aligned; stages: the
// ring's (f32 2 or 3, bf16 3 or 4; 0 the default). Writes loss and lse,
// float32 (T,). Returns a cudaError_t.
extern "C" int ptt_fused_head_fwd(const void* h, const void* w,
                                  const void* bias, const void* labels,
                                  void* loss, void* lse, int Tn, int V, int D,
                                  int dtype, int stages, void* scratch,
                                  void* stream) {
  if (Tn < 1 || V < 1 || D < 1 || D > kMaxD) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using BF = __nv_bfloat16;
  if (dtype == 0) {
    switch (stages) {
      case 2: return launch<float, 2>(h, w, bias, labels, loss, lse, Tn, V,
                                      D, scratch, s);
      case 0:
      case 3: return launch<float, 3>(h, w, bias, labels, loss, lse, Tn, V,
                                      D, scratch, s);
    }
  } else if (dtype == 1) {
    switch (stages) {
      case 3: return launch<BF, 3>(h, w, bias, labels, loss, lse, Tn, V, D,
                                   scratch, s);
      case 0:
      case 4: return launch<BF, 4>(h, w, bias, labels, loss, lse, Tn, V, D,
                                   scratch, s);
    }
  }
  return (int)cudaErrorInvalidValue;
}
