// Fused LM/MLM head backward for Hopper (sm_90a), plain C interface: two
// kernels, dhidden and dweight (+ dbias), on the tensor cores, each
// recomputing the score tiles from the forward's per-token logsumexp, so no
// (T, V) buffer exists.
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
// that is 805 GFLOP per kernel against ~0.2 GB of operands and outputs: the
// operations bound it, 4.88 ms at the 165 TFLOP/s of f32-accurate
// tensor-core work (3xTF32: the dense TF32 rate, 495 TFLOP/s, over three)
// and 0.81 ms at 989 TFLOP/s in bf16.
//
// Design, against that bound (the two kernels are one template,
// head_bwd_walk: dhidden owns BR tokens and streams the vocabulary's weight
// rows, dweight owns BR vocab rows and streams the tokens' hidden rows):
// - Both products are warp-level mma.sync with f32 accumulation
//   (mma_sm90.cuh): m16n8k8 tf32 as 3xTF32 for f32 operands (hi = tf32(x),
//   lo = tf32(x - hi) by integer rounding, lo*hi + hi*lo + hi*hi; ds is
//   split the same way; never single-pass TF32), m16n8k16 bf16 for bf16
//   operands, whose tiles stay bf16 in shared memory. bf16: ds enters the
//   second product as a bf16 pair, hi = bf16(ds) and lo = bf16(ds - hi),
//   two mma a k-step, every sum f32: ds then carries a relative error of
//   2^-16, far below the bf16 rounding of the output (2^-8 of its value).
//   ds rounded to one bf16 would add up to 2^-8 of the largest term: a
//   vocabulary row's dweight is a few label tokens' -dloss * h, so the two
//   roundings together could reach the 2^-7 the gradients are held to.
//   dbias sums the f32 ds.
// - Eight warps split D, not the rows: warp w owns columns [w*CW, (w+1)*CW)
//   of D (CW = 96 at D <= 768). In the score product those columns are its
//   share of the sum over D: it multiplies the (BR, CW) slice of the own
//   rows by the (BS, CW) slice of the streamed tile into a (BR, BS) partial
//   score tile, a chain of CW/8 k-steps from zero. In the second product the
//   same columns are its share of the output: acc(BR, CW) += ds(BR, BS) x
//   streamed(BS, CW), held in registers (96 f32 a thread at BR = 32,
//   CW = 96). A warp so only ever reads its own column slice of both tiles:
//   it copies that slice itself (16-byte cp.async, two stages, the copy of
//   the tile after next started as soon as the warp is done with a stage) and
//   needs no block barrier for the tiles, only __syncwarp.
// - The eight partial score tiles meet in shared memory (the one exchange a
//   tile needs): after a barrier each thread adds the eight partials of its
//   BR*BS/256 scores in warp order with ordinary f32 adds, forms ds from the
//   label / lse / dloss / bias of that row and column (the streamed side's
//   values were fetched into registers before the score product), and
//   writes ds back as tf32 hi and lo planes (bf16: bf16 hi and lo): ds is
//   split once for all warps, and enters the second product as A fragments
//   with 8-byte loads. A second barrier, then the second product.
// - Short mma chains, f32 adds between them: the tensor cores round each
//   mma's f32 sum toward zero, a bias that grows with the chain. A score is
//   8 chains of 36 mma (3 x CW/8) joined by f32 adds; a tile's contribution
//   to acc is summed from zero (3 x BS/8 mma) and added to the running sum
//   with an f32 add. The sums over V = 32000 (dhidden) and T = 8192
//   (dweight) are therefore ordinary f32 sums of 2000 and 512 terms.
// - Tiles: f32 BR = 32 own rows (98.8 KB at D = 768) and two stages of
//   BS = 16 streamed rows (49.4 KB each); the partial tiles 24.6 KB and the
//   ds planes 6.1 KB: 228,352 of the 232,448 bytes a block may use, one
//   256-thread block an SM. Splitting happens at fragment load (no
//   room for hi/lo planes of the tiles). bf16: BR = 32, BS = 32, 195 KB.
//   D in (768, 1024]: BR = 16, CW = 128. Row strides are padded by 16 bytes
//   (partial and ds tiles by 8 elements), which makes every fragment load
//   and store conflict-free. D is padded to 8 * CW with zeros in shared
//   memory; rows whose start is not on 16 bytes (D not a multiple of 4 in
//   f32, 8 in bf16) are copied element by element instead.
// - No atomics: every output element is summed by one thread in tile order
//   and dbias by a fixed shuffle tree, so two runs give equal bits. Ragged
//   T, V and D are masked in-kernel; labels outside [0, V) hit no column
//   and are never an address.
// - What is left (PERF.md has the numbers): with operands in registers
//   mma.sync itself reaches 320 TFLOP/s in tf32 and 640 in bf16 on this card
//   (tools/mma_sync_rate.cu), two thirds of the wgmma rates the bound is
//   taken at, and nothing runs beside it: the same tool shows the mma
//   rate falling by a third with three integer operations next to each
//   mma, so a warp's other work (the five ALU operations of each split,
//   the fragment loads) adds to the mma time at the scheduler; sixteen
//   warps a block (two groups of eight, half the own rows each) were no
//   faster than eight. wgmma, which is asynchronous, is the next step. A
//   dhidden block streams the whole vocabulary, so T below 132 * 32
//   tokens leaves SMs idle.
//
// ptxas (sm_90a, nvcc -O3), registers a thread at D <= 768 as chip_smoke.py's
// build phase prints them: f32 dhidden 248, dweight 250; bf16 253 / 252; no
// spills in any instantiation.
#include "blockwise_ce.cuh"
#include "mma_sm90.cuh"

namespace {

using namespace ptt_ce;
using namespace ptt_mma;

constexpr int kMaxD = 1024;
constexpr int kWarps = kThreads / 32;

// MT: 16-row mma tiles of own rows; NT: 8-column tiles of D a warp owns.
template <typename T, int MT, int NT>
struct Cfg {
  static constexpr bool F32 = sizeof(T) == 4;
  static constexpr int BR = 16 * MT;                 // own rows
  static constexpr int BS = F32 ? 16 : 32;           // streamed rows a tile
  static constexpr int KS = F32 ? 8 : 16;            // mma depth
  static constexpr int CW = 8 * NT;                  // columns of D a warp
  static constexpr int DP = kWarps * CW;             // D padded
  static constexpr int LD = DP + 16 / (int)sizeof(T);   // tile row stride
  static constexpr int LDP = BS + 8;       // partial / ds tile row stride
  static constexpr int NB = BS / 8;        // 8-column tiles of a score tile
  static constexpr int P = F32 ? 2 : 1;    // partial sums of a score chain
  static constexpr int NC = 4;   // output tiles summed from zero at a time
  static constexpr int LPR = kThreads / BR;          // ds lanes per own row
  static constexpr int EPT = BS / LPR;               // ds columns per lane
  static constexpr size_t tile_bytes = (size_t)(BR + 2 * BS) * LD * sizeof(T);
  static constexpr size_t part_bytes = (size_t)kWarps * BR * LDP * 4;
  static constexpr size_t ds_bytes = (size_t)BR * LDP * (F32 ? 8 : 4);
  static constexpr size_t bytes = tile_bytes + part_bytes + ds_bytes;
};

__device__ __forceinline__ V32 view(const float* p, int ld) {
  return V32{p, ld};
}
__device__ __forceinline__ V16 view(const __nv_bfloat16* p, int ld) {
  return V16{p, ld};
}

// Warp copy: rows row0.. (ROWS of them), columns c0..c0+CW of a dense
// (n_total, D) matrix into the tile dst (row stride LD); rows at or past
// n_total and columns at or past D become zeros. vec: 16-byte cp.async (the
// caller commits and waits); else element by element, in place at once.
template <typename T, int ROWS, int CW, int LD>
__device__ __forceinline__ void load_slice(T* dst, const T* src, int row0,
                                           int n_total, int D, int c0,
                                           bool vec) {
  const int lane = lane_id();
  if (vec) {
    constexpr int E = 16 / sizeof(T);          // elements per 16 bytes
    constexpr int PPR = CW / E;                // pieces per row
    for (int i = lane; i < ROWS * PPR; i += 32) {
      const int r = i / PPR, c = c0 + (i % PPR) * E, g = row0 + r;
      const bool ok = g < n_total && c < D;    // D is a multiple of E
      cp_async16(dst + r * LD + c, src + (ok ? (size_t)g * D + c : 0), ok);
    }
  } else {
    for (int i = lane; i < ROWS * CW; i += 32) {
      const int r = i / CW, c = c0 + i % CW, g = row0 + r;
      dst[r * LD + c] = (g < n_total && c < D) ? src[(size_t)g * D + c]
                                               : from_f32<T>(0.f);
    }
  }
}

// A (16 x 8) of the ds tile from its tf32 planes, k-steps in the permuted
// order of load_bt (slot t <-> k = 2t, slot t + 4 <-> k = 2t + 1): the two
// values are neighbours, one 8-byte load a row
__device__ __forceinline__ A32 load_ds(const float* hi, const float* lo,
                                       int ld, int m0, int k0) {
  const int g = lane_id() >> 2, t = lane_id() & 3;
  const int off = (m0 + g) * ld + k0 + 2 * t;
  const uint2 h0 = *reinterpret_cast<const uint2*>(hi + off);
  const uint2 h1 = *reinterpret_cast<const uint2*>(hi + off + 8 * ld);
  const uint2 l0 = *reinterpret_cast<const uint2*>(lo + off);
  const uint2 l1 = *reinterpret_cast<const uint2*>(lo + off + 8 * ld);
  return A32{{h0.x, h1.x, h0.y, h1.y}, {l0.x, l1.x, l0.y, l1.y}};
}

// The shared walk. kTok: the own rows are tokens (dhidden: R holds hidden
// rows, weight rows stream); else vocab rows (dweight: R holds weight rows,
// hidden rows stream).
template <typename T, int MT, int NT, bool kTok>
__device__ __forceinline__ void head_bwd_walk(
    const T* __restrict__ h, const T* __restrict__ w,
    const float* __restrict__ bias, const long long* __restrict__ labels,
    const float* __restrict__ lse, const float* __restrict__ dloss,
    T* __restrict__ out, float* __restrict__ dbias, int Tn, int V, int D,
    bool vec_h, bool vec_w) {
  using C = Cfg<T, MT, NT>;
  constexpr int BR = C::BR, BS = C::BS, KS = C::KS, LD = C::LD, LDP = C::LDP;
  constexpr int NB = C::NB, NC = C::NC, LPR = C::LPR, EPT = C::EPT;
  static_assert(NT % NC == 0 && (8 * NT) % KS == 0, "a warp's columns");
  extern __shared__ __align__(16) unsigned char smem[];
  T* Rs = reinterpret_cast<T*>(smem);                  // [BR][LD] own rows
  T* Ss = Rs + BR * LD;                                // [2][BS][LD] streamed
  float* Part = reinterpret_cast<float*>(Ss + 2 * BS * LD);  // [8][BR][LDP]
  float* DsHi = Part + kWarps * BR * LDP;              // [BR][LDP] f32: hi
  float* DsLo = DsHi + BR * LDP;                       //           and lo
  __nv_bfloat16* Ds16Hi = reinterpret_cast<__nv_bfloat16*>(DsHi);   // bf16:
  __nv_bfloat16* Ds16Lo = Ds16Hi + BR * LDP;                  // hi and lo

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int c0 = warp * C::CW;               // the warp's columns of D
  const int r0 = blockIdx.x * BR;
  const int n_own = kTok ? Tn : V, n_str = kTok ? V : Tn;
  const T* own_src = kTok ? h : w;
  const T* str_src = kTok ? w : h;
  const bool vec_own = kTok ? vec_h : vec_w, vec_str = kTok ? vec_w : vec_h;
  const int n_tiles = (n_str + BS - 1) / BS;

  load_slice<T, BR, C::CW, LD>(Rs, own_src, r0, n_own, D, c0, vec_own);
  load_slice<T, BS, C::CW, LD>(Ss, str_src, 0, n_str, D, c0, vec_str);
  cp_async_commit();
  if (n_tiles > 1)
    load_slice<T, BS, C::CW, LD>(Ss + BS * LD, str_src, BS, n_str, D, c0,
                                 vec_str);
  cp_async_commit();

  // the ds step: this thread's EPT columns of own row `row`
  const int row = threadIdx.x / LPR, lc = (threadIdx.x % LPR) * EPT;
  const int own = r0 + row;
  const bool own_ok = own < n_own;
  // per own row: a token's label, lse and dloss, or a vocab row's bias
  long long own_label = -1;
  float own_lse = 0.f, own_dl = 0.f, own_bias = 0.f;
  if (own_ok) {
    if (kTok) {
      own_label = labels[own];
      own_lse = lse[own];
      own_dl = dloss[own];
    } else if (bias) {
      own_bias = bias[own];
    }
  }
  float db_acc = 0.f;

  // running sums: rows 16m + g (+ 8), columns c0 + 8n + 2t (+ 1)
  float acc[MT][NT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;

  const auto Rv = view(Rs, LD);
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * BS;
    T* Sc = Ss + (tile & 1) * BS * LD;
    const auto Sv = view(Sc, LD);

    // the streamed side's values of this thread's ds columns, in flight
    // during the score product
    float col_a[EPT], col_b[EPT];
    long long col_label[EPT];
#pragma unroll
    for (int j = 0; j < EPT; ++j) {
      const int kg = k0 + lc + j;
      col_a[j] = col_b[j] = 0.f;
      col_label[j] = -1;
      if (kg < n_str) {
        if (kTok) {
          if (bias) col_a[j] = bias[kg];
        } else {
          col_a[j] = lse[kg];
          col_b[j] = dloss[kg];
          col_label[j] = labels[kg];
        }
      }
    }

    cp_async_wait<1>();   // everything but the tile requested last
    __syncwarp();

    // the warp's share of the scores: R[:, c0..] S[:, c0..]^T, from zero
    float part[C::P][MT][NB][4];
#pragma unroll
    for (int i = 0; i < C::P; ++i)
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < NB; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[i][m][j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < C::CW / KS; ++ks) {
      const int kk = c0 + ks * KS;
      typename Frag<T>::A a[MT];
#pragma unroll
      for (int m = 0; m < MT; ++m) a[m] = load_a(Rv, 16 * m, kk);
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        const auto b = load_b(Sv, 8 * j, kk);
#pragma unroll
        for (int m = 0; m < MT; ++m) mma(part[ks % C::P][m][j], a[m], b);
      }
    }
    float* pw = Part + warp * BR * LDP;
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          v[e] = part[0][m][j][e];
#pragma unroll
          for (int i = 1; i < C::P; ++i) v[e] += part[i][m][j][e];
        }
        float* p = pw + (16 * m + g) * LDP + 8 * j + 2 * t;
        store2(p, v[0], v[1]);
        store2(p + 8 * LDP, v[2], v[3]);
      }
    __syncthreads();   // the eight partial tiles are complete

    // scores -> ds, split once for every warp
    float db_part = 0.f;
#pragma unroll
    for (int j = 0; j < EPT; ++j) {
      const int c = lc + j, kg = k0 + c;
      float s = 0.f;
#pragma unroll
      for (int wv = 0; wv < kWarps; ++wv)
        s += Part[wv * BR * LDP + row * LDP + c];
      float ds = 0.f;
      if (own_ok && kg < n_str) {
        if (kTok)
          ds = ce_ds(s + col_a[j], own_lse, own_dl, label_hit(kg, own_label));
        else
          ds = ce_ds(s + own_bias, col_a[j], col_b[j],
                     label_hit(own, col_label[j]));
      }
      if constexpr (C::F32) {
        uint32_t hi, lo;
        split(ds, hi, lo);
        DsHi[row * LDP + c] = __uint_as_float(hi);
        DsLo[row * LDP + c] = __uint_as_float(lo);
      } else {
        const __nv_bfloat16 hi = __float2bfloat16(ds);
        Ds16Hi[row * LDP + c] = hi;
        Ds16Lo[row * LDP + c] = __float2bfloat16(ds - __bfloat162float(hi));
      }
      db_part += ds;
    }
    if (!kTok) db_acc += lanes_sum<LPR>(db_part);
    __syncthreads();   // ds is complete; Part may be rewritten

    // acc += ds S[:, c0..]: NC output tiles at a time, from zero; the ds
    // fragments are loaded once for all of them
    typename Frag<T>::A a[BS / KS][MT];
    A16 a_lo[C::F32 ? 1 : BS / KS][MT];      // bf16: the pair's low half
#pragma unroll
    for (int kc = 0; kc < BS / KS; ++kc)
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if constexpr (C::F32) {
          a[kc][m] = load_ds(DsHi, DsLo, LDP, 16 * m, kc * KS);
        } else {
          a[kc][m] = load_a(V16{Ds16Hi, LDP}, 16 * m, kc * KS);
          a_lo[kc][m] = load_a(V16{Ds16Lo, LDP}, 16 * m, kc * KS);
        }
      }
#pragma unroll
    for (int n0 = 0; n0 < NT; n0 += NC) {
      float p[MT][NC][4];
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int n = 0; n < NC; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) p[m][n][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < BS / KS; ++kc)
#pragma unroll
        for (int n = 0; n < NC; ++n) {
          const auto b = load_bt(Sv, kc * KS, c0 + 8 * (n0 + n));
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            if constexpr (!C::F32) mma(p[m][n], a_lo[kc][m], b);
            mma(p[m][n], a[kc][m], b);
          }
        }
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int n = 0; n < NC; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[m][n0 + n][e] += p[m][n][e];
    }

    // the warp is done with this stage: refill it with the tile after next
    __syncwarp();
    if (tile + 2 < n_tiles)
      load_slice<T, BS, C::CW, LD>(Sc, str_src, k0 + 2 * BS, n_str, D, c0,
                                   vec_str);
    cp_async_commit();
  }
  cp_async_wait<0>();

  const bool pairs = (D & 1) == 0;   // a row's column pairs start on 8 bytes
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int gr = r0 + 16 * m + g + 8 * r;
      if (gr >= n_own) continue;
      T* orow = out + (size_t)gr * D;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int col = c0 + 8 * n + 2 * t;
        const float v0 = acc[m][n][2 * r], v1 = acc[m][n][2 * r + 1];
        if (pairs) {
          if (col < D) store2(orow + col, v0, v1);
        } else {
          if (col < D) orow[col] = from_f32<T>(v0);
          if (col + 1 < D) orow[col + 1] = from_f32<T>(v1);
        }
      }
    }
  if (!kTok && threadIdx.x % LPR == 0 && own_ok) dbias[own] = db_acc;
}

template <typename T, int MT, int NT>
__global__ void __launch_bounds__(kThreads, 1)
head_dh_kernel(const T* __restrict__ h, const T* __restrict__ w,
               const float* __restrict__ bias,
               const long long* __restrict__ labels,
               const float* __restrict__ lse, const float* __restrict__ dloss,
               T* __restrict__ dh, int Tn, int V, int D, bool vec_h,
               bool vec_w) {
  head_bwd_walk<T, MT, NT, true>(h, w, bias, labels, lse, dloss, dh, nullptr,
                                 Tn, V, D, vec_h, vec_w);
}

template <typename T, int MT, int NT>
__global__ void __launch_bounds__(kThreads, 1)
head_dw_kernel(const T* __restrict__ h, const T* __restrict__ w,
               const float* __restrict__ bias,
               const long long* __restrict__ labels,
               const float* __restrict__ lse, const float* __restrict__ dloss,
               T* __restrict__ dw, float* __restrict__ dbias, int Tn, int V,
               int D, bool vec_h, bool vec_w) {
  head_bwd_walk<T, MT, NT, false>(h, w, bias, labels, lse, dloss, dw, dbias,
                                  Tn, V, D, vec_h, vec_w);
}

struct Args {
  const void *h, *w, *bias, *labels, *lse, *dloss;
  void *out, *dbias;
  int Tn, V, D;
};

template <typename T, int MT, int NT>
cudaError_t launch(const Args& a, bool dweight, cudaStream_t stream) {
  using C = Cfg<T, MT, NT>;
  const size_t smem = C::bytes;
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
    err = cudaFuncSetAttribute(head_dw_kernel<T, MT, NT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    head_dw_kernel<T, MT, NT><<<(a.V + C::BR - 1) / C::BR, kThreads, smem,
                                stream>>>(
        h, w, bias, labels, lse, dl, static_cast<T*>(a.out),
        static_cast<float*>(a.dbias), a.Tn, a.V, a.D, vh, vw);
  } else {
    err = cudaFuncSetAttribute(head_dh_kernel<T, MT, NT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    head_dh_kernel<T, MT, NT><<<(a.Tn + C::BR - 1) / C::BR, kThreads, smem,
                                stream>>>(
        h, w, bias, labels, lse, dl, static_cast<T*>(a.out), a.Tn, a.V, a.D,
        vh, vw);
  }
  return cudaGetLastError();
}

// A warp's columns follow D: 8 warps x NT 8-column tiles cover it.
template <typename T>
cudaError_t launch_d(const Args& a, bool dweight, cudaStream_t s) {
  if (a.D <= 256) return launch<T, 2, 4>(a, dweight, s);
  if (a.D <= 512) return launch<T, 2, 8>(a, dweight, s);
  if (a.D <= 768) return launch<T, 2, 12>(a, dweight, s);
  return launch<T, 1, 16>(a, dweight, s);
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
