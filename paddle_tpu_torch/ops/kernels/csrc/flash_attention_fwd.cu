// Flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces paddle_tpu/ops/pallas/flash_attention.py:_pallas_forward
// (kernel body _fwd_kernel): out = softmax(q k^T * scale + mask) v with
// the logsumexp residual lse, online softmax over key tiles, additive mask
// "none" / "k" (B,1,1,Tk) / "qk" (B,1,Tq,Tk), bottom-right causal
// (query i sees keys j <= i + Tk - Tq), masked logits filled with the
// same finite -1e30 as the TPU kernel.
//
// What bounds it on the H100: 4*Tq*Tk*D operations per (batch, head)
// against reading q/k/v and writing out once. At BERT-base serving (8 x 12
// heads, Tq = Tk = 512, D = 64, f32) that is 6.44 GFLOP, 39 us at the 165
// TFLOP/s of f32-accurate tensor-core work (3xTF32), against ~50 MB, 15 us
// at 3.35 TB/s: the operations bound it. Both products run on wgmma
// (wgmma_sm90.cuh): f32 by 3xTF32 (hi = tf32(x), lo = tf32(x - hi); lo*hi +
// hi*lo + hi*hi, never one tf32 pass), bf16 and fp16 exactly into f32 sums.
//
// Design: one block per (b*h, BM-row query tile), one consumer warpgroup per
// 64 query rows. q is split once into K-major operand planes in shared memory
// (f32: tf32 hi and lo planes; bf16: the values). Each key tile is staged raw
// by cp.async, each thread copying and then converting the same 16-byte
// pieces (no barrier between copy and conversion), into a second pair of
// plane buffers while the previous tile's S = q k^T runs on the tensor cores:
// k as K-major planes, v transposed (tf32 wgmma takes K-major B only), its
// keys inside each 8-deep step in perm8 order so that P's accumulator
// registers enter P v as register A without a shuffle. S = q k^T (m64nBNk8 by
// descriptor), then scale, mask, causal fill and the online softmax in
// registers (a row is shared by four lanes). P is split (f32) or taken as a
// bf16 pair (bf16 inputs: hi = bf16(p), lo = bf16(p - hi); one bf16 P, the
// reference's DEFAULT precision, moves the output of a causal row that sees a
// few keys by a bf16 ulp of up to 2^-6 against the plain version's f32 P;
// fp16 inputs: the same pair in fp16, of P scaled by 2^14 (exact; P <= 1, so
// the pair neither overflows nor loses a small P to fp16's subnormals; the
// reference computes fp16 in f32, HIGHEST) and the output unscaled with 1 /
// l) in registers, and each tile's P v goes into a fresh accumulator that
// joins the running output as acc = acc * corr + tile: the tensor cores
// truncate their f32 sums, so no chain runs longer than a tile. Tile shapes:
// f32 D = 64 and bf16 take 128 query rows and 64-key tiles (f32 D = 64: 225
// KB of shared memory with both plane buffers; fp16 takes bf16's shapes); f32
// D = 128 takes 64 query rows and 32-key tiles, the largest that keep two
// plane buffers in shared memory and the sums in registers. (One warpgroup a
// block and two blocks an SM, 32-key f32 tiles, measured slower on the H100.)
// Key tiles above the causal diagonal are skipped unless the query tile
// holds a row that sees no key at all (causal with Tq > Tk): those rows
// need every key to come out uniform, as the reference defines them. Ragged
// Tq/Tk edges: out-of-range keys get probability 0, out-of-range query rows
// are computed on zeros and never stored. Query tiles are taken from the
// last (the longest causal rows) to the first.
// On the H100 the phases of a tile (S, softmax, P v, the next tile's
// conversion) add up rather than overlap, so the softmax is kept short: a
// tile that every row of a warpgroup sees whole skips the per-element
// bounds and causal tests and reads a key mask once per column, and e^x is
// one ex2.approx.ftz.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>

#include <type_traits>

#include "wgmma_sm90.cuh"

namespace {

namespace wg = ptt_wgmma;

constexpr float kNegInf = -1e30f;  // paddle_tpu's _NEG_INF
constexpr float kPScale = 16384.f;  // fp16: P enters P v as P * 2^14

// e^x for x <= 0 by the hardware's exp2 (ex2.approx.ftz, ~2^-22
// relative; results below 2^-126 flush to 0): exact 1 at 0, 0 at -inf
__device__ __forceinline__ float exp_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

// over the four lanes that share an accumulator row
__device__ __forceinline__ float row_max4(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float row_sum4(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <typename T, int D>
struct Cfg {
  static constexpr bool kF32 = sizeof(T) == 4;
  static constexpr bool kF16 = std::is_same<T, __half>::value;
  static constexpr int BM = kF32 && D == 128 ? 64 : 128;   // query rows
  static constexpr int BN = BM / 2;                         // keys a tile
  static constexpr int kThreads = BM * 2;                   // BM / 64 WGs
  static constexpr int kPlanes = kF32 ? 2 : 1;
  static constexpr int kEl = sizeof(T);
  static constexpr int kRowBytes = D * kEl;                 // a q/k/v row
  static constexpr int kCPR = kRowBytes / 16;               // 16-B pieces
  static constexpr int kQPlane = BM * kRowBytes;
  static constexpr int kKPlane = BN * kRowBytes;            // == Vt plane
  static constexpr int kBuf = 2 * kPlanes * kKPlane;        // k and v^T
  static constexpr int kRaw = 2 * kKPlane;                  // == kQPlane
  static constexpr int kSmem =
      kPlanes * kQPlane + 2 * kBuf + kRaw + wg::kAtomBytes;
  static_assert(kRaw == kQPlane, "q is staged through the raw buffer");
  static_assert(kSmem <= 232448, "shared memory of one block");
};

struct Args {
  const char* q;
  const char* k;
  const char* v;
  const float* mask;
  char* out;
  float* lse;
  int H, Tq, Tk;
  long long mask_stride_b;
  int mask_stride_q;
  float scale;
  int causal;
};

template <typename T, int D>
__global__ void __launch_bounds__(Cfg<T, D>::kThreads, 1)
flash_fwd_kernel(const Args a) {
  using C = Cfg<T, D>;
  constexpr int BM = C::BM, BN = C::BN, NT = C::kThreads;
  constexpr int CPR = C::kCPR, RB = C::kRowBytes;
  extern __shared__ char smem_raw[];
  char* smem = wg::align_atom(smem_raw);
  char* q_pl = smem;                                  // [planes] BM x D
  char* kv_pl = q_pl + C::kPlanes * C::kQPlane;       // [2 bufs] k, v^T
  char* raw = kv_pl + 2 * C::kBuf;                    // raw k | raw v
  auto k_plane = [&](int buf, int p) {
    return kv_pl + buf * C::kBuf + p * C::kKPlane;
  };
  auto v_plane = [&](int buf, int p) {
    return kv_pl + buf * C::kBuf + (C::kPlanes + p) * C::kKPlane;
  };

  const int tid = threadIdx.x;
  const int wgi = tid / 128, warp = (tid & 127) / 32;
  const int g = (tid & 31) / 4, q4 = tid & 3;
  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BM;
  const int offset = a.Tk - a.Tq;
  const char* qb = a.q + (size_t)bh * a.Tq * RB;
  const char* kb = a.k + (size_t)bh * a.Tk * RB;
  const char* vb = a.v + (size_t)bh * a.Tk * RB;
  const float* mb =
      a.mask ? a.mask + (size_t)(bh / a.H) * (size_t)a.mask_stride_b
             : nullptr;

  // raw v: piece c of key r at piece c ^ (r % CPR) of its row, so that the
  // key-wise reads below hit distinct banks
  auto raw_v = [&](int r, int c) {
    return raw + C::kKPlane + r * RB + ((c ^ (r & (CPR - 1))) << 4);
  };
  // this thread's 16-byte pieces: q and k row-wise, v key-wise (so that a
  // warp writes one v^T row's consecutive keys)
  auto copy_kv = [&](int k0) {
#pragma unroll
    for (int j = 0; j < BN * CPR / NT; ++j) {
      const int id = tid + NT * j;
      const int rk = id / CPR, ck = id % CPR;
      const int rv = id % BN, cv = id / BN;
      const bool okk = k0 + rk < a.Tk, okv = k0 + rv < a.Tk;
      ptt_mma::cp_async16(raw + rk * RB + ck * 16,
                          okk ? kb + (size_t)(k0 + rk) * RB + ck * 16 : kb,
                          okk);
      ptt_mma::cp_async16(raw_v(rv, cv),
                          okv ? vb + (size_t)(k0 + rv) * RB + cv * 16 : vb,
                          okv);
    }
    ptt_mma::cp_async_commit();
  };
  auto convert_kv = [&](int buf) {
#pragma unroll
    for (int j = 0; j < BN * CPR / NT; ++j) {
      const int id = tid + NT * j;
      const int rk = id / CPR, ck = id % CPR;
      const int rv = id % BN, cv = id / BN;
      const uint4 kx = *reinterpret_cast<const uint4*>(raw + rk * RB + ck * 16);
      const uint4 vx = *reinterpret_cast<const uint4*>(raw_v(rv, cv));
      if constexpr (C::kF32) {
        wg::put4_split(k_plane(buf, 0), k_plane(buf, 1), BN, rk, 4 * ck,
                       *reinterpret_cast<const float4*>(&kx));
        const float* vf = reinterpret_cast<const float*>(&vx);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          wg::put_t_split(v_plane(buf, 0), v_plane(buf, 1), D, 4 * cv + e, rv,
                          vf[e]);
      } else {
        wg::put8(k_plane(buf, 0), BN, rk, 8 * ck, kx);
        const __nv_bfloat16* vh = reinterpret_cast<const __nv_bfloat16*>(&vx);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          wg::put_t(v_plane(buf, 0), D, 8 * cv + e, rv, vh[e]);
      }
    }
  };

  // q: staged through the raw buffer, converted once
#pragma unroll
  for (int j = 0; j < BM * CPR / NT; ++j) {
    const int id = tid + NT * j, r = id / CPR, c = id % CPR;
    const bool ok = q0 + r < a.Tq;
    ptt_mma::cp_async16(raw + r * RB + c * 16,
                        ok ? qb + (size_t)(q0 + r) * RB + c * 16 : qb, ok);
  }
  ptt_mma::cp_async_commit();
  ptt_mma::cp_async_wait<0>();
#pragma unroll
  for (int j = 0; j < BM * CPR / NT; ++j) {
    const int id = tid + NT * j, r = id / CPR, c = id % CPR;
    const uint4 x = *reinterpret_cast<const uint4*>(raw + r * RB + c * 16);
    if constexpr (C::kF32)
      wg::put4_split(q_pl, q_pl + C::kQPlane, BM, r, 4 * c,
                     *reinterpret_cast<const float4*>(&x));
    else
      wg::put8(q_pl, BM, r, 8 * c, x);
  }
  __syncthreads();   // the raw buffer is free for k and v

  // key tiles past the causal diagonal contribute nothing — unless a row of
  // this tile sees no key at all (q0 + offset < 0)
  const int q_last = min(q0 + BM, a.Tq) - 1;
  int k_end = a.Tk;
  if (a.causal && q0 + offset >= 0) k_end = min(a.Tk, q_last + offset + 1);
  const int n_tiles = (k_end + BN - 1) / BN;

  copy_kv(0);
  ptt_mma::cp_async_wait<0>();
  convert_kv(0);
  if (n_tiles > 1) copy_kv(BN);
  wg::fence_proxy_async();
  __syncthreads();

  const int r0 = 16 * warp + g;               // rows r0 and r0 + 8 of the WG
  int qrow[2];
  const float* mrow[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    qrow[h] = q0 + 64 * wgi + r0 + 8 * h;
    mrow[h] = mb ? mb + (size_t)min(qrow[h], a.Tq - 1) * a.mask_stride_q
                 : nullptr;
  }
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[D / 2], ot[D / 2], s[BN / 2];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) o[e] = ot[e] = 0.f;
#pragma unroll
  for (int e = 0; e < BN / 2; ++e) s[e] = 0.f;

  const char* q_wg = q_pl + wgi * 64 * wg::kSwizzleBytes;

  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1, k0 = t * BN;
    // S = q k^T
    wg::fence();
#pragma unroll
    for (int ks = 0; ks < RB / 32; ++ks) {
      const uint64_t dq = wg::desc_k(q_wg, BM, 32 * ks);
      const uint64_t dk = wg::desc_k(k_plane(buf, 0), BN, 32 * ks);
      if constexpr (C::kF32) {
        const uint64_t dql = wg::desc_k(q_wg + C::kQPlane, BM, 32 * ks);
        const uint64_t dkl = wg::desc_k(k_plane(buf, 1), BN, 32 * ks);
        wg::mma_tf32_ss<BN>(s, dql, dk, ks > 0);
        wg::mma_tf32_ss<BN>(s, dq, dkl, 1);
        wg::mma_tf32_ss<BN>(s, dq, dk, 1);
      } else if constexpr (C::kF16) {
        wg::mma_f16_ss<BN>(s, dq, dk, ks > 0);
      } else {
        wg::mma_bf16_ss<BN>(s, dq, dk, ks > 0);
      }
    }
    wg::commit();
    // meanwhile: the next tile into the other plane buffer, the one after
    // into the raw buffer
    if (t + 1 < n_tiles) {
      ptt_mma::cp_async_wait<0>();
      convert_kv(buf ^ 1);
      if (t + 2 < n_tiles) copy_kv(k0 + 2 * BN);
    }
    wg::wait<0>();
    wg::fence_operand(s);

    // scale, mask, causal fill, online softmax (x = s * scale + mask in
    // one rounding on both paths). A tile that every row of this
    // warpgroup sees whole needs no bounds or causal test, and a key mask
    // is read once for the lane's two rows.
    const bool whole = k0 + BN <= a.Tk &&
                       (!a.causal || k0 + BN - 1 <= q0 + 64 * wgi + offset);
    if (whole) {
#pragma unroll
      for (int e = 0; e < BN / 2; e += 4) {         // one 8-key block
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int kg = k0 + 2 * e + 2 * q4 + c;
          const float m0 = mb ? mrow[0][kg] : 0.f;
          const float m1 = mb && a.mask_stride_q ? mrow[1][kg] : m0;
          s[e + c] = __fmaf_rn(s[e + c], a.scale, m0);
          s[e + 2 + c] = __fmaf_rn(s[e + 2 + c], a.scale, m1);
        }
      }
    } else {
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) {
        const int h = (e >> 1) & 1;
        const int kg = k0 + 8 * (e >> 2) + 2 * q4 + (e & 1);
        float x = -INFINITY;  // out-of-range key: probability exactly 0
        if (kg < a.Tk) {
          x = __fmaf_rn(s[e], a.scale, mrow[h] ? mrow[h][kg] : 0.f);
          if (a.causal && qrow[h] + offset < kg) x = kNegInf;
        }
        s[e] = x;
      }
    }
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int e = 0; e < BN / 2; ++e)
      tmax[(e >> 1) & 1] = fmaxf(tmax[(e >> 1) & 1], s[e]);
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m_new = fmaxf(m[h], row_max4(tmax[h]));
      corr[h] = exp_fast(m[h] - m_new);
      m[h] = m_new;
      l[h] *= corr[h];
    }
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) {
      const int h = (e >> 1) & 1;
      s[e] = exp_fast(s[e] - m[h]);
      l[h] += s[e];
    }

    // ot = P v, from a fresh accumulator; o = o * corr + ot. The A
    // registers are written before the wgmma fence that orders them.
    if constexpr (C::kF32) {
      uint32_t hi[BN / 8][4], lo[BN / 8][4];
#pragma unroll
      for (int kc = 0; kc < BN / 8; ++kc)
        wg::a_from_acc(hi[kc], lo[kc], s[4 * kc], s[4 * kc + 1],
                       s[4 * kc + 2], s[4 * kc + 3]);
      wg::fence();
#pragma unroll
      for (int kc = 0; kc < BN / 8; ++kc) {
        const uint64_t dv = wg::desc_k(v_plane(buf, 0), D, 32 * kc);
        const uint64_t dvl = wg::desc_k(v_plane(buf, 1), D, 32 * kc);
        wg::mma_tf32_rs<D>(ot, lo[kc], dv, kc > 0);
        wg::mma_tf32_rs<D>(ot, hi[kc], dvl, 1);
        wg::mma_tf32_rs<D>(ot, hi[kc], dv, 1);
      }
      wg::commit();
      wg::wait<0>();
#pragma unroll
      for (int kc = 0; kc < BN / 8; ++kc) {
        wg::fence_operand(hi[kc]);
        wg::fence_operand(lo[kc]);
      }
    } else if constexpr (C::kF16) {
      // P * 2^14 as an fp16 pair (see the header); o stays scaled until
      // the end
      uint32_t ph[BN / 16][4], pl[BN / 16][4];
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) s[e] *= kPScale;
#pragma unroll
      for (int kc = 0; kc < BN / 16; ++kc)
        wg::a_from_acc_f16(ph[kc], pl[kc], &s[8 * kc], &s[8 * kc + 4]);
      wg::fence();
#pragma unroll
      for (int kc = 0; kc < BN / 16; ++kc) {
        const uint64_t dv = wg::desc_k(v_plane(buf, 0), D, 32 * kc);
        wg::mma_f16_rs<D>(ot, pl[kc], dv, kc > 0);
        wg::mma_f16_rs<D>(ot, ph[kc], dv, 1);
      }
      wg::commit();
      wg::wait<0>();
#pragma unroll
      for (int kc = 0; kc < BN / 16; ++kc) {
        wg::fence_operand(ph[kc]);
        wg::fence_operand(pl[kc]);
      }
    } else {
      // P as a bf16 pair, hi = bf16(p), lo = bf16(p - hi): one bf16 P
      // moves a row that sees a few keys (|out| up to ~4) by a bf16 ulp
      float lo[BN / 2];
      uint32_t ph[BN / 16][4], pl[BN / 16][4];
#pragma unroll
      for (int e = 0; e < BN / 2; ++e)
        lo[e] = s[e] - __bfloat162float(__float2bfloat16(s[e]));
#pragma unroll
      for (int kc = 0; kc < BN / 16; ++kc) {
        wg::a_from_acc(ph[kc], &s[8 * kc], &s[8 * kc + 4]);
        wg::a_from_acc(pl[kc], &lo[8 * kc], &lo[8 * kc + 4]);
      }
      wg::fence();
#pragma unroll
      for (int kc = 0; kc < BN / 16; ++kc) {
        const uint64_t dv = wg::desc_k(v_plane(buf, 0), D, 32 * kc);
        wg::mma_bf16_rs<D>(ot, pl[kc], dv, kc > 0);
        wg::mma_bf16_rs<D>(ot, ph[kc], dv, 1);
      }
      wg::commit();
      wg::wait<0>();
#pragma unroll
      for (int kc = 0; kc < BN / 16; ++kc) {
        wg::fence_operand(ph[kc]);
        wg::fence_operand(pl[kc]);
      }
    }
    wg::fence_operand(ot);
#pragma unroll
    for (int e = 0; e < D / 2; ++e) o[e] = o[e] * corr[(e >> 1) & 1] + ot[e];

    wg::fence_proxy_async();
    __syncthreads();   // the next buffer is complete; this one is free
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    // a NaN row sum (a NaN logit or mask value) stays NaN, as in the
    // plain version: fmaxf alone would replace it by the floor
    const float ls = row_sum4(l[h]);
    const float lc = ls != ls ? ls : fmaxf(ls, 1e-30f);
    if (qrow[h] >= a.Tq) continue;
    T* orow = reinterpret_cast<T*>(a.out) + ((size_t)bh * a.Tq + qrow[h]) * D;
    const float inv = (C::kF16 ? 1.f / kPScale : 1.f) / lc;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      ptt_mma::store2(orow + 8 * j + 2 * q4, o[4 * j + 2 * h] * inv,
                      o[4 * j + 2 * h + 1] * inv);
    if (q4 == 0) a.lse[(size_t)bh * a.Tq + qrow[h]] = m[h] + logf(lc);
  }
}

template <typename T, int D>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  using C = Cfg<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::kSmem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.Tq + C::BM - 1) / C::BM, B * a.H);
  flash_fwd_kernel<T, D><<<grid, C::kThreads, C::kSmem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. mask is float32 or null; its
// element for (batch b, query i, key j) is mask[b * mask_stride_b + i *
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
  const Args a{static_cast<const char*>(q), static_cast<const char*>(k),
               static_cast<const char*>(v), static_cast<const float*>(mask),
               static_cast<char*>(out), static_cast<float*>(lse), H, Tq, Tk,
               mask_stride_b, mask_stride_q, scale, causal};
  if (dtype == 0 && D == 64) return launch<float, 64>(a, B, s);
  if (dtype == 0 && D == 128) return launch<float, 128>(a, B, s);
  if (dtype == 1 && D == 64) return launch<__nv_bfloat16, 64>(a, B, s);
  if (dtype == 1 && D == 128) return launch<__nv_bfloat16, 128>(a, B, s);
  if (dtype == 2 && D == 64) return launch<__half, 64>(a, B, s);
  if (dtype == 2 && D == 128) return launch<__half, 128>(a, B, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* ptt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
