// Flash-attention backward for Hopper (sm_90a), plain C interface: two
// kernels, dK/dV and dQ, on the tensor cores.
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
// What bounds it on the H100. Per visible (query, key) pair the dK/dV
// kernel does 8*D flops (s, dp, dv, dk) and the dQ kernel 6*D (s, dp, dq).
// f32 inputs keep f32 accuracy on the tensor cores by 3xTF32 (below), the
// scheme of PyTorch's own f32 attention backward, so their peak is the
// dense TF32 rate over three: 495 / 3 = 165 TFLOP/s. At GPT-base training
// ((2, 12, 4096, 4096, 64) causal f32) that is 103 + 77 GFLOP, 0.625 +
// 0.469 ms: the operations bound it. At BERT-base training ((32, 12, 128,
// 128, 64) f32) 1.9 + 1.4 GFLOP take 0.012 + 0.009 ms against 75.5 MB
// moved (q, k, v, dO read, dq, dk, dv written, mask, lse, delta), 0.0225
// ms at 3.35 TB/s: the bytes bound it there. bf16 and fp16 run at 989
// TFLOP/s.
//
// Design, against that bound:
// - All five products (s, dp, dv, dk, dq) are warp-level mma.sync on the
//   tensor cores with f32 accumulation: m16n8k8 tf32 for f32 inputs,
//   m16n8k16 bf16 / fp16 for bf16 / fp16 inputs. mma.sync rather than wgmma:
//   s and dp stay in registers through the softmax-gradient step and enter
//   the dv, dk and dq products straight from there as A fragments, with no
//   round trip through shared memory, and a 128-thread block keeps the
//   shared memory of two blocks per SM (wgmma's B operand would need
//   separate hi and lo tiles of every operand in shared memory).
// - 3xTF32 (f32 inputs): hi = tf32(x), lo = tf32(x - hi), rounded to
//   nearest with ties away from zero on the low 13 bits (the rounding of
//   cvt.rna.tf32.f32); each product is lo*hi + hi*lo + hi*hi, three
//   m16n8k8 mma with f32 accumulation, dropping only lo*lo (~2^-22
//   relative). p and ds are split the same way as they enter dv, dk and
//   dq. Never single-pass TF32. The rounding is two integer instructions
//   ((bits + 0x1000) & ~0x1fff, exact for finite inputs): ptxas expands
//   cvt.rna.tf32.f32 into a longer sequence with NaN/Inf handling, which
//   dominated the split's cost. bf16 inputs: p and ds are rounded to bf16 (to
//   nearest) as they enter the bf16 products; every sum is f32.
// - fp16 inputs: the reference computes them in f32 (HIGHEST), so s and dp
//   (products of fp16 inputs, exact in one f16 mma) are f32-exact, and p
//   and ds enter dv, dk and dq as fp16 hi/lo pairs (~22 bits, two mma).
//   ds grows with the loss scale that dO carries: at 2^16 it passes fp16's
//   65504 where f32 does not, and a small p or ds would fall into fp16's
//   subnormals. So each row of a warp's p or ds tile (a row is shared by
//   four lanes) is first scaled by the power of two that puts its largest
//   magnitude in [2^14, 2^15) (scale_rows: two shuffles, exact), and the
//   tile's sum is scaled back before it joins the running sum. Chosen over
//   3xTF32 products with ds (the f32 path's split): those would need f32
//   copies of the resident and streamed fp16 tiles in shared memory and
//   three mma a k-step where the pair takes two.
// - Split once, not once per warp: at f32 and D = 64 each streamed tile is
//   split by the block as it arrives, hi in place and lo into a second
//   plane, and the four warps read both planes (ldmatrix where the
//   fragment is row-major). Resident tiles, and D = 128 (no shared memory
//   for the planes), split at fragment load.
// - Streamed tiles (Q, dO, lse, delta in dK/dV; K, V in dQ; 32 rows) come
//   in with 16-byte cp.async (4-byte for lse/delta) into a ring of two
//   stages: the next tile is in flight while the current one is
//   multiplied. Resident tiles (K, V in dK/dV; Q, dO in dQ; 64 rows) load
//   16 bytes a thread the same way. Shared-memory rows are padded by 16
//   bytes (D + 4 floats, D + 8 bf16), which makes every fragment load
//   conflict-free.
// - Tile sums: the tensor cores round each mma's f32 sum toward zero, a
//   bias that builds up over thousands of mma into one accumulator (past
//   the 1e-4 tolerance at T = 4096). So each streamed tile's contribution is
//   summed from zero (4-12 mma) and then added to the running sum with an
//   ordinary f32 add: registers at D = 64, shared memory at D = 128.
// - Two 4-warp blocks per SM leave each scheduler two warps, too few to
//   hide mma and shared-memory latency by themselves, so each warp keeps
//   more independent mma chains in flight where registers allow (Cfg::P,
//   Cfg::PAIRED): at GPT's shape dK/dV 2.21 -> 1.93 ms, dQ 1.64 -> 1.51.
// - dK/dV: a 128-thread block (4 warps x 16 keys) owns a (b*h, 64-key
//   tile) and walks the query tiles. dQ: a block owns 64 query rows (16 a
//   warp) and walks the key tiles. Under causal masking the heaviest blocks
//   go first: blockIdx.x runs over all heads of the first key tile (dK/dV)
//   or of the last query tile (dQ) before the next tile.
// - No atomics (dQ is its own kernel): every output element is summed by
//   one thread in tile order, so two runs give equal bits. Tiles past the
//   causal diagonal are skipped unless they hold a row that sees no key;
//   tiles inside it take a path without per-element masking. Ragged Tq/Tk
//   edges: out-of-range rows are loaded as zeros (cp.async zero-fill), get
//   p = ds = 0 and are never stored.
//
// ptxas (sm_90a, nvcc -O3), registers per thread as chip_smoke.py's build
// phase prints them: dK/dV f32 D=64 225, D=128 160, bf16 D=64 168
// (8-byte spill), D=128 95; dQ f32 165 / 164, bf16 122 / 80; no other
// spills. Shared memory per block: dK/dV f32 D=64 102.5 KB (two blocks
// per SM), dQ 102 KB; at D = 128 196.5 and 164 KB (one).
#include "mma_sm90.cuh"

namespace {

using namespace ptt_mma;

constexpr int kThreads = 128;   // 4 warps, 16 rows each
constexpr int kRows = 64;       // rows a block owns: keys (dK/dV), queries (dQ)

struct Problem {
  int H, Tq, Tk;
  long long mask_stride_b;
  int mask_stride_q;
  float scale;
  int causal;
};

// ---- tile shapes ---------------------------------------------------------

template <typename T> constexpr bool kF16 = false;
template <> constexpr bool kF16<__half> = true;

template <typename T, int D>
struct Cfg {
  static constexpr int LD = D + 16 / (int)sizeof(T);   // padded row stride
  static constexpr int R = 32;                          // streamed tile rows
  static constexpr int KS = sizeof(T) == 4 ? 8 : 16;    // mma depth
  static constexpr int ND = D / 8;                      // 8-column tiles of D
  static constexpr int NC = 8;   // output tiles summed in registers at once
  // streamed f32 tiles split once into hi/lo planes
  static constexpr bool PLANES = sizeof(T) == 4 && D == 64;
  static constexpr bool SUMS_SMEM = D > 64;   // running sums in shared memory
  // More independent mma chains where registers allow (each measured
  // faster at GPT's shape): accumulate() sums f32 output tiles in two
  // partial sums over alternate k-steps; at f32 D = 64 the dK/dV kernel
  // interleaves a tile's dV and dK products instead (accumulate2). Both
  // measured slower for bf16, the interleave also at D = 128.
  static constexpr int P = sizeof(T) == 4 ? 2 : 1;
  static constexpr bool PAIRED = PLANES;
};

// rows x D tile of a dense (T_, D) matrix into shared memory (row stride
// LD), 16 bytes a thread; rows at or past T_ are zeros
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int row0,
                                          int T_) {
  constexpr int PER = 16 / sizeof(T);        // elements per 16 bytes
  constexpr int CPR = D / PER;               // 16-byte pieces per row
  for (int i = threadIdx.x; i < ROWS * CPR; i += kThreads) {
    const int r = i / CPR, c = (i % CPR) * PER, g = row0 + r;
    const bool ok = g < T_;
    cp_async16(dst + r * Cfg<T, D>::LD + c,
               src + (size_t)(ok ? g : 0) * D + c, ok);
  }
}

// ROWS f32 values (lse or delta) of rows row0.. into shared memory, zeros
// past T_ (4-byte copies: a head's row start need not be 16-byte aligned)
template <int ROWS>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int row0, int T_, int part) {
  const int i = threadIdx.x - part * ROWS;
  if (i >= 0 && i < ROWS) {
    const bool ok = row0 + i < T_;
    cp_async4(dst + i, src + (ok ? row0 + i : 0), ok);
  }
}

// split a tile just landed in place: hi over the f32 values, lo into the
// second plane. Each thread splits the 16-byte pieces its own cp.async
// brought in (load_tile's assignment), so no barrier is needed before.
template <int D, int ROWS>
__device__ __forceinline__ void split_tile(float* hi, float* lo) {
  constexpr int CPR = D / 4;
  for (int i = threadIdx.x; i < ROWS * CPR; i += kThreads) {
    const int off = (i / CPR) * Cfg<float, D>::LD + (i % CPR) * 4;
    const float4 x = *reinterpret_cast<const float4*>(hi + off);
    uint4 h, l;
    split(x.x, h.x, l.x);
    split(x.y, h.y, l.y);
    split(x.z, h.z, l.z);
    split(x.w, h.w, l.w);
    *reinterpret_cast<uint4*>(hi + off) = h;
    *reinterpret_cast<uint4*>(lo + off) = l;
  }
}

// the view of a resident tile (split at fragment load) ...
template <typename T, int D>
__device__ __forceinline__ auto resident(const T* p) {
  if constexpr (sizeof(T) == 4)
    return V32{p, Cfg<T, D>::LD};
  else
    return V16T<T>{p, Cfg<T, D>::LD};
}

// ... and of a streamed one (lo: its second plane, if it has one)
template <typename T, int D>
__device__ __forceinline__ auto streamed(const T* p, const T* lo) {
  if constexpr (Cfg<T, D>::PLANES)
    return P32{p, lo, Cfg<T, D>::LD};
  else
    return resident<T, D>(p);
}

// ---- running sums of a warp's 16 x D output tile ---------------------------

template <int D, bool SMEM> struct Sums;

template <int D> struct Sums<D, false> {     // registers
  float v[D / 8][4];
  __device__ __forceinline__ void init(float*) {
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) v[n][e] = 0.f;
  }
  __device__ __forceinline__ float& at(int n, int e) { return v[n][e]; }
};

template <int D> struct Sums<D, true> {      // shared memory, conflict-free
  static constexpr int kFloats = D / 8 * 4 * kThreads;
  float* p;
  __device__ __forceinline__ void init(float* base) {
    p = base + threadIdx.x;
    for (int i = 0; i < D / 8 * 4; ++i) p[i * kThreads] = 0.f;
  }
  __device__ __forceinline__ float& at(int n, int e) {
    return p[(n * 4 + e) * kThreads];
  }
};

// fp16: each of the thread's two rows (g, g + 8) of the accumulator tiles
// c scaled by the power of two that puts the row's largest magnitude in
// [2^14, 2^15) (a row is spread over the four lanes 4g..4g + 3); inv gets
// the inverse scales. A row holding an Inf or NaN is left as it is.
template <int N>
__device__ __forceinline__ void scale_rows(float (&c)[N][4],
                                           float (&inv)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = 0.f;
#pragma unroll
    for (int j = 0; j < N; ++j)
      mx = fmaxf(mx, fmaxf(fabsf(c[j][2 * r]), fabsf(c[j][2 * r + 1])));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const int ex = (__float_as_int(mx) >> 23) & 0xff;   // biased exponent
    const int k = ex == 0xff ? 0 : max(-126, min(126, 141 - ex));
    const float up = __int_as_float((127 + k) << 23);
    inv[r] = __int_as_float((127 - k) << 23);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      c[j][2 * r] *= up;
      c[j][2 * r + 1] *= up;
    }
  }
}

// sums += A X over the streamed tile's rows, A from the accumulator tiles
// c (p or ds, 16 x 8*NKT), X the tile (rows x D, k-major). NC output tiles
// at a time are summed from zero in registers (in P partial sums over
// alternate k-steps), then added to the sums (fp16: times inv, the rows'
// inverse scales from scale_rows).
template <typename T, int D, int NKT, typename S, typename View>
__device__ __forceinline__ void accumulate(S& sums, const float (&c)[NKT][4],
                                           const View& x,
                                           const float (&inv)[2]) {
  using C = Cfg<T, D>;
  constexpr int P = C::P;
#pragma unroll
  for (int c0 = 0; c0 < C::ND; c0 += C::NC) {
    float part[P][C::NC][4];
#pragma unroll
    for (int i = 0; i < P; ++i)
#pragma unroll
      for (int n = 0; n < C::NC; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[i][n][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < NKT * 8 / C::KS; ++kc) {
      typename Frag<T>::A a;
      a_from_c(a, c, kc);
#pragma unroll
      for (int n = 0; n < C::NC; ++n)
        mma(part[kc % P][n], a, load_bt(x, kc * C::KS, 8 * (c0 + n)));
    }
#pragma unroll
    for (int n = 0; n < C::NC; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float t = part[0][n][e];
#pragma unroll
        for (int i = 1; i < P; ++i) t += part[i][n][e];
        if constexpr (kF16<T>) t *= inv[e >> 1];
        sums.at(c0 + n, e) += t;
      }
  }
}

// two accumulations of one streamed tile interleaved (dV and dK):
// twice the independent mma chains of accumulate() at a time
template <typename T, int D, int NKT, typename S, typename View>
__device__ __forceinline__ void accumulate2(S& s1, const float (&c1)[NKT][4],
                                            const View& x1, S& s2,
                                            const float (&c2)[NKT][4],
                                            const View& x2) {
  using C = Cfg<T, D>;
#pragma unroll
  for (int c0 = 0; c0 < C::ND; c0 += C::NC) {
    float p1[C::NC][4], p2[C::NC][4];
#pragma unroll
    for (int n = 0; n < C::NC; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) p1[n][e] = p2[n][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < NKT * 8 / C::KS; ++kc) {
      typename Frag<T>::A a1, a2;
      a_from_c(a1, c1, kc);
      a_from_c(a2, c2, kc);
#pragma unroll
      for (int n = 0; n < C::NC; ++n) {
        mma(p1[n], a1, load_bt(x1, kc * C::KS, 8 * (c0 + n)));
        mma(p2[n], a2, load_bt(x2, kc * C::KS, 8 * (c0 + n)));
      }
    }
#pragma unroll
    for (int n = 0; n < C::NC; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s1.at(c0 + n, e) += p1[n][e];
        s2.at(c0 + n, e) += p2[n][e];
      }
  }
}

// the thread's two output rows (row0 = g, row0 + 8 of the warp's 16) of the
// sums, scaled, into row-major (rows, D) memory; rows at or past T_ are
// not stored
template <typename T, int D, typename S>
__device__ __forceinline__ void store_rows(T* out, S& sums, int row0, int T_,
                                           float scale) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= T_) continue;
    T* p = out + (size_t)row * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      store2(p + 8 * n, scale * sums.at(n, 2 * r),
             scale * sums.at(n, 2 * r + 1));
  }
}

// ---- the softmax-gradient step ----------------------------------------------

// p and ds of one (query qg, key kg) pair from s = q.k and dp = dO.v,
// in place; m is the mask's value there (0 without one). `full`: the tile
// is inside both ragged edges and below the causal diagonal, nothing to
// check.
__device__ __forceinline__ void p_ds(float& s, float& dp, int qg, int kg,
                                     float l, float dl, float m, bool full,
                                     const Problem& pr) {
  if (!full) {
    if (qg >= pr.Tq || kg >= pr.Tk) {
      s = dp = 0.f;
      return;
    }
    if (pr.causal) {
      const int last = qg + pr.Tk - pr.Tq;   // the last key row qg sees
      if (last < 0) {                        // no key: uniform, dv only
        s = 1.f / (float)pr.Tk;
        dp = 0.f;
        return;
      }
      if (kg > last) {
        s = dp = 0.f;
        return;
      }
    }
  }
  const float p = __expf(s * pr.scale + m - l);
  s = p;
  dp = p * (dp - dl);
}

// ---- dK / dV ----------------------------------------------------------------

template <typename T, int D>
struct DkvSmem {
  using C = Cfg<T, D>;
  static constexpr size_t kv = (size_t)kRows * C::LD;   // K or V
  static constexpr size_t q = (size_t)C::R * C::LD;     // Q or dO (a plane)
  static constexpr int planes = C::PLANES ? 2 : 1;
  static constexpr size_t stage_bytes =
      2 * planes * q * sizeof(T) + 2 * C::R * 4;        // + lse, delta
  static constexpr size_t sums = C::SUMS_SMEM ? Sums<D, true>::kFloats : 0;
  static constexpr size_t bytes =
      2 * kv * sizeof(T) + 2 * stage_bytes + 2 * sums * 4;
};

// a query tile matters to key tile k0 unless the causal rule hides all of
// it from those keys and none of its rows sees no key
__device__ __forceinline__ bool q_tile_skipped(int q0, int rows, int k0,
                                               const Problem& pr) {
  const int offset = pr.Tk - pr.Tq;
  return pr.causal && min(q0 + rows, pr.Tq) - 1 + offset < k0 &&
         q0 + offset >= 0;
}

template <int R>
__device__ __forceinline__ int next_q_tile(int q0, int k0, const Problem& pr) {
  while (q0 < pr.Tq && q_tile_skipped(q0, R, k0, pr)) q0 += R;
  return q0;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const float* __restrict__ mask, T* __restrict__ dk,
                     T* __restrict__ dv, Problem pr, int BH) {
  using C = Cfg<T, D>;
  using S = DkvSmem<T, D>;
  constexpr int R = C::R, KS = C::KS, NQ = R / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = Ks + S::kv;
  unsigned char* stage0 = smem + 2 * S::kv * sizeof(T);
  float* sums_base = reinterpret_cast<float*>(stage0 + 2 * S::stage_bytes);
  Sums<D, C::SUMS_SMEM> dk_sum, dv_sum;
  dk_sum.init(sums_base);
  dv_sum.init(sums_base + S::sums);

  // heaviest first: every head's key tile 0, then tile 1, ...
  const int bh = blockIdx.x % BH;
  const int k0 = (blockIdx.x / BH) * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, m0 = warp * 16;
  const T* qb = q + (size_t)bh * pr.Tq * D;
  const T* ob = dout + (size_t)bh * pr.Tq * D;
  const float* lb = lse + (size_t)bh * pr.Tq;
  const float* db = delta + (size_t)bh * pr.Tq;
  const float* mb =
      mask ? mask + (size_t)(bh / pr.H) * (size_t)pr.mask_stride_b : nullptr;

  // a stage: Q, [Q lo], dO, [dO lo], lse, delta
  auto stage_q = [&](int s) {
    return reinterpret_cast<T*>(stage0 + s * S::stage_bytes);
  };
  auto load_stage = [&](int s, int q0) {
    T* Qs = stage_q(s);
    T* dOs = Qs + S::planes * S::q;
    float* ls = reinterpret_cast<float*>(dOs + S::planes * S::q);
    load_tile<T, D, R>(Qs, qb, q0, pr.Tq);
    load_tile<T, D, R>(dOs, ob, q0, pr.Tq);
    load_rows<R>(ls, lb, q0, pr.Tq, 0);
    load_rows<R>(ls + R, db, q0, pr.Tq, 1);
  };

  load_tile<T, D, kRows>(Ks, k + (size_t)bh * pr.Tk * D, k0, pr.Tk);
  load_tile<T, D, kRows>(Vs, v + (size_t)bh * pr.Tk * D, k0, pr.Tk);
  int q0 = next_q_tile<R>(0, k0, pr);
  if (q0 < pr.Tq) load_stage(0, q0);
  cp_async_commit();
  const auto Kv = resident<T, D>(Ks);
  const auto Vv = resident<T, D>(Vs);

  // a "k" mask (one row broadcast over queries) is fixed per key row
  const int kr[2] = {k0 + m0 + g, k0 + m0 + g + 8};
  float mk[2] = {0.f, 0.f};
  if (mb && pr.mask_stride_q == 0)
    for (int r = 0; r < 2; ++r) mk[r] = kr[r] < pr.Tk ? mb[kr[r]] : 0.f;

  const int offset = pr.Tk - pr.Tq;
  int cur = 0;
  while (q0 < pr.Tq) {
    const int qn = next_q_tile<R>(q0 + R, k0, pr);
    if (qn < pr.Tq) load_stage(cur ^ 1, qn);
    cp_async_commit();
    cp_async_wait<1>();   // everything but the tile just requested
    T* Qs = stage_q(cur);
    T* dOs = Qs + S::planes * S::q;
    const float* ls = reinterpret_cast<const float*>(dOs + S::planes * S::q);
    const float* ds = ls + R;
    if constexpr (C::PLANES) {
      split_tile<D, R>(Qs, Qs + S::q);
      split_tile<D, R>(dOs, dOs + S::q);
    }
    __syncthreads();
    const auto Qv = streamed<T, D>(Qs, Qs + S::q);
    const auto dOv = streamed<T, D>(dOs, dOs + S::q);

    // s^T = K Q^T and dp^T = V dO^T for the warp's 16 keys x R queries
    float st[NQ][4], dpt[NQ][4];
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D; kk += KS) {
      const auto aK = load_a(Kv, m0, kk);
      const auto aV = load_a(Vv, m0, kk);
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        mma(st[j], aK, load_b(Qv, 8 * j, kk));
        mma(dpt[j], aV, load_b(dOv, 8 * j, kk));
      }
    }

    const bool full = q0 + R <= pr.Tq && k0 + kRows <= pr.Tk &&
                      (!pr.causal || q0 + offset >= k0 + kRows - 1);
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * t + (e & 1), qg = q0 + col;
        const int kg = kr[e >> 1];
        float m = mk[e >> 1];
        if (mb && pr.mask_stride_q != 0 && qg < pr.Tq && kg < pr.Tk)
          m = mb[(size_t)qg * pr.mask_stride_q + kg];
        p_ds(st[j][e], dpt[j][e], qg, kg, ls[col], ds[col], m, full, pr);
      }

    // dV += p^T dO, dK += ds^T Q
    float inv_p[2] = {1.f, 1.f}, inv_ds[2] = {1.f, 1.f};
    if constexpr (kF16<T>) {
      scale_rows(st, inv_p);
      scale_rows(dpt, inv_ds);
    }
    if constexpr (C::PAIRED) {
      accumulate2<T, D>(dv_sum, st, dOv, dk_sum, dpt, Qv);
    } else {
      accumulate<T, D>(dv_sum, st, dOv, inv_p);
      accumulate<T, D>(dk_sum, dpt, Qv, inv_ds);
    }
    __syncthreads();   // this stage is refilled in the next iteration
    cur ^= 1;
    q0 = qn;
  }
  cp_async_wait<0>();

  store_rows<T, D>(dk + (size_t)bh * pr.Tk * D, dk_sum, kr[0], pr.Tk,
                   pr.scale);
  store_rows<T, D>(dv + (size_t)bh * pr.Tk * D, dv_sum, kr[0], pr.Tk, 1.f);
}

// ---- dQ ---------------------------------------------------------------------

template <typename T, int D>
struct DqSmem {
  using C = Cfg<T, D>;
  static constexpr size_t qd = (size_t)kRows * C::LD;   // Q or dO
  static constexpr size_t kt = (size_t)C::R * C::LD;    // K or V (a plane)
  static constexpr int planes = C::PLANES ? 2 : 1;
  static constexpr size_t stage_bytes = 2 * planes * kt * sizeof(T);
  static constexpr size_t sums = C::SUMS_SMEM ? Sums<D, true>::kFloats : 0;
  static constexpr size_t bytes =
      2 * qd * sizeof(T) + 2 * stage_bytes + sums * 4;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const float* __restrict__ mask, T* __restrict__ dq,
                    Problem pr, int BH) {
  using C = Cfg<T, D>;
  using S = DqSmem<T, D>;
  constexpr int R = C::R, KS = C::KS, NK = R / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* dOs = Qs + S::qd;
  unsigned char* stage0 = smem + 2 * S::qd * sizeof(T);
  Sums<D, C::SUMS_SMEM> dq_sum;
  dq_sum.init(reinterpret_cast<float*>(stage0 + 2 * S::stage_bytes));

  // heaviest first: every head's last query tile, then the one before, ...
  const int n_qt = (pr.Tq + kRows - 1) / kRows;
  const int bh = blockIdx.x % BH;
  const int q0 = (n_qt - 1 - (int)(blockIdx.x / BH)) * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, m0 = warp * 16;
  const T* kb = k + (size_t)bh * pr.Tk * D;
  const T* vb = v + (size_t)bh * pr.Tk * D;
  const float* mb =
      mask ? mask + (size_t)(bh / pr.H) * (size_t)pr.mask_stride_b : nullptr;
  const int offset = pr.Tk - pr.Tq;

  // a stage: K, [K lo], V, [V lo]
  auto stage_k = [&](int s) {
    return reinterpret_cast<T*>(stage0 + s * S::stage_bytes);
  };
  auto load_stage = [&](int s, int k0) {
    T* Ks = stage_k(s);
    load_tile<T, D, R>(Ks, kb, k0, pr.Tk);
    load_tile<T, D, R>(Ks + S::planes * S::kt, vb, k0, pr.Tk);
  };

  load_tile<T, D, kRows>(Qs, q + (size_t)bh * pr.Tq * D, q0, pr.Tq);
  load_tile<T, D, kRows>(dOs, dout + (size_t)bh * pr.Tq * D, q0, pr.Tq);
  // key tiles past the causal diagonal contribute nothing to dq (a row
  // that sees no key has ds = 0 everywhere)
  int k_end = pr.Tk;
  if (pr.causal) k_end = min(pr.Tk, min(q0 + kRows, pr.Tq) + offset);
  if (k_end > 0) load_stage(0, 0);
  cp_async_commit();
  const auto Qv = resident<T, D>(Qs);
  const auto dOv = resident<T, D>(dOs);

  // the thread's two query rows: lse, delta and the mask row
  const int qr[2] = {q0 + m0 + g, q0 + m0 + g + 8};
  float l[2], dl[2];
  const float* mrow[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool ok = qr[r] < pr.Tq;
    l[r] = ok ? lse[(size_t)bh * pr.Tq + qr[r]] : 0.f;
    dl[r] = ok ? delta[(size_t)bh * pr.Tq + qr[r]] : 0.f;
    mrow[r] = mb ? mb + (size_t)min(qr[r], pr.Tq - 1) * pr.mask_stride_q
                 : nullptr;
  }

  int cur = 0;
  for (int k0 = 0; k0 < k_end; k0 += R) {
    if (k0 + R < k_end) load_stage(cur ^ 1, k0 + R);
    cp_async_commit();
    cp_async_wait<1>();
    T* Ks = stage_k(cur);
    T* Vs = Ks + S::planes * S::kt;
    if constexpr (C::PLANES) {
      split_tile<D, R>(Ks, Ks + S::kt);
      split_tile<D, R>(Vs, Vs + S::kt);
    }
    __syncthreads();
    const auto Kv = streamed<T, D>(Ks, Ks + S::kt);
    const auto Vv = streamed<T, D>(Vs, Vs + S::kt);

    // s = Q K^T and dp = dO V^T for the warp's 16 queries x R keys
    float s[NK][4], dp[NK][4];
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D; kk += KS) {
      const auto aQ = load_a(Qv, m0, kk);
      const auto aO = load_a(dOv, m0, kk);
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        mma(s[j], aQ, load_b(Kv, 8 * j, kk));
        mma(dp[j], aO, load_b(Vv, 8 * j, kk));
      }
    }

    const bool full = q0 + kRows <= pr.Tq && k0 + R <= pr.Tk &&
                      (!pr.causal || q0 + offset >= k0 + R - 1);
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, kg = k0 + 8 * j + 2 * t + (e & 1);
        const float m =
            mb && qr[r] < pr.Tq && kg < pr.Tk ? mrow[r][kg] : 0.f;
        p_ds(s[j][e], dp[j][e], qr[r], kg, l[r], dl[r], m, full, pr);
      }

    // dQ += ds K
    float inv_ds[2] = {1.f, 1.f};
    if constexpr (kF16<T>) scale_rows(dp, inv_ds);
    accumulate<T, D>(dq_sum, dp, Kv, inv_ds);
    __syncthreads();   // this stage is refilled in the next iteration
    cur ^= 1;
  }
  cp_async_wait<0>();

  store_rows<T, D>(dq + (size_t)bh * pr.Tq * D, dq_sum, qr[0], pr.Tq,
                   pr.scale);
}

// ---- launches ---------------------------------------------------------------

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       const void* mask, void* dk, void* dv, int B,
                       const Problem& pr, cudaStream_t stream) {
  const size_t smem = DkvSmem<T, D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int BH = B * pr.H;
  const int n_kt = (pr.Tk + kRows - 1) / kRows;
  flash_bwd_dkv_kernel<T, D><<<n_kt * BH, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const float*>(mask), static_cast<T*>(dk),
      static_cast<T*>(dv), pr, BH);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      const void* mask, void* dq, int B, const Problem& pr,
                      cudaStream_t stream) {
  const size_t smem = DqSmem<T, D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int BH = B * pr.H;
  const int n_qt = (pr.Tq + kRows - 1) / kRows;
  flash_bwd_dq_kernel<T, D><<<n_qt * BH, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const float*>(mask), static_cast<T*>(dq), pr, BH);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16; q/k/v/dout/dk/dv in that
// dtype, dense (B, H, T, D). lse and delta are float32 (B, H, Tq); mask is
// float32 or null with the forward's strides (see ptt_flash_attention_fwd).
// Returns a cudaError_t.
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
  if (dtype == 2 && D == 64)
    return launch_dkv<__half, 64>(q, k, v, dout, lse, delta, mask, dk, dv, B,
                                  pr, s);
  if (dtype == 2 && D == 128)
    return launch_dkv<__half, 128>(q, k, v, dout, lse, delta, mask, dk, dv,
                                   B, pr, s);
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
  if (dtype == 2 && D == 64)
    return launch_dq<__half, 64>(q, k, v, dout, lse, delta, mask, dq, B, pr,
                                 s);
  if (dtype == 2 && D == 128)
    return launch_dq<__half, 128>(q, k, v, dout, lse, delta, mask, dq, B, pr,
                                  s);
  return (int)cudaErrorInvalidValue;
}
