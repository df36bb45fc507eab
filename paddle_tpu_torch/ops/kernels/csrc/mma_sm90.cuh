// Warp-level building blocks of the port's tensor-core kernels on Hopper
// (sm_90a): cp.async copies, the 3xTF32 split, mma.sync fragments of
// tiles in shared memory (f32 as tf32 hi/lo pairs, bf16, fp16) and the mma
// wrappers. Shared by flash_attention_bwd.cu and fused_head_bwd.cu.
//
// 3xTF32: an f32 value x enters a product as hi = tf32(x) and lo =
// tf32(x - hi), both rounded to nearest with ties away from zero on the
// low 13 bits (the rounding of cvt.rna.tf32.f32, as one integer add and
// one mask, exact for finite inputs); a product is lo*hi + hi*lo +
// hi*hi, three m16n8k8 mma with f32 accumulation, dropping only lo*lo
// (~2^-22 relative). Never single-pass TF32.
//
// fp16 hi/lo pair: an f32 value x that is not an input (p, ds) enters an
// fp16 product as hi = fp16(x), lo = fp16(x - hi), ~22 significant bits,
// two m16n8k16 mma (lo first); the caller keeps x inside fp16's range.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace ptt_mma {

// ---- cp.async --------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes, or 16 zeros when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---- 3xTF32 split -----------------------------------------------------------

// x rounded to tf32 (10 mantissa bits), to nearest, ties away from zero:
// cvt.rna.tf32.f32 for finite x
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// tf32(x) that keeps the card's canonical NaN (0x7fffffff, what its
// arithmetic produces): the add would carry it into the sign bit, giving
// -0, and the NaN would vanish from the product. Clamped below the carry
// first (a min as signed ints, which leaves every finite, infinite and
// negative value as it is): one instruction more. Only a NaN with the sign
// bit and high payload bits set (a sign flip of that NaN) still rounds to
// 0.
__device__ __forceinline__ uint32_t tf32_keep_nan(float x) {
  const int b = min(__float_as_int(x), 0x7fffefff);
  return (static_cast<uint32_t>(b) + 0x1000u) & 0xffffe000u;
}

// hi carries x's NaN into the products; lo of a NaN is then irrelevant
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_keep_nan(x);
  lo = tf32(x - __uint_as_float(hi));
}

// ---- fragments and mma -----------------------------------------------------
// Thread layout of m16n8 (PTX ISA, mma.m16n8k8 / m16n8k16): lane = 4g + t;
// accumulator c0, c1 at (row g, cols 2t, 2t+1), c2, c3 at (row g + 8, the
// same cols).

struct A32 { uint32_t hi[4], lo[4]; };
struct B32 { uint32_t hi[2], lo[2]; };
// 16-bit fragments, by element type E (__nv_bfloat16 or __half)
template <typename E> struct A16T { uint32_t r[4]; };
template <typename E> struct B16T { uint32_t r[2]; };
using A16 = A16T<__nv_bfloat16>;
using B16 = B16T<__nv_bfloat16>;
using AH = A16T<__half>;
using BH = B16T<__half>;
struct AH2 { AH hi, lo; };   // an fp16 hi/lo pair

// Views of a tile in shared memory, row stride ld: f32 split at fragment
// load, f32 split into planes, bf16 or fp16.
struct V32 { const float* p; int ld; };
struct P32 { const float* hi; const float* lo; int ld; };
template <typename E> struct V16T { const E* p; int ld; };
using V16 = V16T<__nv_bfloat16>;

// the A fragment of a product whose A is computed (p, ds), by input type
template <typename T> struct Frag;
template <> struct Frag<float> { using A = A32; };
template <> struct Frag<__nv_bfloat16> { using A = A16; };
template <> struct Frag<__half> { using A = AH2; };

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 3xTF32: the small cross terms first, then hi*hi
__device__ __forceinline__ void mma(float (&c)[4], const A32& a,
                                    const B32& b) {
  mma_tf32(c, a.lo, b.hi);
  mma_tf32(c, a.hi, b.lo);
  mma_tf32(c, a.hi, b.hi);
}

__device__ __forceinline__ void mma(float (&c)[4], const A16& a,
                                    const B16& b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a.r[0]), "r"(a.r[1]), "r"(a.r[2]), "r"(a.r[3]), "r"(b.r[0]),
        "r"(b.r[1]));
}

__device__ __forceinline__ void mma(float (&c)[4], const AH& a,
                                    const BH& b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a.r[0]), "r"(a.r[1]), "r"(a.r[2]), "r"(a.r[3]), "r"(b.r[0]),
        "r"(b.r[1]));
}

// an fp16 hi/lo pair: the small term first
__device__ __forceinline__ void mma(float (&c)[4], const AH2& a,
                                    const BH& b) {
  mma(c, a.lo, b);
  mma(c, a.hi, b);
}

// four 8 x 16-byte blocks, row addresses from lanes 8i..8i+7 for block i;
// the lane gets 32-bit word t of row g of each block (for f32 data: the
// element (g, t) of an 8 x 4 block)
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

template <typename E>
__device__ __forceinline__ uint32_t word(const E* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x, y) as an fp16 hi/lo pair of packed words (see the header)
__device__ __forceinline__ void split_h2(float x, float y, uint32_t& hi,
                                         uint32_t& lo) {
  const __half2 h = __floats2half2_rn(x, y);
  const float2 hf = __half22float2(h);
  const __half2 l = __floats2half2_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }

// A (16 x KS) from a row-major tile Y[m][k] (m = m0.., k = k0..)
__device__ __forceinline__ A32 load_a(const V32& y, int m0, int k0) {
  const int l = lane_id();
  uint32_t r[4];
  ldsm_x4(r, y.p + (m0 + (l & 7) + (l & 8)) * y.ld + k0 + (l >> 4) * 4);
  A32 a;
#pragma unroll
  for (int i = 0; i < 4; ++i) split(__uint_as_float(r[i]), a.hi[i], a.lo[i]);
  return a;
}

template <typename E>
__device__ __forceinline__ A16T<E> load_a(const V16T<E>& y, int m0, int k0) {
  const int g = lane_id() >> 2, t = lane_id() & 3;
  const E* p = y.p + (m0 + g) * y.ld + k0 + 2 * t;
  return A16T<E>{{word(p), word(p + 8 * y.ld), word(p + 8),
                  word(p + 8 * y.ld + 8)}};
}

// B (KS x 8) from a tile stored n-major, X[n][k] (s = q k^T: X = K)
__device__ __forceinline__ B32 load_b(const V32& x, int n0, int k0) {
  const int g = lane_id() >> 2, t = lane_id() & 3;
  const float* p = x.p + (n0 + g) * x.ld + k0 + t;
  B32 b;
  split(p[0], b.hi[0], b.lo[0]);
  split(p[4], b.hi[1], b.lo[1]);
  return b;
}

__device__ __forceinline__ B32 load_b(const P32& x, int n0, int k0) {
  const int l = lane_id();
  const float* plane = l & 16 ? x.lo : x.hi;
  uint32_t r[4];
  ldsm_x4(r, plane + (n0 + (l & 7)) * x.ld + k0 + (l & 8) / 2);
  return B32{{r[0], r[1]}, {r[2], r[3]}};
}

template <typename E>
__device__ __forceinline__ B16T<E> load_b(const V16T<E>& x, int n0, int k0) {
  const int g = lane_id() >> 2, t = lane_id() & 3;
  const E* p = x.p + (n0 + g) * x.ld + k0 + 2 * t;
  return B16T<E>{{word(p), word(p + 8)}};
}

// B (KS x 8) from a tile stored k-major, X[k][n] (dv = p^T dO: X = dO).
// f32: the k order inside the 8-deep step is permuted (slot t <-> k = 2t,
// slot t + 4 <-> k = 2t + 1) to match a_from_c below; a sum does not care
// in which order its 8 terms enter one mma.
__device__ __forceinline__ B32 load_bt(const V32& x, int k0, int n0) {
  const int g = lane_id() >> 2, t = lane_id() & 3;
  const float* p = x.p + (k0 + 2 * t) * x.ld + n0 + g;
  B32 b;
  split(p[0], b.hi[0], b.lo[0]);
  split(p[x.ld], b.hi[1], b.lo[1]);
  return b;
}

__device__ __forceinline__ B32 load_bt(const P32& x, int k0, int n0) {
  const int g = lane_id() >> 2, t = lane_id() & 3;
  const int off = (k0 + 2 * t) * x.ld + n0 + g;
  return B32{{__float_as_uint(x.hi[off]), __float_as_uint(x.hi[off + x.ld])},
             {__float_as_uint(x.lo[off]), __float_as_uint(x.lo[off + x.ld])}};
}

// bf16, fp16: ldmatrix.trans of the two 8 x 8 blocks (k0.., k0 + 8..) x
// (n0..)
template <typename E>
__device__ __forceinline__ B16T<E> load_bt(const V16T<E>& x, int k0, int n0) {
  const E* p = x.p + (k0 + (lane_id() & 15)) * x.ld + n0;
  B16T<E> b;
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(b.r[0]), "=r"(b.r[1])
      : "r"(smem_addr(p))
      : "memory");
  return b;
}

// A (16 x KS) from accumulator tiles c[n][4] (columns 8n..8n+7), as the
// k-step kc: f32 takes tile kc (with the permuted k order of load_bt),
// bf16 tiles 2kc and 2kc + 1, rounded to bf16, fp16 the same tiles as an
// fp16 hi/lo pair.
template <int N>
__device__ __forceinline__ void a_from_c(A32& a, const float (&c)[N][4],
                                         int kc) {
  split(c[kc][0], a.hi[0], a.lo[0]);
  split(c[kc][2], a.hi[1], a.lo[1]);
  split(c[kc][1], a.hi[2], a.lo[2]);
  split(c[kc][3], a.hi[3], a.lo[3]);
}

template <int N>
__device__ __forceinline__ void a_from_c(A16& a, const float (&c)[N][4],
                                         int kc) {
  a.r[0] = pack_bf16(c[2 * kc][0], c[2 * kc][1]);
  a.r[1] = pack_bf16(c[2 * kc][2], c[2 * kc][3]);
  a.r[2] = pack_bf16(c[2 * kc + 1][0], c[2 * kc + 1][1]);
  a.r[3] = pack_bf16(c[2 * kc + 1][2], c[2 * kc + 1][3]);
}

template <int N>
__device__ __forceinline__ void a_from_c(AH2& a, const float (&c)[N][4],
                                         int kc) {
  split_h2(c[2 * kc][0], c[2 * kc][1], a.hi.r[0], a.lo.r[0]);
  split_h2(c[2 * kc][2], c[2 * kc][3], a.hi.r[1], a.lo.r[1]);
  split_h2(c[2 * kc + 1][0], c[2 * kc + 1][1], a.hi.r[2], a.lo.r[2]);
  split_h2(c[2 * kc + 1][2], c[2 * kc + 1][3], a.hi.r[3], a.lo.r[3]);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(__half* p, float a, float b) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(a, b);
}

}  // namespace ptt_mma
