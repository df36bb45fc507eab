// What wgmma gives on the card, through the port's own helpers
// (paddle_tpu_torch/ops/kernels/csrc/wgmma_sm90.cuh):
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//       -o build/wgmma_rate tools/wgmma_rate.cu && build/wgmma_rate
//
// 1. Checks: products formed by the helpers as the port's kernels form
//    them, against a host reference in double. m64n8k8 tf32 with both
//    operands by descriptor (one pass, operands exact in tf32: the
//    descriptor alone); m64n64k8 and m64n128k8 3xTF32 over two K-blocks
//    (operand planes, k-steps inside and across the swizzled blocks);
//    m64n64k8 3xTF32 with A from registers in accumulator layout and B
//    written transposed in perm8 order (attention's P V); the same three
//    in bf16 (m64nNk16). One line each: max |got - want| / max |want|.
// 2. Rates: m64n128k8 tf32 and m64n128k16 bf16 with both operands in
//    shared memory, m64n64k8 tf32 with A from registers, 1-3 warpgroups
//    a block and one block an SM, in TFLOP/s over all SMs.
//
// The last line is "ok" when every check is within 1e-5 (f32) / 1e-2
// (bf16) of the largest magnitude; the exit code is 0 only then.
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <algorithm>
#include <vector>

#include "../paddle_tpu_torch/ops/kernels/csrc/wgmma_sm90.cuh"

using namespace ptt_wgmma;

// ---- checks ----------------------------------------------------------------

// d (64 x N) = a (64 x K) . b^T (b: N x K) [ss], or a . b (b: K x N) [rs],
// one warpgroup. f32: 3xTF32 unless one_pass; bf16: the inputs rounded.
template <bool BF16, bool RS, int N, int K>
__global__ void check_kernel(const float* a, const float* b, float* d,
                             bool one_pass) {
  constexpr int EL = BF16 ? 2 : 4;
  constexpr int KB = K * EL;                 // bytes along K
  constexpr int STEP = 32;                   // bytes a k-step
  constexpr int KBP = KB < kSwizzleBytes ? kSwizzleBytes : KB;  // a row
  extern __shared__ char smem_raw[];
  char* base = align_atom(smem_raw);
  char* a_hi = base;
  char* a_lo = a_hi + 64 * KBP;
  char* b_hi = a_lo + 64 * KBP;
  char* b_lo = b_hi + N * KBP;
  const int tid = threadIdx.x;
  for (int i = tid; i < 64 * K / 4; i += 128) {     // a: K-major planes
    const int r = i / (K / 4), k = 4 * (i % (K / 4));
    const float4 x = *reinterpret_cast<const float4*>(a + r * K + k);
    if (BF16) {
      __nv_bfloat16 v[8];
      for (int j = 0; j < 4; ++j) v[j] = __float2bfloat16((&x.x)[j]);
      *reinterpret_cast<uint2*>(a_hi + sw128(64, r, 2 * k)) =
          *reinterpret_cast<uint2*>(v);
    } else {
      put4_split(a_hi, a_lo, 64, r, k, x);
    }
  }
  for (int i = tid; i < N * K; i += 128) {
    if (RS) {                                  // b: K x N, stored transposed
      const int k = i / N, n = i % N;
      if (BF16)
        put_t(b_hi, N, n, k, __float2bfloat16(b[i]));
      else
        put_t_split(b_hi, b_lo, N, n, k, b[i]);
    } else {                                   // b: N x K, K-major
      const int n = i / K, k = i % K;
      if (BF16) {
        *reinterpret_cast<__nv_bfloat16*>(b_hi + sw128(N, n, 2 * k)) =
            __float2bfloat16(b[i]);
      } else {
        uint32_t h, l;
        ptt_mma::split(b[i], h, l);
        *reinterpret_cast<uint32_t*>(b_hi + sw128(N, n, 4 * k)) = h;
        *reinterpret_cast<uint32_t*>(b_lo + sw128(N, n, 4 * k)) = l;
      }
    }
  }
  fence_proxy_async();
  __syncthreads();
  const int w = tid / 32, g = (tid & 31) / 4, q = tid & 3;
  const int r0 = 16 * w + g, r1 = r0 + 8;
  float acc[N / 2];   // garbage: the first k-step starts from zero
  for (int i = 0; i < N / 2; ++i) acc[i] = NAN;
  fence();
  for (int s = 0; s < KB / STEP; ++s) {
    const int kb = s * STEP, sc = s > 0;
    const uint64_t db_hi = desc_k(b_hi, N, kb), db_lo = desc_k(b_lo, N, kb);
    if constexpr (RS) {
      uint32_t hi[4], lo[4];
      if constexpr (BF16) {
        const int c = 16 * s + 2 * q;
        float x[4] = {a[r0 * K + c], a[r0 * K + c + 1], a[r1 * K + c],
                      a[r1 * K + c + 1]};
        float y[4] = {a[r0 * K + c + 8], a[r0 * K + c + 9],
                      a[r1 * K + c + 8], a[r1 * K + c + 9]};
        a_from_acc(hi, x, y);
        fence();
        mma_bf16_rs<N>(acc, hi, db_hi, sc);
      } else {
        const int c = 8 * s + 2 * q;
        a_from_acc(hi, lo, a[r0 * K + c], a[r0 * K + c + 1], a[r1 * K + c],
                   a[r1 * K + c + 1]);
        fence();
        mma_tf32_rs<N>(acc, lo, db_hi, sc);
        mma_tf32_rs<N>(acc, hi, db_lo, 1);
        mma_tf32_rs<N>(acc, hi, db_hi, 1);
      }
      commit();
      wait<0>();
      fence_operand(hi);
      fence_operand(lo);
    } else {
      const uint64_t da_hi = desc_k(a_hi, 64, kb), da_lo = desc_k(a_lo, 64, kb);
      if constexpr (BF16) {
        mma_bf16_ss<N>(acc, da_hi, db_hi, sc);
      } else {
        if (!one_pass) {
          mma_tf32_ss<N>(acc, da_lo, db_hi, sc);
          mma_tf32_ss<N>(acc, da_hi, db_lo, 1);
        }
        mma_tf32_ss<N>(acc, da_hi, db_hi, one_pass ? sc : 1);
      }
    }
  }
  commit();
  wait<0>();
  fence_operand(acc);
  for (int j = 0; j < N / 8; ++j) {
    const int c = 8 * j + 2 * q;
    d[r0 * N + c] = acc[4 * j];
    d[r0 * N + c + 1] = acc[4 * j + 1];
    d[r1 * N + c] = acc[4 * j + 2];
    d[r1 * N + c + 1] = acc[4 * j + 3];
  }
}

static float round_tf32(float x) {     // host: x rounded to tf32, as split
  uint32_t u;
  memcpy(&u, &x, 4);
  u = (u + 0x1000u) & 0xffffe000u;
  memcpy(&x, &u, 4);
  return x;
}

static float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

template <bool BF16, bool RS, int N, int K>
static bool check(const char* name, bool one_pass = false) {
  std::vector<float> a(64 * K), b(N * K), d(64 * N);
  srand(N * 7 + K + RS * 3 + BF16);
  for (auto& x : a) x = (rand() / (float)RAND_MAX - 0.5f) * 4.f;
  for (auto& x : b) x = (rand() / (float)RAND_MAX - 0.5f) * 4.f;
  if (one_pass) {
    for (auto& x : a) x = round_tf32(x);
    for (auto& x : b) x = round_tf32(x);
  }
  if (BF16) {
    for (auto& x : a) x = round_bf16(x);
    for (auto& x : b) x = round_bf16(x);
  }
  float *da, *db, *dd;
  cudaMalloc(&da, a.size() * 4);
  cudaMalloc(&db, b.size() * 4);
  cudaMalloc(&dd, d.size() * 4);
  cudaMemcpy(da, a.data(), a.size() * 4, cudaMemcpyHostToDevice);
  cudaMemcpy(db, b.data(), b.size() * 4, cudaMemcpyHostToDevice);
  cudaMemset(dd, 0xff, d.size() * 4);
  const int smem = 2 * (64 + N) * std::max(K * 4, kSwizzleBytes) + kAtomBytes;
  auto kern = check_kernel<BF16, RS, N, K>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  kern<<<1, 128, smem>>>(da, db, dd, one_pass);
  cudaError_t err = cudaDeviceSynchronize();
  cudaMemcpy(d.data(), dd, d.size() * 4, cudaMemcpyDeviceToHost);
  cudaFree(da);
  cudaFree(db);
  cudaFree(dd);
  double worst = 0, big = 0;
  for (int m = 0; m < 64; ++m)
    for (int n = 0; n < N; ++n) {
      double s = 0;
      for (int k = 0; k < K; ++k)
        s += (double)a[m * K + k] * (RS ? b[k * N + n] : b[n * K + k]);
      big = fmax(big, fabs(s));
      const double e = fabs(s - d[m * N + n]);
      worst = std::isnan(e) ? INFINITY : fmax(worst, e);
    }
  const double rel = worst / big;
  const bool ok = err == cudaSuccess && rel <= (BF16 ? 1e-2 : 1e-5);
  printf("check %-34s %s rel_err %.3e %s\n", name, cudaGetErrorString(err),
         rel, ok ? "ok" : "FAILED");
  return ok;
}

// ---- rates -----------------------------------------------------------------

template <int KIND>   // 0: tf32 ss n128, 1: bf16 ss n128, 2: tf32 rs n64
__global__ void rate_kernel(float* out, int iters) {
  constexpr int N = KIND == 2 ? 64 : 128;
  extern __shared__ char smem_raw[];
  char* base = align_atom(smem_raw);
  const int wg = threadIdx.x / 128;
  char* a = base + wg * 64 * kSwizzleBytes;
  char* b = base + 4 * 64 * kSwizzleBytes;
  for (int i = threadIdx.x; i < (4 * 64 + N) * kSwizzleBytes / 4;
       i += blockDim.x)
    reinterpret_cast<float*>(base)[i] = 0.f;
  fence_proxy_async();
  __syncthreads();
  float acc[N / 2];
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  uint32_t ar[4] = {0, 0, 0, 0};
  fence();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const uint64_t db = desc_k(b, N, 32 * s);
      if constexpr (KIND == 0)
        mma_tf32_ss<N>(acc, desc_k(a, 256, 32 * s), db, 1);
      if constexpr (KIND == 1)
        mma_bf16_ss<N>(acc, desc_k(a, 256, 32 * s), db, 1);
      if constexpr (KIND == 2) mma_tf32_rs<N>(acc, ar, db, 1);
    }
    commit();
    wait<1>();
  }
  wait<0>();
  fence_operand(acc);
  float s = 0.f;
  for (int i = 0; i < N / 2; ++i) s += acc[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <int KIND>
static void rate(int wgs) {
  constexpr int N = KIND == 2 ? 64 : 128;
  constexpr double flops_per = 2.0 * 64 * N * (KIND == 1 ? 16 : 8);
  int sms;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  float* out;
  cudaMalloc(&out, sms * 512 * 4);
  auto kern = rate_kernel<KIND>;
  // more than half the SM's shared memory: one block an SM
  const int big = 120 * 1024;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       big);
  kern<<<sms, 128 * wgs, big>>>(out, 100);
  const int iters = 20000;
  cudaEvent_t s, e;
  cudaEventCreate(&s);
  cudaEventCreate(&e);
  cudaEventRecord(s);
  kern<<<sms, 128 * wgs, big>>>(out, iters);
  cudaEventRecord(e);
  cudaEventSynchronize(e);
  float ms;
  cudaEventElapsedTime(&ms, s, e);
  const double flops = (double)sms * wgs * iters * 4 * flops_per;
  const char* names[] = {"tf32 ss m64n128k8", "bf16 ss m64n128k16",
                         "tf32 rs m64n64k8"};
  printf("rate %s warpgroups %d: %.1f TFLOP/s (%s)\n", names[KIND], wgs,
         flops / ms / 1e9, cudaGetErrorString(cudaGetLastError()));
  cudaFree(out);
}

int main() {
  bool ok = true;
  ok &= check<false, false, 8, 8>("tf32 ss m64n8k8 one pass", true);
  ok &= check<false, false, 64, 64>("tf32 ss m64n64k8 3xTF32 K=64");
  ok &= check<false, false, 128, 64>("tf32 ss m64n128k8 3xTF32 K=64");
  ok &= check<false, true, 64, 64>("tf32 rs m64n64k8 3xTF32 K=64");
  ok &= check<false, true, 128, 32>("tf32 rs m64n128k8 3xTF32 K=32");
  ok &= check<true, false, 64, 128>("bf16 ss m64n64k16 K=128");
  ok &= check<true, false, 128, 64>("bf16 ss m64n128k16 K=64");
  ok &= check<true, true, 64, 64>("bf16 rs m64n64k16 K=64");
  ok &= check<true, true, 128, 64>("bf16 rs m64n128k16 K=64");
  for (int wgs = 1; wgs <= 3; ++wgs) rate<0>(wgs);
  for (int wgs = 1; wgs <= 3; ++wgs) rate<1>(wgs);
  for (int wgs = 1; wgs <= 3; ++wgs) rate<2>(wgs);
  printf("%s\n", ok ? "ok" : "FAILED");
  return ok ? 0 : 1;
}
