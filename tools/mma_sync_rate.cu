// The rate mma.sync reaches on the card with operands already in registers:
// every warp of one block an SM runs m16n8k8 tf32 or m16n8k16 bf16 mma
// into 1-16 independent accumulators. It is the ceiling of the port's
// mma.sync kernels (flash_attention_bwd.cu, fused_head_bwd.cu), below the
// data sheet's dense rates, which only wgmma reaches.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o mma_sync_rate \
//       tools/mma_sync_rate.cu && ./mma_sync_rate
//
// Prints one line per (type, threads a block, chains a warp, integer ALU
// operations placed beside each mma) with the TFLOP/s over all SMs: the
// last shows how far other work at the same scheduler takes from the mma
// rate.
#include <cstdio>
#include <cstdint>
#include <cuda_runtime.h>
template <int NACC, bool BF16, int ALU>
__global__ void k(float* out, int iters) {
  float c[NACC][4];
  for (int i = 0; i < NACC; ++i) for (int e = 0; e < 4; ++e) c[i][e] = 0.f;
  uint32_t a[4] = {threadIdx.x, threadIdx.x + 1, threadIdx.x + 2, threadIdx.x + 3};
  uint32_t b[2] = {threadIdx.x * 3, threadIdx.x * 5};
  uint32_t z[4] = {threadIdx.x, threadIdx.x * 7, threadIdx.x * 11, threadIdx.x * 13};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < NACC; ++i) {
      // ALU groups of three integer operations beside each mma (the tf32
      // rounding of a split is such an add and a mask)
#pragma unroll
      for (int j = 0; j < ALU; ++j)
        z[j % 4] = ((z[j % 4] + 0x1000u) & 0xffffe000u) ^ (uint32_t)it;
      if (BF16)
        asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+f"(c[i][0]), "+f"(c[i][1]), "+f"(c[i][2]), "+f"(c[i][3]) : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
      else
        asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+f"(c[i][0]), "+f"(c[i][1]), "+f"(c[i][2]), "+f"(c[i][3]) : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
    }
  }
  float s = __uint_as_float(z[0] ^ z[1] ^ z[2] ^ z[3]);
  for (int i = 0; i < NACC; ++i) for (int e = 0; e < 4; ++e) s += c[i][e];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
template <int NACC, bool BF16, int ALU = 0> void run(int threads) {
  float* out; int sms; cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  cudaMalloc(&out, sms * 1024 * 4);
  int iters = 20000;
  k<NACC, BF16, ALU><<<sms, threads>>>(out, 100);
  cudaEvent_t s, e; cudaEventCreate(&s); cudaEventCreate(&e);
  cudaEventRecord(s); k<NACC, BF16, ALU><<<sms, threads>>>(out, iters); cudaEventRecord(e); cudaEventSynchronize(e);
  float ms; cudaEventElapsedTime(&ms, s, e);
  double flops = (double)sms * (threads / 32) * iters * NACC * (BF16 ? 4096.0 : 2048.0);
  printf("%s threads %d chains %d alu %d: %.1f TFLOP/s\n", BF16 ? "bf16 m16n8k16" : "tf32 m16n8k8", threads, NACC, 3 * ALU, flops / ms / 1e9);
  cudaFree(out);
}
int main() {
  run<1, false>(256); run<2, false>(256); run<4, false>(256); run<8, false>(256); run<16, false>(256);
  run<4, false>(512); run<8, false>(512); run<8, false>(128);
  run<8, false, 1>(256); run<8, false, 2>(256); run<8, false, 4>(256); run<8, false, 8>(256);
  run<8, false, 2>(512); run<8, false, 4>(512);
  run<1, true>(256); run<4, true>(256); run<8, true>(256); run<16, true>(256); run<8, true>(512);
  return 0;
}
