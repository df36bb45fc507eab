// The numeric guard's kernels for Hopper (sm_90a), plain C interface.
//
// Replaces the XLA code of the JAX package's numeric guard
// (paddle_tpu/framework/executor.py): the per-var finite mask of
// _make_step (:707-718, one jnp.all(jnp.isfinite(v)) per fetch and state
// var) and _skip_guard's revert (:101-114, one jnp.where per state leaf).
// Neither is a Pallas kernel there; here they are one launch each
// instead of one reduction (or one select) per tensor, which for the
// BERT recipe's ~620 state tensors would be ~1,900 kernels a step.
//
// finite_flags: over a table of tensors (pointer, element count, dtype,
// first chunk), sets flags[i] = 1 when tensor i holds a NaN or an Inf,
// flags[n] = 1 when any does, and flags[n + 1] = 1 (the sticky byte, only
// ever set here) likewise; flags[0..n] are zeroed by the entry first. A
// value is non-finite when its exponent bits are all ones, so the test is
// an integer mask on the raw bits for every float dtype.
//
// guarded_copy: over a table of (source, destination, bytes, first
// chunk), copies every source to its destination; with a gate, only when
// *gate is non-zero (each block reads the gate first and returns on a
// clean step). The guard backs up the persistables a step writes with it
// (no gate) at the start of the step and restores them (gated on the
// sticky byte) at its end, inside the captured step, with no host branch.
//
// What bounds them on the H100: the bytes. finite_flags reads each
// element once (BERT-base's recipe state ~1.1 GB, ~0.33 ms at 3.35 TB/s);
// the backup reads and writes it (~0.66 ms); the gated restore of a clean
// step moves one byte a block.
//
// Design: the tensors are cut into fixed chunks (kFiniteChunk elements,
// kCopyChunk bytes); a block takes chunks in a grid-stride loop and finds
// a chunk's tensor by a binary search of the table's first-chunk column.
// A chunk whose address is 16-byte aligned moves 16-byte vectors, the
// widest plain load; the rest goes element by element.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kFiniteChunk = 16384;       // elements
constexpr long long kCopyChunk = 1 << 18;       // bytes
constexpr int kMaxBlocks = 132 * 8;

// row i of a table of 4 int64 columns: [pointer(s), count, code, chunk0]
__device__ __forceinline__ int find_entry(const long long* table, int n,
                                          long long chunk) {
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (table[4 * mid + 3] <= chunk) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// all-ones exponent test on raw bits, per dtype code
// (0 float32, 1 bfloat16, 2 float16, 3 float64)
__device__ __forceinline__ bool bad32(uint32_t b) {
  return (b & 0x7f800000u) == 0x7f800000u;
}
__device__ __forceinline__ bool bad_bf16(uint32_t h) {
  return (h & 0x7f80u) == 0x7f80u;
}
__device__ __forceinline__ bool bad_f16(uint32_t h) {
  return (h & 0x7c00u) == 0x7c00u;
}
__device__ __forceinline__ bool bad64(uint64_t b) {
  return (b & 0x7ff0000000000000ull) == 0x7ff0000000000000ull;
}

// one 16-byte vector of dtype `code`: any non-finite lane
__device__ __forceinline__ bool bad_vec(uint4 v, int code) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  bool bad = false;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (code == 0) {
      bad |= bad32(w[k]);
    } else if (code == 1) {
      bad |= bad_bf16(w[k] & 0xffffu) | bad_bf16(w[k] >> 16);
    } else if (code == 2) {
      bad |= bad_f16(w[k] & 0xffffu) | bad_f16(w[k] >> 16);
    }
  }
  if (code == 3) {
    bad = bad64(((uint64_t)v.y << 32) | v.x) |
          bad64(((uint64_t)v.w << 32) | v.z);
  }
  return bad;
}

__device__ __forceinline__ bool bad_one(const char* p, int code) {
  if (code == 0) return bad32(*reinterpret_cast<const uint32_t*>(p));
  if (code == 1) return bad_bf16(*reinterpret_cast<const uint16_t*>(p));
  if (code == 2) return bad_f16(*reinterpret_cast<const uint16_t*>(p));
  return bad64(*reinterpret_cast<const uint64_t*>(p));
}

__device__ __forceinline__ int elem_bytes(int code) {
  return code == 0 ? 4 : code == 3 ? 8 : 2;
}

__global__ void __launch_bounds__(kThreads)
finite_kernel(const long long* __restrict__ table, int n,
              long long total_chunks, unsigned char* __restrict__ flags) {
  for (long long c = blockIdx.x; c < total_chunks; c += gridDim.x) {
    const int t = find_entry(table, n, c);
    const char* base = reinterpret_cast<const char*>(table[4 * t]);
    const long long count = table[4 * t + 1];
    const int code = (int)table[4 * t + 2];
    const int es = elem_bytes(code);
    const long long first = (c - table[4 * t + 3]) * kFiniteChunk;
    long long len = count - first;
    if (len > kFiniteChunk) len = kFiniteChunk;
    const char* p = base + first * es;
    bool bad = false;
    const long long nbytes = len * es;
    long long done = 0;
    if (((uintptr_t)p & 15u) == 0) {
      const long long nvec = nbytes / 16;
      const uint4* v = reinterpret_cast<const uint4*>(p);
      for (long long i = threadIdx.x; i < nvec; i += kThreads)
        bad |= bad_vec(v[i], code);
      done = nvec * 16;
    }
    for (long long off = done + (long long)threadIdx.x * es; off < nbytes;
         off += (long long)kThreads * es)
      bad |= bad_one(p + off, code);
    if (__syncthreads_or(bad) && threadIdx.x == 0) {
      flags[t] = 1;
      flags[n] = 1;
      flags[n + 1] = 1;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
copy_kernel(const long long* __restrict__ table, int n, long long total_chunks,
            const unsigned char* __restrict__ gate) {
  if (gate != nullptr && *gate == 0) return;
  for (long long c = blockIdx.x; c < total_chunks; c += gridDim.x) {
    const int t = find_entry(table, n, c);
    const char* src = reinterpret_cast<const char*>(table[4 * t]);
    char* dst = reinterpret_cast<char*>(table[4 * t + 1]);
    const long long nbytes = table[4 * t + 2];
    const long long first = (c - table[4 * t + 3]) * kCopyChunk;
    long long len = nbytes - first;
    if (len > kCopyChunk) len = kCopyChunk;
    const char* s = src + first;
    char* d = dst + first;
    long long done = 0;
    if ((((uintptr_t)s | (uintptr_t)d) & 15u) == 0) {
      const long long nvec = len / 16;
      const uint4* sv = reinterpret_cast<const uint4*>(s);
      uint4* dv = reinterpret_cast<uint4*>(d);
      for (long long i = threadIdx.x; i < nvec; i += kThreads) dv[i] = sv[i];
      done = nvec * 16;
    }
    for (long long i = done + threadIdx.x; i < len; i += kThreads) d[i] = s[i];
  }
}

int grid_for(long long chunks) {
  return (int)(chunks < kMaxBlocks ? chunks : kMaxBlocks);
}

}  // namespace

// The chunk sizes the host cuts its tables by.
extern "C" long long ptt_finite_chunk() { return kFiniteChunk; }
extern "C" long long ptt_copy_chunk() { return kCopyChunk; }

// table: n rows of 4 int64 on the device, [data pointer, element count,
// dtype code (0 float32, 1 bfloat16, 2 float16, 3 float64), first chunk
// (the chunks of the rows before it)]; total_chunks: the chunks of all
// rows. flags: n + 2 bytes on the device; flags[0..n] are zeroed here.
// Returns a cudaError_t.
extern "C" int ptt_finite_flags(const void* table, int n,
                                long long total_chunks, void* flags,
                                void* stream) {
  if (n < 0 || total_chunks < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t rc = cudaMemsetAsync(flags, 0, (size_t)n + 1, s);
  if (rc != cudaSuccess) return (int)rc;
  if (total_chunks > 0)
    finite_kernel<<<grid_for(total_chunks), kThreads, 0, s>>>(
        static_cast<const long long*>(table), n, total_chunks,
        static_cast<unsigned char*>(flags));
  return (int)cudaGetLastError();
}

// table: n rows of 4 int64 on the device, [source pointer, destination
// pointer, bytes, first chunk]; gate: null (always copy) or one byte on
// the device (copy only when it is non-zero). Returns a cudaError_t.
extern "C" int ptt_guarded_copy(const void* table, int n,
                                long long total_chunks, const void* gate,
                                void* stream) {
  if (n < 0 || total_chunks < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (total_chunks > 0)
    copy_kernel<<<grid_for(total_chunks), kThreads, 0, s>>>(
        static_cast<const long long*>(table), n, total_chunks,
        static_cast<const unsigned char*>(gate));
  return (int)cudaGetLastError();
}
