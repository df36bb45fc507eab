// LayerNorm backward for Hopper (sm_90a), plain C interface: one entry that
// launches the row pass and the column sum.
//
// Replaces paddle_tpu/ops/pallas/layer_norm.py:_ln_bwd (kernel body
// _ln_bwd_kernel): with x_hat = (x - mean) * rstd and gs = g * scale,
//   dx     = rstd * (gs - mean(gs) - x_hat * mean(gs * x_hat))   per row,
//   dscale = sum over rows of g * x_hat,  dbias = sum over rows of g,
// row sums and column sums in f32, from the forward's per-row f32 mean and
// rstd. dx is written in x's dtype, dscale/dbias in f32.
//
// What bounds it on the H100: ~12 flops per element against reading x and
// g and writing dx (12 bytes per f32 element, 6 bf16), so the bytes bound
// it: at (8192, 768) f32 ~76 MB, 22.6 us at 3.35 TB/s.
//
// Design. The TPU kernel carries dscale/dbias in VMEM scratch across its
// sequential row grid; CUDA blocks run in no order, and atomics would make
// the sums depend on the order of arrival. So:
// - Row pass, the forward's tiers and persistent grid (layer_norm_fwd.cu,
//   layer_norm.cuh): a warp (or a block, for rows above 1024 columns)
//   reads its row's x and g once, 16 bytes at a time, into registers,
//   takes the two row sums by xor shuffles and writes dx from the
//   registers. Each thread keeps f32 accumulators of g * x_hat and g for
//   its own columns across every row its team walks, so no shared memory
//   or barrier is touched per row (the block tier's one barrier per row
//   joins its warps' sums). The warp tier issues the next row's loads
//   before the current row's arithmetic. At the end each warp stores its
//   accumulators to shared memory at once and every thread adds its
//   columns over the warps in warp order (one barrier, no bank
//   conflicts); the block writes one
//   partial row: (2, grid, cols) f32, ~0.8 MB at the main paths' shape.
// - Column sum: blocks of 32 columns x 32 slices; slice i sums partial
//   rows i, i + 32, ... in order (4-5 loads at 132 partial rows), then the
//   slices meet in a fixed pairwise tree. It is launched as a programmatic
//   dependent of the row pass, so its launch overlaps the row pass's tail.
// Every sum has a fixed order, so two runs give equal bits.
#include <cstdint>

#include "layer_norm.cuh"

namespace {

using namespace ptt_ln;

constexpr int kColTile = 32;     // column sum: columns a block
constexpr int kColSlices = 32;   // column sum: threads a column

// Lets the dependent launch (the column sum) be scheduled: the row pass's
// rows are done, only its partial row is left to write.
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

// A row's x and g as a team member (t of team) holds them: raw packs.
template <typename T, int V, int K>
struct RowIn {
  Pack<T, V> x[K], g[K];

  __device__ __forceinline__ void load(const T* __restrict__ xr,
                                       const T* __restrict__ gr, int t,
                                       int team, int cols) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int c = (j * team + t) * V;
      if (c < cols) {
        x[j] = load_pack<T, V>(xr + c);
        g[j] = load_pack<T, V>(gr + c);
      }
    }
  }
};

// One row's arithmetic for a team member: `add` adds g * x_hat and g into
// the column accumulators and returns its shares of sum(gs) and
// sum(gs * x_hat); `finish` writes dx once the team's sums are known.
template <typename T, int V, int K>
struct Row {
  float xh[K][V], gs[K][V];

  __device__ __forceinline__ void add(const RowIn<T, V, K>& in,
                                      const float (&s)[K][V], float mu,
                                      float rs, int t, int team, int cols,
                                      float (&ds)[K][V], float (&db)[K][V],
                                      float& sg, float& sgx) {
    sg = sgx = 0.f;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const bool ok = (j * team + t) * V < cols;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float gv = ok ? to_f32(in.g[j].v[e]) : 0.f;
        xh[j][e] = ok ? (to_f32(in.x[j].v[e]) - mu) * rs : 0.f;
        gs[j][e] = gv * s[j][e];
        sg += gs[j][e];
        sgx += gs[j][e] * xh[j][e];
        ds[j][e] += gv * xh[j][e];
        db[j][e] += gv;
      }
    }
  }

  __device__ __forceinline__ void finish(T* __restrict__ dx, float rs,
                                         float mg, float mgx, int t, int team,
                                         int cols) const {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int c = (j * team + t) * V;
      if (c < cols) {
        Pack<T, V> o;
#pragma unroll
        for (int e = 0; e < V; ++e)
          o.v[e] = from_f32<T>(rs * (gs[j][e] - mg - xh[j][e] * mgx));
        store_pack<T, V>(dx + c, o);
      }
    }
  }
};

// A warp-tier block's partial row of one column sum: every warp stores its
// accumulators to shared memory at once, then each thread adds its columns
// over the warps in warp order.
template <int V, int K>
__device__ __forceinline__ void block_partial(
    const float (&v)[K][V], float (*acc)[32 * kMaxPerLane],
    float* __restrict__ out, int lane, int w, int cols) {
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int c = (j * 32 + lane) * V;
    if (c < cols) {
      if constexpr (V % 4 == 0) {
#pragma unroll
        for (int e = 0; e < V; e += 4)
          *reinterpret_cast<float4*>(&acc[w][c + e]) =
              make_float4(v[j][e], v[j][e + 1], v[j][e + 2], v[j][e + 3]);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) acc[w][c + e] = v[j][e];
      }
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < cols; c += kRowThreads) {
    float t = acc[0][c];
#pragma unroll
    for (int i = 1; i < kRowWarps; ++i) t += acc[i][c];
    out[c] = t;
  }
  __syncthreads();                 // acc is free for the next call
}

// One block an SM: a lane holds the next row's packs, this row's x_hat
// and gs, scale and the two column accumulators of its columns.
template <typename T, int V, int K>
__global__ void __launch_bounds__(kRowThreads, 1)
ln_bwd_warp_kernel(const T* __restrict__ x, const T* __restrict__ g,
                   const float* __restrict__ scale,
                   const float* __restrict__ mean,
                   const float* __restrict__ rstd, T* __restrict__ dx,
                   float* __restrict__ part, int rows, int cols) {
  __shared__ __align__(16) float acc[kRowWarps][32 * kMaxPerLane];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int warps = gridDim.x * kRowWarps;
  float s[K][V], ds[K][V], db[K][V];
  load_vec<V, K>(scale, lane, 32, cols, 1.f, s);
#pragma unroll
  for (int j = 0; j < K; ++j)
#pragma unroll
    for (int e = 0; e < V; ++e) ds[j][e] = db[j][e] = 0.f;
  const float n = (float)cols;
  int row = blockIdx.x * kRowWarps + w;
  RowIn<T, V, K> cur, nxt;
  if (row < rows)
    cur.load(x + (size_t)row * cols, g + (size_t)row * cols, lane, 32, cols);
  for (; row < rows; row += warps) {
    const size_t base = (size_t)row * cols;
    const size_t next = base + (size_t)warps * cols;
    const float mu = mean[row], rs = rstd[row];
    if (row + warps < rows)                    // the next row, in flight
      nxt.load(x + next, g + next, lane, 32, cols);
    Row<T, V, K> r;
    float sg, sgx;
    r.add(cur, s, mu, rs, lane, 32, cols, ds, db, sg, sgx);
    const float mg = warp_sum(sg) / n, mgx = warp_sum(sgx) / n;
    r.finish(dx + base, rs, mg, mgx, lane, 32, cols);
    cur = nxt;
  }
  launch_dependents();
  // the block's partial rows of dscale, then dbias
  block_partial<V, K>(ds, acc, part + (size_t)blockIdx.x * cols, lane, w,
                      cols);
  block_partial<V, K>(db, acc,
                      part + ((size_t)gridDim.x + blockIdx.x) * cols, lane,
                      w, cols);
}

template <typename T, int V, int K, int W>
__global__ void __launch_bounds__(32 * W, 1)
ln_bwd_block_kernel(const T* __restrict__ x, const T* __restrict__ g,
                    const float* __restrict__ scale,
                    const float* __restrict__ mean,
                    const float* __restrict__ rstd, T* __restrict__ dx,
                    float* __restrict__ part, int rows, int cols) {
  __shared__ float red[2][2][W];               // [buffer][sum][warp]
  const int t = threadIdx.x, team = 32 * W;
  float s[K][V], ds[K][V], db[K][V];
  load_vec<V, K>(scale, t, team, cols, 1.f, s);
#pragma unroll
  for (int j = 0; j < K; ++j)
#pragma unroll
    for (int e = 0; e < V; ++e) ds[j][e] = db[j][e] = 0.f;
  const float n = (float)cols;
  int buf = 0;
  for (int row = blockIdx.x; row < rows; row += gridDim.x, buf ^= 1) {
    const size_t base = (size_t)row * cols;
    const float mu = mean[row], rs = rstd[row];
    RowIn<T, V, K> in;
    in.load(x + base, g + base, t, team, cols);
    Row<T, V, K> r;
    float sg, sgx;
    r.add(in, s, mu, rs, t, team, cols, ds, db, sg, sgx);
    // the warps' sums in warp order; the two buffers alternate by row, so
    // one barrier a row suffices
    sg = warp_sum(sg);
    sgx = warp_sum(sgx);
    if ((t & 31) == 0) {
      red[buf][0][t >> 5] = sg;
      red[buf][1][t >> 5] = sgx;
    }
    __syncthreads();
    sg = sgx = 0.f;
#pragma unroll
    for (int i = 0; i < W; ++i) {
      sg += red[buf][0][i];
      sgx += red[buf][1][i];
    }
    r.finish(dx + base, rs, sg / n, sgx / n, t, team, cols);
  }
  launch_dependents();
  // a thread owns its columns: its accumulators are the block's partials
  float* ds_part = part + (size_t)blockIdx.x * cols;
  float* db_part = part + ((size_t)gridDim.x + blockIdx.x) * cols;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int c = (j * team + t) * V;
    if (c < cols) {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        ds_part[c + e] = ds[j][e];
        db_part[c + e] = db[j][e];
      }
    }
  }
}

// dscale/dbias = column sums of the (2, parts, cols) partials: slice i of
// a column sums partial rows i, i + kColSlices, ... in order, then the
// slices meet in a fixed pairwise tree (i += i + h for h = 16, 8, ..., 1).
__global__ void __launch_bounds__(kColTile * kColSlices)
ln_bwd_colsum_kernel(const float* __restrict__ part,
                     float* __restrict__ dscale, float* __restrict__ dbias,
                     int parts, int cols) {
  __shared__ float red[2][kColSlices][kColTile];
  const int tx = threadIdx.x % kColTile, sl = threadIdx.x / kColTile;
  const int c = blockIdx.x * kColTile + tx;
  // launched early (programmatic dependent launch): wait here until the
  // row pass has finished and its partials are visible
  asm volatile("griddepcontrol.wait;" ::: "memory");
  float s = 0.f, b = 0.f;
  if (c < cols) {
    const float* ds_part = part + c;
    const float* db_part = part + (size_t)parts * cols + c;
#pragma unroll 4
    for (int p = sl; p < parts; p += kColSlices) {
      s += ds_part[(size_t)p * cols];
      b += db_part[(size_t)p * cols];
    }
  }
  red[0][sl][tx] = s;
  red[1][sl][tx] = b;
  for (int h = kColSlices / 2; h > 0; h >>= 1) {
    __syncthreads();
    if (sl < h) {
      red[0][sl][tx] += red[0][sl + h][tx];
      red[1][sl][tx] += red[1][sl + h][tx];
    }
  }
  if (sl == 0 && c < cols) {
    dscale[c] = red[0][0][tx];
    dbias[c] = red[1][0][tx];
  }
}

struct Args {
  const void *x, *g, *scale, *mean, *rstd;
  void *dx, *part, *dscale, *dbias;
  int rows, cols, team_warps, grid;
  cudaStream_t stream;
};

template <typename T, int V, int K>
cudaError_t launch(const Args& a) {
  if constexpr (K * V > kMaxPerLane) {
    return cudaErrorInvalidValue;
  } else {
    const T* x = static_cast<const T*>(a.x);
    const T* g = static_cast<const T*>(a.g);
    const float* s = static_cast<const float*>(a.scale);
    const float* mean = static_cast<const float*>(a.mean);
    const float* rstd = static_cast<const float*>(a.rstd);
    T* dx = static_cast<T*>(a.dx);
    float* part = static_cast<float*>(a.part);
    if (a.team_warps == 1) {
      ln_bwd_warp_kernel<T, V, K><<<a.grid, kRowThreads, 0, a.stream>>>(
          x, g, s, mean, rstd, dx, part, a.rows, a.cols);
    } else if constexpr (2 * K * V > kMaxPerLane) {
      // as the forward: the block tier holds more than half of kMaxPerLane
      const cudaError_t err = with_team(a.team_warps, [&](auto w) {
        ln_bwd_block_kernel<T, V, K, decltype(w)::value>
            <<<a.grid, 32 * decltype(w)::value, 0, a.stream>>>(
                x, g, s, mean, rstd, dx, part, a.rows, a.cols);
        return cudaGetLastError();
      });
      if (err != cudaSuccess) return err;
    } else {
      return cudaErrorInvalidValue;
    }
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    // the column sum may be scheduled while the row pass drains (it waits
    // for it in griddepcontrol.wait): no launch gap between the two
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((a.cols + kColTile - 1) / kColTile);
    cfg.blockDim = dim3(kColTile * kColSlices);
    cfg.stream = a.stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cudaLaunchKernelEx(&cfg, ln_bwd_colsum_kernel,
                              static_cast<const float*>(part),
                              static_cast<float*>(a.dscale),
                              static_cast<float*>(a.dbias), a.grid, a.cols);
  }
}

template <typename T, int V>
cudaError_t launch_k(int k, const Args& a) {
  switch (k) {
#define PTT_LN_CASE(K) \
  case K:              \
    return launch<T, V, K>(a);
    PTT_LN_FOR_EACH_K(PTT_LN_CASE)
#undef PTT_LN_CASE
  }
  return cudaErrorInvalidValue;
}

bool aligned16(const void* p) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, g, dx). scale: float32 (cols,) or
// null (ones). mean/rstd: float32 (rows,). part: float32 (2, grid, cols)
// scratch. dscale/dbias: float32 (cols,). vec, k, team_warps, grid: the
// plan, as ptt_layer_norm_fwd's. Returns a cudaError_t.
extern "C" int ptt_layer_norm_bwd(const void* x, const void* g,
                                  const void* scale, const void* mean,
                                  const void* rstd, void* dx, void* part,
                                  void* dscale, void* dbias, int rows,
                                  int cols, int dtype, int vec, int k,
                                  int team_warps, int grid, void* stream) {
  if (cols < 1 || cols > kMaxCols || rows < 1 || grid < 1 || k < 1 ||
      team_warps < 1 || team_warps > kMaxTeam / 32 ||
      (long long)k * vec * 32 * team_warps < cols)
    return (int)cudaErrorInvalidValue;
  if (vec > 1 && (cols % vec || !aligned16(x) || !aligned16(g) ||
                  !aligned16(dx) || !aligned16(scale)))
    return (int)cudaErrorMisalignedAddress;
  const Args a{x, g, scale, mean, rstd, dx, part, dscale, dbias, rows, cols,
               team_warps, grid, static_cast<cudaStream_t>(stream)};
  if (dtype == 0 && vec == 4) return launch_k<float, 4>(k, a);
  if (dtype == 0 && vec == 1) return launch_k<float, 1>(k, a);
  if (dtype == 1 && vec == 8) return launch_k<__nv_bfloat16, 8>(k, a);
  if (dtype == 1 && vec == 1) return launch_k<__nv_bfloat16, 1>(k, a);
  return (int)cudaErrorInvalidValue;
}
