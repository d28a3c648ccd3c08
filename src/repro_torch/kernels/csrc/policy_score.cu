// CoRaiS policy head (paper eqs 16-17) on Hopper (sm_90a), f32 on the CUDA
// cores. Built by repro_torch/kernels/policy_score.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through the plain C interface at the end of this file.
//
// What it replaces (JAX reference, src/repro/kernels/policy_score.py):
//   corais_policy_score         <- _fwd_kernel    (:51), the materialized
//                                  (Z, Q) log-prob head ("B1")
//   corais_policy_score_decode  <- _decode_kernel (:180), the fused score +
//                                  greedy/top-k decode ("B3")
//   corais_policy_score_bwd     <- _bwd_kernel    (:65), B1's custom-VJP
//                                  backward ("B2"; its note follows B1's)
//
// What bounds it. At the serving shape (B=1, Q=100, Z=1000, d=256) B1 does
// about 195 MFLOP (px 13 + py 131 + u 51) on about 2 MB of inputs and
// outputs, and B3 about 77 MFLOP on about 1.7 MB: both have more than 20
// FLOP per byte, so in f32 on the CUDA cores (no TF32: parity needs 1e-5)
// they are bounded by operations, a few microseconds each, which is near
// the cost of a launch.
//
// What the design does about it. On the TPU each Z-block of the Pallas grid
// recomputes the edge-side projection, which is free there because the grid
// runs in order on one core. Here the Z-blocks run in parallel on 132 SMs,
// so recomputing it per block would multiply the work about five times.
// Each function is therefore two launches on one stream:
//   1. edge_prologue, one block per (edge q, instance b): the edge-side
//      projection, computed once, into a scratch buffer the wrapper owns:
//        B1: pxT[b] = (c[b] @ Wpx)^T           (d, Q)
//        B3: pxy[b] = Wpy @ (c[b] @ Wpx)^T     (d, Q)  (the reference's fold)
//   2. a Z-tiled main kernel over a (ceil(Z/16), B) grid, 16 request rows per
//      block, 8 warps, two rows per warp and up to four edges per lane
//      (Q <= 128). The (d, Q) edge matrix is staged through shared memory in
//      32-deep chunks, shared by the block's 8 warps.
//        B1: py tile = h tile @ Wpy, u = py . pxT * scale, C*tanh, the mask
//            (-1e9), the row log-sum-exp, and a store of the (16, Q) tile.
//        B3: u = h tile @ pxy * scale, then per row K passes of a warp
//            arg-max (lowest index on ties); only (16, K) indices and values
//            are stored, never the (Z, Q) scores.
// Every product is a plain FMA loop written here; no library GEMM and no
// tensor cores. Making these fast (mma.sync / wgmma on 3xTF32, a fused
// prologue) is later work.
//
// corais_policy_score_bwd <- _bwd_kernel (:65), the custom-VJP backward of
// B1 ("B2"): given the cotangent g and the saved log-probs out, both
// (B, Z, Q), it returns dc (B, Q, d), dh (B, Z, d) and dWpx, dWpy (d, d)
// summed over B. At the training shape (B=128, Q=5, Z=50, d=256) that is
// about 2.8 GFLOP (the projections px, py recomputed, u recomputed, and six
// products) on about 15 MB, so it too is bounded by operations.
// The reference gives one program a whole (Z, d) block of one instance,
// which fits VMEM only to a few thousand rows and leaves one program per
// instance. Here it is five stages on one stream (seven launches: stages
// 4 and 5 run once per weight), every sum in a fixed order and no float
// atomics, so two runs give the same bits:
//   1. edge_prologue<false>: pxT[b] = (c[b] @ Wpx)^T, as in B1;
//   2. bwd_rows over (ceil(Z/16), B): per 16-row tile, py = h @ Wpy and u
//      recomputed, gu = keep ? (g - exp(out) * sum_q g) * C * scale *
//      (1 - tanh(u)^2) : 0, dpy = gu @ px and dh = dpy @ Wpy^T; gu, py and
//      dpy go to wrapper-owned scratch. Rows past Z are masked, not padded;
//   3. bwd_edges over (Q, B): dpx[b, q] = sum_z gu[b, z, q] py[b, z] in z
//      order, then dc[b, q] = dpx[b, q] @ Wpx^T (a warp per output);
//   4. weight_grad_partial: dWpx = sum over the B*Q rows of c^T dpx and
//      dWpy over the B*Z rows of h^T dpy, each split over rows into
//      `split` partial (d, d) sums, one 16x256 output tile per block;
//   5. sum_partials adds the partials in order p = 0, 1, ...
// Limits as B1: Q <= 128, d <= 512, any Z.

#include <cuda_runtime.h>
#include <climits>
#include <cmath>

namespace {

constexpr int kThreads = 256;                    // 8 warps per block
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;                        // request rows per block
constexpr int kRowsPerWarp = kRows / kWarps;     // 2
constexpr int kQMax = 128;                       // edges per instance
constexpr int kQPerLane = kQMax / 32;            // 4
constexpr int kChunk = 32;                       // depth of one staged tile

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Edge-side prologue, one block per (q, b). px = c[b, q] @ Wpx in shared
// memory, then FOLD=false stores pxT[b, :, q] = px and FOLD=true stores
// pxy[b, :, q] = Wpy @ px (one warp per output row, lanes along k so that
// the Wpy row is read coalesced).
template <bool FOLD>
__global__ void __launch_bounds__(kThreads)
edge_prologue(const float* __restrict__ c, const float* __restrict__ wpx,
              const float* __restrict__ wpy, float* __restrict__ out,
              int Q, int d) {
  extern __shared__ float smem[];
  float* c_s = smem;        // d
  float* px_s = smem + d;   // d
  const int q = blockIdx.x, b = blockIdx.y;
  const float* c_row = c + ((size_t)b * Q + q) * d;
  for (int k = threadIdx.x; k < d; k += blockDim.x) c_s[k] = c_row[k];
  __syncthreads();
  for (int j = threadIdx.x; j < d; j += blockDim.x) {
    float acc = 0.f;
    for (int k = 0; k < d; ++k) acc = fmaf(c_s[k], wpx[(size_t)k * d + j], acc);
    px_s[j] = acc;
  }
  __syncthreads();
  float* out_b = out + (size_t)b * d * Q;
  if constexpr (!FOLD) {
    for (int j = threadIdx.x; j < d; j += blockDim.x)
      out_b[(size_t)j * Q + q] = px_s[j];
  } else {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int i = warp; i < d; i += kWarps) {
      const float* w_row = wpy + (size_t)i * d;
      float acc = 0.f;
      for (int k = lane; k < d; k += 32) acc = fmaf(w_row[k], px_s[k], acc);
      acc = warp_sum(acc);
      if (lane == 0) out_b[(size_t)i * Q + q] = acc;
    }
  }
}

// Copy `rows` rows of a (., d) matrix into shared memory, zero-filling the
// tile up to kRows rows.
__device__ __forceinline__ void load_rows(const float* __restrict__ src,
                                          int rows, int d, float* dst) {
  for (int i = threadIdx.x; i < kRows * d; i += blockDim.x)
    dst[i] = (i / d) < rows ? src[i] : 0.f;
}

// acc[rr][i] = sum_k a_s[row, k] * m[k, q] for the warp's two rows
// (row = warp * 2 + rr) and the lane's edges (q = lane + 32 i). `m` is the
// (d, Q) edge matrix in device memory; it is staged through m_s in
// kChunk-deep tiles that all warps of the block share.
__device__ __forceinline__ void rows_times_edges(
    const float* a_s, const float* __restrict__ m, float* m_s, int d, int Q,
    float acc[kRowsPerWarp][kQPerLane]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr)
#pragma unroll
    for (int i = 0; i < kQPerLane; ++i) acc[rr][i] = 0.f;
  for (int k0 = 0; k0 < d; k0 += kChunk) {
    const int kc = min(kChunk, d - k0);
    for (int t = threadIdx.x; t < kChunk * kQMax; t += blockDim.x) {
      const int kk = t / kQMax, q = t % kQMax;
      m_s[t] = (kk < kc && q < Q) ? m[(size_t)(k0 + kk) * Q + q] : 0.f;
    }
    __syncthreads();
    for (int kk = 0; kk < kc; ++kk) {
      float mv[kQPerLane];
#pragma unroll
      for (int i = 0; i < kQPerLane; ++i) mv[i] = m_s[kk * kQMax + lane + 32 * i];
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr) {
        const float a = a_s[(warp * kRowsPerWarp + rr) * d + k0 + kk];
#pragma unroll
        for (int i = 0; i < kQPerLane; ++i) acc[rr][i] = fmaf(a, mv[i], acc[rr][i]);
      }
    }
    __syncthreads();
  }
}

// B1 main kernel: (16, Q) log-prob tile per block.
__global__ void __launch_bounds__(kThreads)
score_rows(const float* __restrict__ h, const float* __restrict__ wpy,
           const float* __restrict__ pxT, const float* __restrict__ mask,
           float* __restrict__ out, int Z, int Q, int d, float scale,
           float clip) {
  extern __shared__ float smem[];
  float* h_s = smem;                 // kRows * d
  float* py_s = h_s + kRows * d;     // kRows * d
  float* m_s = py_s + kRows * d;     // kChunk * kQMax
  const int b = blockIdx.y, z0 = blockIdx.x * kRows;
  const int rows = min(kRows, Z - z0);
  load_rows(h + ((size_t)b * Z + z0) * d, rows, d, h_s);
  __syncthreads();
  // py = h tile @ Wpy: thread j owns column j of all kRows rows, so each
  // Wpy element is read once per block (coalesced) and used kRows times.
  for (int j = threadIdx.x; j < d; j += blockDim.x) {
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
    for (int k = 0; k < d; ++k) {
      const float w = wpy[(size_t)k * d + j];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = fmaf(h_s[r * d + k], w, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) py_s[r * d + j] = acc[r];
  }
  __syncthreads();
  float acc[kRowsPerWarp][kQPerLane];
  rows_times_edges(py_s, pxT + (size_t)b * d * Q, m_s, d, Q, acc);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* mask_b = mask + (size_t)b * Q;
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int r = warp * kRowsPerWarp + rr;
    if (r >= rows) break;  // warp-uniform
    float v[kQPerLane];
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < kQPerLane; ++i) {
      const int q = lane + 32 * i;
      v[i] = -INFINITY;
      if (q < Q) {
        v[i] = mask_b[q] > 0.5f ? clip * tanhf(acc[rr][i] * scale) : -1e9f;
        mx = fmaxf(mx, v[i]);
      }
    }
    mx = warp_max(mx);
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kQPerLane; ++i)
      if (lane + 32 * i < Q) s += expf(v[i] - mx);
    const float lse = logf(warp_sum(s)) + mx;
    float* out_row = out + ((size_t)b * Z + z0 + r) * Q;
#pragma unroll
    for (int i = 0; i < kQPerLane; ++i) {
      const int q = lane + 32 * i;
      if (q < Q) out_row[q] = v[i] - lse;
    }
  }
}

// B3 main kernel: per request row, the top-K edges and their values.
__global__ void __launch_bounds__(kThreads)
decode_rows(const float* __restrict__ h, const float* __restrict__ pxy,
            const float* __restrict__ mask, int* __restrict__ top_idx,
            float* __restrict__ top_val, int Z, int Q, int d, int K,
            int normalize, float scale, float clip) {
  extern __shared__ float smem[];
  float* h_s = smem;                 // kRows * d
  float* m_s = h_s + kRows * d;      // kChunk * kQMax
  const int b = blockIdx.y, z0 = blockIdx.x * kRows;
  const int rows = min(kRows, Z - z0);
  load_rows(h + ((size_t)b * Z + z0) * d, rows, d, h_s);
  __syncthreads();
  float acc[kRowsPerWarp][kQPerLane];
  rows_times_edges(h_s, pxy + (size_t)b * d * Q, m_s, d, Q, acc);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* mask_b = mask + (size_t)b * Q;
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int r = warp * kRowsPerWarp + rr;
    if (r >= rows) break;  // warp-uniform
    // normalize: select on C*tanh(u), masked -1e9 (eq-17 log-probs out);
    // otherwise select in u-space, masked -inf, C*tanh on the winners only.
    float sel[kQPerLane];
    bool live[kQPerLane];
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < kQPerLane; ++i) {
      const int q = lane + 32 * i;
      live[i] = q < Q;
      sel[i] = -INFINITY;
      if (live[i]) {
        const float u = acc[rr][i] * scale;
        const bool keep = mask_b[q] > 0.5f;
        sel[i] = normalize ? (keep ? clip * tanhf(u) : -1e9f)
                           : (keep ? u : -INFINITY);
        mx = fmaxf(mx, sel[i]);
      }
    }
    float lse = 0.f;
    if (normalize) {
      mx = warp_max(mx);
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < kQPerLane; ++i)
        if (live[i]) s += expf(sel[i] - mx);
      lse = logf(warp_sum(s)) + mx;
    }
    const size_t row = (size_t)b * Z + z0 + r;
    for (int j = 0; j < K; ++j) {
      // lane-local best among the edges not yet taken, then a butterfly
      // arg-max over the warp; (value desc, index asc) is a total order,
      // so every lane ends with the same winner.
      float bv = -INFINITY;
      int bi = INT_MAX;
#pragma unroll
      for (int i = 0; i < kQPerLane; ++i) {
        const int q = lane + 32 * i;
        if (live[i] && (sel[i] > bv || (sel[i] == bv && q < bi))) {
          bv = sel[i];
          bi = q;
        }
      }
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
        if (ov > bv || (ov == bv && oi < bi)) {
          bv = ov;
          bi = oi;
        }
      }
#pragma unroll
      for (int i = 0; i < kQPerLane; ++i)
        if (lane + 32 * i == bi) live[i] = false;
      if (lane == 0) {
        top_idx[row * K + j] = bi;
        top_val[row * K + j] = normalize ? bv - lse : clip * tanhf(bv);
      }
    }
  }
}

// B2 main pass: one block per 16 request rows of one instance (see the
// header for what it computes and writes).
__global__ void __launch_bounds__(kThreads)
bwd_rows(const float* __restrict__ g, const float* __restrict__ out,
         const float* __restrict__ h, const float* __restrict__ wpy,
         const float* __restrict__ pxT, const float* __restrict__ mask,
         float* __restrict__ py, float* __restrict__ gu,
         float* __restrict__ dpy, float* __restrict__ dh, int Z, int Q, int d,
         float scale, float clip) {
  extern __shared__ float smem[];
  float* a_s = smem;                     // kRows * d: h tile, then dpy tile
  float* py_s = a_s + kRows * d;         // kRows * d
  float* m_s = py_s + kRows * d;         // kChunk * kQMax
  float* gu_s = m_s + kChunk * kQMax;    // kRows * kQMax
  const int b = blockIdx.y, z0 = blockIdx.x * kRows;
  const int rows = min(kRows, Z - z0);
  const size_t row0 = (size_t)b * Z + z0;
  load_rows(h + row0 * d, rows, d, a_s);
  __syncthreads();
  // py = h tile @ Wpy, thread j owning column j of every row (as in B1)
  for (int j = threadIdx.x; j < d; j += blockDim.x) {
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
    for (int k = 0; k < d; ++k) {
      const float w = wpy[(size_t)k * d + j];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = fmaf(a_s[r * d + k], w, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      py_s[r * d + j] = acc[r];
      if (r < rows) py[(row0 + r) * d + j] = acc[r];
    }
  }
  __syncthreads();
  float acc[kRowsPerWarp][kQPerLane];
  rows_times_edges(py_s, pxT + (size_t)b * d * Q, m_s, d, Q, acc);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* mask_b = mask + (size_t)b * Q;
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int r = warp * kRowsPerWarp + rr;
    float gv[kQPerLane], ov[kQPerLane];
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kQPerLane; ++i) {
      const int q = lane + 32 * i;
      const bool live = r < rows && q < Q;
      gv[i] = live ? g[(row0 + r) * Q + q] : 0.f;
      ov[i] = live ? out[(row0 + r) * Q + q] : 0.f;
      s += gv[i];
    }
    s = warp_sum(s);
#pragma unroll
    for (int i = 0; i < kQPerLane; ++i) {
      const int q = lane + 32 * i;
      float v = 0.f;  // masked edges, padding lanes and rows past Z
      if (r < rows && q < Q && mask_b[q] > 0.5f) {
        const float th = tanhf(acc[rr][i] * scale);
        const float gi = gv[i] - expf(ov[i]) * s;
        v = gi * (clip * scale) * (1.f - th * th);
      }
      gu_s[r * kQMax + q] = v;
      if (r < rows && q < Q) gu[(row0 + r) * Q + q] = v;
    }
  }
  __syncthreads();
  // dpy = gu tile @ px, with px[q, j] = pxT[j, q]
  const float* pxT_b = pxT + (size_t)b * d * Q;
  for (int j = threadIdx.x; j < d; j += blockDim.x) {
    float acc2[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc2[r] = 0.f;
    for (int q = 0; q < Q; ++q) {
      const float p = pxT_b[(size_t)j * Q + q];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        acc2[r] = fmaf(gu_s[r * kQMax + q], p, acc2[r]);
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      a_s[r * d + j] = acc2[r];
      if (r < rows) dpy[(row0 + r) * d + j] = acc2[r];
    }
  }
  __syncthreads();
  // dh = dpy tile @ Wpy^T
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    const float* w_row = wpy + (size_t)i * d;
    float acc2[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc2[r] = 0.f;
    for (int j = 0; j < d; ++j) {
      const float w = w_row[j];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc2[r] = fmaf(a_s[r * d + j], w, acc2[r]);
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (r < rows) dh[(row0 + r) * d + i] = acc2[r];
  }
}

// B2: dpx[b, q] = sum_z gu[b, z, q] py[b, z] in z order, then
// dc[b, q] = dpx[b, q] @ Wpx^T; one block per (q, b).
__global__ void __launch_bounds__(kThreads)
bwd_edges(const float* __restrict__ gu, const float* __restrict__ py,
          const float* __restrict__ wpx, float* __restrict__ dpx,
          float* __restrict__ dc, int Z, int Q, int d) {
  extern __shared__ float smem[];
  float* dpx_s = smem;  // d
  const int q = blockIdx.x, b = blockIdx.y;
  const float* gu_b = gu + (size_t)b * Z * Q + q;
  const float* py_b = py + (size_t)b * Z * d;
  const size_t row = (size_t)b * Q + q;
  for (int j = threadIdx.x; j < d; j += blockDim.x) {
    float acc = 0.f;
    for (int z = 0; z < Z; ++z)
      acc = fmaf(gu_b[(size_t)z * Q], py_b[(size_t)z * d + j], acc);
    dpx_s[j] = acc;
    dpx[row * d + j] = acc;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = warp; i < d; i += kWarps) {
    const float* w_row = wpx + (size_t)i * d;
    float acc = 0.f;
    for (int k = lane; k < d; k += 32) acc = fmaf(w_row[k], dpx_s[k], acc);
    acc = warp_sum(acc);
    if (lane == 0) dc[row * d + i] = acc;
  }
}

constexpr int kWRows = 16;    // output rows (k) of a weight-gradient tile
constexpr int kNChunk = 64;   // input rows staged per step

// B2 weight gradient, partial p = blockIdx.z:
//   partial[p, k, j] = sum_{n in chunk p} a[n, k] bm[n, j]
// over rows [p * per, (p + 1) * per) of the (N, d) inputs, in row order.
// A block owns 16 rows k and 256 columns j of the (d, d) output.
__global__ void __launch_bounds__(kThreads)
weight_grad_partial(const float* __restrict__ a, const float* __restrict__ bm,
                    float* __restrict__ partial, int N, int d, int per) {
  __shared__ float a_s[kNChunk * kWRows];
  const int k0 = blockIdx.x * kWRows;
  const int j = blockIdx.y * kThreads + threadIdx.x;
  const int p = blockIdx.z;
  const int n_begin = p * per, n_end = min(N, n_begin + per);
  float acc[kWRows];
#pragma unroll
  for (int r = 0; r < kWRows; ++r) acc[r] = 0.f;
  for (int n0 = n_begin; n0 < n_end; n0 += kNChunk) {
    const int nc = min(kNChunk, n_end - n0);
    for (int t = threadIdx.x; t < kNChunk * kWRows; t += blockDim.x) {
      const int nn = t / kWRows, r = t % kWRows;
      a_s[t] = (nn < nc && k0 + r < d) ? a[(size_t)(n0 + nn) * d + k0 + r] : 0.f;
    }
    __syncthreads();
    if (j < d) {
      for (int nn = 0; nn < nc; ++nn) {
        const float bv = bm[(size_t)(n0 + nn) * d + j];
#pragma unroll
        for (int r = 0; r < kWRows; ++r)
          acc[r] = fmaf(a_s[nn * kWRows + r], bv, acc[r]);
      }
    }
    __syncthreads();
  }
  if (j < d) {
#pragma unroll
    for (int r = 0; r < kWRows; ++r)
      if (k0 + r < d) partial[((size_t)p * d + k0 + r) * d + j] = acc[r];
  }
}

// out[i] = sum of the `split` partials at i, added in order p = 0, 1, ...
__global__ void __launch_bounds__(kThreads)
sum_partials(const float* __restrict__ partial, float* __restrict__ out,
             int split, size_t n) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int p = 0; p < split; ++p) s += partial[(size_t)p * n + i];
  out[i] = s;
}

// out (d, d) = a^T bm over N rows, through `split` partials.
cudaError_t weight_grad(const float* a, const float* bm, float* partial,
                        float* out, int N, int d, int split, cudaStream_t s) {
  const int per = (N + split - 1) / split;
  const dim3 grid((d + kWRows - 1) / kWRows, (d + kThreads - 1) / kThreads,
                  split);
  weight_grad_partial<<<grid, kThreads, 0, s>>>(a, bm, partial, N, d, per);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t n = (size_t)d * d;
  sum_partials<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      partial, out, split, n);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Every entry point returns the first CUDA error of its launches (0 when
// both were accepted). A refused launch never runs and a later synchronize
// does not report it, so each launch is checked here.

int corais_policy_score(const float* c, const float* h, const float* wpx,
                        const float* wpy, const float* mask, float* pxT,
                        float* out, int B, int Q, int Z, int d, float scale,
                        float clip, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  edge_prologue<false><<<dim3(Q, B), kThreads, 2 * d * sizeof(float), s>>>(
      c, wpx, nullptr, pxT, Q, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int smem = (2 * kRows * d + kChunk * kQMax) * sizeof(float);
  err = cudaFuncSetAttribute(score_rows,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  score_rows<<<dim3((Z + kRows - 1) / kRows, B), kThreads, smem, s>>>(
      h, wpy, pxT, mask, out, Z, Q, d, scale, clip);
  return cudaGetLastError();
}

int corais_policy_score_decode(const float* c, const float* h,
                               const float* wpx, const float* wpy,
                               const float* mask, float* pxy, int* top_idx,
                               float* top_val, int B, int Q, int Z, int d,
                               int K, int normalize, float scale, float clip,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  edge_prologue<true><<<dim3(Q, B), kThreads, 2 * d * sizeof(float), s>>>(
      c, wpx, wpy, pxy, Q, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int smem = (kRows * d + kChunk * kQMax) * sizeof(float);
  err = cudaFuncSetAttribute(decode_rows,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  decode_rows<<<dim3((Z + kRows - 1) / kRows, B), kThreads, smem, s>>>(
      h, pxy, mask, top_idx, top_val, Z, Q, d, K, normalize, scale, clip);
  return cudaGetLastError();
}

// B2. Scratch the wrapper owns: pxT (B, d, Q), py and dpy (B, Z, d),
// gu (B, Z, Q), dpx (B, Q, d) and partial (max(split_x, split_y), d, d).
// split_x / split_y: partial sums of dWpx (over B*Q rows) and dWpy (over
// B*Z rows); the one partial buffer serves both, in stream order.
int corais_policy_score_bwd(const float* g, const float* out, const float* c,
                            const float* h, const float* wpx,
                            const float* wpy, const float* mask, float* pxT,
                            float* py, float* gu, float* dpy, float* dpx,
                            float* partial, float* dc, float* dh,
                            float* dwpx, float* dwpy, int B, int Q, int Z,
                            int d, int split_x, int split_y, float scale,
                            float clip, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  edge_prologue<false><<<dim3(Q, B), kThreads, 2 * d * sizeof(float), s>>>(
      c, wpx, nullptr, pxT, Q, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int smem =
      (2 * kRows * d + kChunk * kQMax + kRows * kQMax) * sizeof(float);
  err = cudaFuncSetAttribute(bwd_rows,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  bwd_rows<<<dim3((Z + kRows - 1) / kRows, B), kThreads, smem, s>>>(
      g, out, h, wpy, pxT, mask, py, gu, dpy, dh, Z, Q, d, scale, clip);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_edges<<<dim3(Q, B), kThreads, d * sizeof(float), s>>>(gu, py, wpx, dpx,
                                                            dc, Z, Q, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = weight_grad(c, dpx, partial, dwpx, B * Q, d, split_x, s);
  if (err != cudaSuccess) return err;
  return weight_grad(h, dpy, partial, dwpy, B * Z, d, split_y, s);
}

const char* corais_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
